"""Category-level challenge benchmark: procedural ModelNet40/SHREC/RGB-D
analogues (kss_icp/challenge.py).

Registers each scenario's corpus with the production bench config
(auto-escalation on) and judges success by POSE error — transform_rmse
between recovered- and truth-aligned source — since partial overlap and
non-rigid deformation make 1-NN RMSE unrepresentative by construction.

Usage:
  python scripts/challenge_test.py                  # default platform (GPU)
  python scripts/challenge_test.py --platform cpu
  python scripts/challenge_test.py --scenario partial
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--platform", default=None, choices=[None, "cpu", "gpu"])
    ap.add_argument("--scenario", default=None,
                    choices=[None, "category", "partial", "deform",
                             "scale", "partial_hard"])
    ap.add_argument("--no-escalate", action="store_true")
    ap.add_argument("--json", default=None, metavar="FILE",
                    help="write the summary dict as JSON")
    args = ap.parse_args()

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    from kss_icp.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from bench import bench_config
    from kss_icp.challenge import challenge_corpus, transform_rmse
    from kss_icp.core.transforms import apply_similarity
    from kss_icp.parallel.batch import register_many

    cfg = bench_config()
    summary = {}
    for scenario, pairs, thr in challenge_corpus(include_hard=True):
        if args.scenario and scenario != args.scenario:
            continue
        t0 = time.perf_counter()
        res, metrics = register_many(
            [(s, t) for _, s, t, _ in pairs], cfg,
            escalate=not args.no_escalate)
        dt = time.perf_counter() - t0
        errs = []
        for i, (name, src, _tgt, gt) in enumerate(pairs):
            tr_i = jax.tree.map(lambda x: x[i], res.transform)
            rec = np.asarray(apply_similarity(
                tr_i, np.asarray(src, np.float32)))
            errs.append(transform_rmse(rec, src, gt))
        errs = np.asarray(errs)
        fails = [pairs[i][0] for i in np.nonzero(errs > thr)[0]]
        for i, (name, *_rest) in enumerate(pairs):
            flag = " FAIL" if errs[i] > thr else ""
            print(f"  {name:12s} pose_rmse={errs[i]:.5f} "
                  f"nn_rmse={metrics['rmse'][i]:.5f}{flag}")
        n = len(pairs)
        print(f"{scenario}: {n} pairs, failures(>{thr})={len(fails)} {fails}, "
              f"median pose_rmse={np.median(errs):.5f}, {dt:.1f}s incl. "
              f"compile\n")
        summary[scenario] = {
            "pairs": n, "threshold": thr, "failures": len(fails),
            "failed": fails,
            "success_rate": round(1 - len(fails) / n, 4),
            "median_pose_rmse": round(float(np.median(errs)), 6),
        }
    print(json.dumps(summary))
    if args.json:
        Path(args.json).write_text(json.dumps(summary, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Overlap-mode validation experiment (round 4, VERDICT item 1).

Runs the partial-overlap challenge tiers (keep=0.92 ~84% overlap,
keep=0.8 ~60% overlap) through three solvers on CPU and reports pose error
per pair:

  base      bench-config register_resampled (+ 16^3 escalation when flagged)
  overlap   register_overlap_resampled at the bench config's grid
  combined  the shipping ladder: base -> escalation -> overlap tier when the
            trimmed comparison prefers it

Usage: python scripts/overlap_experiment.py [--grid N] [keep ...]
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax

from kss_icp.utils.compile_cache import enable_compile_cache

jax.config.update("jax_platforms", "cpu")
enable_compile_cache()

import numpy as np
import jax.numpy as jnp


def main():
    args = sys.argv[1:]
    grid = 8
    iters = None
    trimq = None
    if "--grid" in args:
        i = args.index("--grid")
        grid = int(args[i + 1])
        del args[i : i + 2]
    if "--iters" in args:
        i = args.index("--iters")
        iters = int(args[i + 1])
        del args[i : i + 2]
    if "--trim" in args:
        i = args.index("--trim")
        trimq = float(args[i + 1])
        del args[i : i + 2]
    keeps = [float(a) for a in args] or [0.92, 0.8]

    from bench import bench_config
    from kss_icp.challenge import partial_corpus, transform_rmse
    from kss_icp.core.transforms import apply_similarity
    from kss_icp.models.kss_icp import (
        register_overlap_resampled,
        register_resampled,
        resample_pairs,
        trimmed_fitness,
    )

    cfg = bench_config()
    ecfg = cfg.escalation_config()
    base_o = cfg if grid == 8 else cfg.escalation_config()
    import dataclasses
    okw = {"rotation_steps": grid}
    if iters is not None:
        okw["overlap_iterations"] = iters
    base_ocfg = base_o
    if trimq is not None:
        base_ocfg = dataclasses.replace(base_o, overlap_trim_fraction=trimq)
    ocfg = dataclasses.replace(base_ocfg.overlap_config(), **okw)
    print(f"overlap grid: {grid}^3 iters={ocfg.overlap_iterations} "
          f"q={ocfg.overlap_trim_fraction}", file=sys.stderr)
    FULL = 8192

    def pad(pts):
        out = np.zeros((FULL, 3), np.float32)
        n = min(len(pts), FULL)
        out[:n] = pts[:n]
        m = np.zeros((FULL,), bool)
        m[:n] = True
        return out, m

    for keep in keeps:
        pairs = partial_corpus(keep=keep)
        print(f"=== keep={keep} ({len(pairs)} pairs) ===")
        header = (f"{'pair':14s} {'fit_b':>9s} {'fit_e':>9s} {'tfit_b':>9s} "
                  f"{'tfit_o':>9s} {'pose_b':>8s} {'pose_o':>8s} {'pose_c':>8s}")
        print(header)
        n_ok = {"b": 0, "o": 0, "c": 0}
        for name, src, tgt, gt in pairs:
            sp, sm = pad(src)
            tp, tm = pad(tgt)
            pn = np.int32(cfg.resample_count(int(sm.sum()), int(tm.sum())))
            (rs, rsm), (rt, rtm) = resample_pairs(
                sp[None], sm[None], tp[None], tm[None],
                jnp.asarray([pn]), cfg)
            a = (rs[0], rsm[0], rt[0], rtm[0])

            res_b = register_resampled(*a, cfg)
            fit_b = float(res_b.fitness)
            if fit_b > cfg.escalate_threshold:
                res_e = register_resampled(*a, ecfg)
                if float(res_e.fitness) < fit_b:
                    res_b = res_e
            fit_e = float(res_b.fitness)

            res_o = register_overlap_resampled(*a, ocfg)

            tf_b = float(trimmed_fitness(res_b.transform, *a,
                                         ocfg.overlap_trim_fraction))
            tf_o = float(trimmed_fitness(res_o.transform, *a,
                                         ocfg.overlap_trim_fraction))
            res_c = res_o if tf_o < tf_b else res_b

            def pose(res):
                al = np.asarray(apply_similarity(
                    res.transform, jnp.asarray(src, jnp.float32)))
                return transform_rmse(al, src, gt)

            pb, po, pc = pose(res_b), pose(res_o), pose(res_c)
            for k, v in (("b", pb), ("o", po), ("c", pc)):
                n_ok[k] += int(v <= 0.10)
            print(f"{name:14s} {fit_b:9.2e} {fit_e:9.2e} {tf_b:9.2e} "
                  f"{tf_o:9.2e} {pb:8.4f} {po:8.4f} {pc:8.4f}")
        print(f"success@0.10: base={n_ok['b']}/8 overlap={n_ok['o']}/8 "
              f"combined={n_ok['c']}/8\n")


if __name__ == "__main__":
    t0 = time.time()
    main()
    print(f"total {time.time() - t0:.1f}s", file=sys.stderr)

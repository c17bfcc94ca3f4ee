"""Adversarial robustness benchmark: compound-rotation synthetic pairs.

The bundled golden pairs (data/registration/transfer.txt) only use
single-axis rotations <= 1.56 rad; this harness stresses the full pipeline
with compound 3-axis rotations + anisotropic-free scale + translation, the
regime where the rotation-grid's local-minima list earns its keep
(initRegistrationKSS.hpp:276-289). Reports per-pair RMSE, failure count
(RMSE > threshold), and throughput for a chosen config.

Usage:
  python scripts/stress_test.py                 # tuned bench config
  python scripts/stress_test.py --full          # reference-full protocol
  python scripts/stress_test.py --steps 12      # escalated rotation grid
"""

from __future__ import annotations

import argparse
import sys
import time
from functools import partial
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

FULL_PAD = 8192


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--candidates", type=int, default=8)
    ap.add_argument("--coarse-points", type=int, default=512)
    ap.add_argument("--refine", type=int, default=2)
    ap.add_argument("--full", action="store_true",
                    help="reference-full multi-start protocol")
    ap.add_argument("--threshold", type=float, default=0.05)
    ap.add_argument("--platform", default=None, choices=[None, "cpu", "gpu"])
    args = ap.parse_args()

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    from kss_icp.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp

    from kss_icp.config import KSSICPConfig
    from kss_icp.core.transforms import apply_similarity
    from kss_icp.metrics import registration_measure_padded
    from kss_icp.models.kss_icp import register_resampled, resample_batch

    if args.full:
        cfg = KSSICPConfig(max_candidates=32, multistart_mode="full",
                           rotation_steps=args.steps)
    else:
        cfg = KSSICPConfig(
            max_candidates=args.candidates, coarse_points=args.coarse_points,
            refine_candidates=args.refine, rotation_steps=args.steps,
        )

    def pad(pts):
        out = np.zeros((FULL_PAD, 3), np.float32)
        n = min(len(pts), FULL_PAD)
        out[:n] = pts[:n]
        m = np.zeros((FULL_PAD,), bool)
        m[:n] = True
        return out, m

    from kss_icp.stress import stress_corpus

    srcs, tgts, names = [], [], []
    for name, s_pts, t_pts in stress_corpus():
        srcs.append(pad(s_pts))
        tgts.append(pad(t_pts))
        names.append(name)

    src = jnp.asarray(np.stack([x[0] for x in srcs]))
    sm = jnp.asarray(np.stack([x[1] for x in srcs]))
    tgt = jnp.asarray(np.stack([x[0] for x in tgts]))
    tm = jnp.asarray(np.stack([x[1] for x in tgts]))
    b = len(names)

    @partial(jax.jit, static_argnames=("cfg",))
    def pipeline(sp, sm_, tp, tm_, pn, cfg):
        rs, rsm = resample_batch(sp, sm_, pn, cfg)
        rt, rtm = resample_batch(tp, tm_, pn, cfg)

        def one(a, bb, c, d):
            r = register_resampled(a, bb, c, d, cfg)
            return r.transform, r.fitness

        return jax.vmap(one)(rs, rsm, rt, rtm)

    @jax.jit
    def measure_all(tr, sp, sm_, tp, tm_):
        def one(tri, spi, smi, tpi, tmi):
            return registration_measure_padded(
                apply_similarity(tri, spi), smi, tpi, tmi)["rmse"]
        return jax.vmap(one)(tr, sp, sm_, tp, tm_)

    pn = jnp.asarray([cfg.resample_count(int(a.sum()), int(bb.sum()))
                      for a, bb in zip(np.asarray(sm), np.asarray(tm))],
                     jnp.int32)
    t0 = time.perf_counter()
    out = pipeline(src, sm, tgt, tm, pn, cfg)
    np.asarray(out[1])
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = pipeline(src, sm, tgt, tm, pn, cfg)
    np.asarray(out[1])
    dt = time.perf_counter() - t0

    rmses = np.asarray(measure_all(out[0], src, sm, tgt, tm))
    order = np.argsort(rmses)[::-1]
    fails = [(names[i], float(rmses[i])) for i in order
             if rmses[i] > args.threshold]
    for i in order:
        flag = " FAIL" if rmses[i] > args.threshold else ""
        print(f"  {names[i]:16s} rmse={rmses[i]:.5f}{flag}")
    print(f"\n{b} pairs  {b/dt:.2f} pairs/s  median RMSE {np.median(rmses):.5f}"
          f"  failures(>{args.threshold}): {len(fails)}"
          f"  (compile {compile_s:.1f}s)")
    return 1 if len(fails) > b // 4 else 0


if __name__ == "__main__":
    sys.exit(main())

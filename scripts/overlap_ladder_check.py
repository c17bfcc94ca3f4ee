"""Validate the SHIPPING escalation ladder (pipeline -> 16^3 escalation ->
two overlap rungs, all inside register_many) on the partial challenge
tiers, judged by pose error. This is the integration check for the
round-4 overlap work; the per-variant science lives in
scripts/overlap_experiment.py.

Usage: python scripts/overlap_ladder_check.py [keep ...]
       python scripts/overlap_ladder_check.py --category   # category corpus
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
    args = list(sys.argv[1:])
    category = "--category" in args
    if category:
        args.remove("--category")
    keeps = [float(a) for a in args] or [0.92, 0.8]

    from bench import bench_config
    from kss_icp.challenge import (
        category_corpus, partial_corpus, transform_rmse)
    from kss_icp.core.transforms import apply_similarity
    from kss_icp.parallel.batch import register_many

    cfg = bench_config()
    tiers = ([("category", category_corpus())] if category
             else [(k, partial_corpus(keep=k)) for k in keeps])
    for keep, pairs in tiers:
        t0 = time.time()
        res, m = register_many([(s, t) for _, s, t, _ in pairs], cfg)
        dt = time.time() - t0
        n_ok = 0
        for i, (name, src, tgt, gt) in enumerate(pairs):
            al = np.asarray(apply_similarity(
                jax.tree.map(lambda x, _i=i: jnp.asarray(np.asarray(x)[_i]),
                             res.transform),
                jnp.asarray(src, jnp.float32)))
            pose = transform_rmse(al, src, gt)
            ok = pose <= 0.10
            n_ok += int(ok)
            print(f"keep={keep} {name:14s} pose={pose:.4f} "
                  f"[{'ok' if ok else 'FAIL'}] fitness="
                  f"{float(np.asarray(res.fitness)[i]):.2e}")
        print(f"keep={keep}: {n_ok}/{len(pairs)} (ladder, {dt:.0f}s)\n")


if __name__ == "__main__":
    main()

"""Winner-neighborhood precision restarts (KSSICPConfig.neighborhood_fracs
/ CLI --precise): re-converge from small Euler offsets of the winning
pose, keep-better by fitness. Measured motivation: tube/1's narrow basin
(fitness 1.22e-3 -> 9.75e-4, pose 0.117 -> 0.051) — see the config
docstring."""

from __future__ import annotations

import dataclasses

import numpy as np


def _pair(n=600, seed=3):
    rng = np.random.default_rng(seed)
    u = rng.uniform(-1, 1, n)
    v = rng.uniform(-1, 1, n)
    z = 0.35 * np.sin(2.2 * u) * np.cos(1.7 * v)
    tgt = np.stack([u, v, z], -1).astype(np.float32)
    from kss_icp.stress import rot_xyz

    R = rot_xyz(0.8, 0.4, 1.2)
    src = (tgt @ R.T + np.array([0.2, -0.1, 0.3])).astype(np.float32)
    return src, tgt


def test_polish_never_worse_and_changes_nothing_when_off():
    import jax.numpy as jnp

    from kss_icp.config import KSSICPConfig
    from kss_icp.models.kss_icp import register_resampled, resample_pairs

    cfg = KSSICPConfig(
        rotation_steps=4, max_candidates=4, max_resample_points=256,
        resample_pad=256, max_icp_iterations=40, rotation_chunk=16,
        screen_points=128, auto_escalate=False)
    src, tgt = _pair()
    pad = 640
    sp = np.zeros((1, pad, 3), np.float32)
    sp[0, : len(src)] = src
    sm = np.zeros((1, pad), bool)
    sm[0, : len(src)] = True
    tp = np.zeros((1, pad, 3), np.float32)
    tp[0, : len(tgt)] = tgt
    tm = np.zeros((1, pad), bool)
    tm[0, : len(tgt)] = True
    pn = jnp.asarray([cfg.resample_count(len(src), len(tgt))], jnp.int32)
    (rs, rsm), (rt, rtm) = resample_pairs(
        jnp.asarray(sp), jnp.asarray(sm), jnp.asarray(tp), jnp.asarray(tm),
        pn, cfg)
    a = (rs[0], rsm[0], rt[0], rtm[0])

    base = register_resampled(*a, cfg)
    prec = register_resampled(
        *a, dataclasses.replace(cfg, neighborhood_fracs=(0.25, 0.5)))
    # Keep-better invariant: the precision mode can only improve fitness.
    assert float(prec.fitness) <= float(base.fitness) + 1e-12
    # And with the knob off the path is bit-identical to before the knob
    # existed (same program — the branch is static).
    base2 = register_resampled(*a, cfg)
    np.testing.assert_array_equal(np.asarray(base.transform.rotation),
                                  np.asarray(base2.transform.rotation))


def test_tier_path_also_polishes():
    import jax.numpy as jnp

    from kss_icp.config import KSSICPConfig
    from kss_icp.models.kss_icp import register_resampled, resample_pairs

    cfg = KSSICPConfig(
        rotation_steps=4, max_candidates=4, max_resample_points=256,
        resample_pad=256, max_icp_iterations=40, rotation_chunk=16,
        screen_points=128, refine_candidates=2, refine_tier_iterations=6,
        refine_max_iterations=24, auto_escalate=False,
        neighborhood_fracs=(0.5,))
    src, tgt = _pair(seed=5)
    pad = 640
    sp = np.zeros((1, pad, 3), np.float32)
    sp[0, : len(src)] = src
    sm = np.zeros((1, pad), bool)
    sm[0, : len(src)] = True
    tp = np.zeros((1, pad, 3), np.float32)
    tp[0, : len(tgt)] = tgt
    tm = np.zeros((1, pad), bool)
    tm[0, : len(tgt)] = True
    pn = jnp.asarray([cfg.resample_count(len(src), len(tgt))], jnp.int32)
    (rs, rsm), (rt, rtm) = resample_pairs(
        jnp.asarray(sp), jnp.asarray(sm), jnp.asarray(tp), jnp.asarray(tm),
        pn, cfg)
    res = register_resampled(rs[0], rsm[0], rt[0], rtm[0], cfg)
    assert np.isfinite(float(res.fitness))
    # 4^3-grid tiny config: the basin is coarse — assert sane convergence
    # (wrong basins on this sheet land at ~0.1+), not precision.
    assert float(res.fitness) < 0.05

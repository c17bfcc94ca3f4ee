"""Screen-seeded overlap rung (round 5, models/kss_icp.
register_overlap_screen_resampled): the selector that replaces the
trimmed field under heavy crops, where the crop-biased pre-shape makes
the field score the true rotation worse than every local minimum (the
part/se1 case — measured tables in scripts/se1_*_probe.py)."""

from __future__ import annotations

import numpy as np
import pytest


def _tiny_cfg():
    from kss_icp.config import KSSICPConfig

    return KSSICPConfig(
        rotation_steps=4, max_candidates=4, max_resample_points=256,
        resample_pad=256, max_icp_iterations=40, rotation_chunk=16,
        screen_points=128,
        overlap_screen_steps=8, overlap_screen_iters=8,
        overlap_screen_topk=3, overlap_screen_batch=8)


def _cropped_pair(rng, n=1200, keep=0.75):
    """A wavy sheet with asymmetry bumps, both sides cropped by different
    half-spaces, source rotated+shifted — the crop-biased regime the
    screen rung exists for."""
    u = rng.uniform(-1, 1, n)
    v = rng.uniform(-1, 1, n)
    z = 0.4 * np.sin(2.5 * u) * np.cos(1.8 * v) + 0.25 * np.exp(
        -((u - 0.5) ** 2 + (v + 0.4) ** 2) / 0.1)
    base = np.stack([u, v, z], -1)
    from kss_icp.stress import rot_xyz

    R = rot_xyz(0.9, 0.5, 1.7)
    t = np.array([0.3, -0.2, 0.5])
    src = base @ R.T + t

    def crop(pts, normal, k):
        s = pts @ normal
        return pts[s <= np.quantile(s, k)]

    n1 = np.array([1.0, 0.3, 0.2]) / np.linalg.norm([1.0, 0.3, 0.2])
    n2 = np.array([-0.2, 1.0, 0.1]) / np.linalg.norm([-0.2, 1.0, 0.1])
    return (crop(src, n1 @ R.T, keep).astype(np.float32),
            crop(base, n2, keep).astype(np.float32), R, t)


@pytest.fixture(scope="module")
def solved():
    import jax.numpy as jnp

    from kss_icp.models.kss_icp import (
        register_overlap_screen_resampled,
        resample_pairs,
    )

    cfg = _tiny_cfg()
    rng = np.random.default_rng(5)
    src, tgt, R, t = _cropped_pair(rng)

    pad = 1280
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
    res = register_overlap_screen_resampled(
        rs[0], rsm[0], rt[0], rtm[0], cfg.overlap_config())
    return res, (src, tgt, R, t), cfg


def test_contract(solved):
    res, _, cfg = solved
    assert np.isfinite(float(res.fitness))
    assert res.transform.rotation.shape == (3, 3)
    # topk candidates recorded in the coarse slot
    assert res.coarse.candidate_angles.shape == (cfg.overlap_screen_topk, 3)
    assert not bool(res.refine_hit_cap)


def test_recovers_cropped_pose(solved):
    import jax.numpy as jnp

    from kss_icp.core.transforms import apply_similarity

    res, (src, tgt, R, t), _ = solved
    # Basin correctness: a wrong basin lands at O(1) pose error on this
    # unit-scale sheet (the FIELD rung measures 1.15 here — the
    # crop-biased selector failure the screen rung exists for); the
    # screen rung lands basin-correct with the slack of a 256-point
    # working set (measured 0.17).
    rec = np.asarray(apply_similarity(res.transform,
                                      jnp.asarray(src, jnp.float32)))
    truth = (src - t) @ R
    pose = float(np.sqrt(np.mean(np.sum((rec - truth) ** 2, -1))))
    assert pose < 0.3, pose


def test_screen_beats_field_selector_under_crop(solved):
    """The rung's raison d'etre: on the crop-biased pair the screen
    selector finds the true basin (pose ~0.17, trimmed fitness 5.3e-3)
    while the field selector converges a wrong basin (pose 1.15, trimmed
    fitness 1.25e-2)."""
    import jax.numpy as jnp

    from kss_icp.core.transforms import apply_similarity
    from kss_icp.models.kss_icp import (
        register_overlap_resampled,
        resample_pairs,
    )

    res, (src, tgt, R, t), cfg = solved
    pad = 1280
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
    res_f = register_overlap_resampled(
        rs[0], rsm[0], rt[0], rtm[0], cfg.overlap_config())
    # Compare POSES (the two rungs report differently-normalized trimmed
    # fitnesses, so pose is the unambiguous criterion).
    truth = (src - t) @ R

    def pose_of(r):
        rec = np.asarray(apply_similarity(r.transform,
                                          jnp.asarray(src, jnp.float32)))
        return float(np.sqrt(np.mean(np.sum((rec - truth) ** 2, -1))))

    assert pose_of(res) < 0.3 < pose_of(res_f), (
        pose_of(res), pose_of(res_f))


def test_batched_contract():
    import jax.numpy as jnp

    from kss_icp.core.transforms import Similarity
    from kss_icp.models.kss_icp import (
        overlap_screen_solve_batch,
        resample_pairs,
    )

    cfg = _tiny_cfg()
    rng = np.random.default_rng(7)
    pairs = [_cropped_pair(rng, n=800) for _ in range(2)]
    pad = 1024
    sp = np.zeros((2, pad, 3), np.float32)
    sm = np.zeros((2, pad), bool)
    tp = np.zeros((2, pad, 3), np.float32)
    tm = np.zeros((2, pad), bool)
    for i, (s, tg, _, _) in enumerate(pairs):
        sp[i, : len(s)] = s
        sm[i, : len(s)] = True
        tp[i, : len(tg)] = tg
        tm[i, : len(tg)] = True
    pn = jnp.asarray([cfg.resample_count(len(p[0]), len(p[1]))
                      for p in pairs], jnp.int32)
    (rs, rsm), (rt, rtm) = resample_pairs(
        jnp.asarray(sp), jnp.asarray(sm), jnp.asarray(tp), jnp.asarray(tm),
        pn, cfg)
    base = Similarity.identity(batch_shape=(2,))
    tr, fit_std, tf_new, tf_old = overlap_screen_solve_batch(
        rs, rsm, rt, rtm, base, cfg.overlap_config())
    assert fit_std.shape == (2,) and tf_new.shape == (2,)
    assert np.all(np.isfinite(np.asarray(tf_new)))

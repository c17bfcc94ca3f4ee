"""AIVS-style stratified resampler (ops/aivs.py) vs. the reference's quota /
cut / classification semantics (Method_AIVS_SimPro.hpp)."""

import jax.numpy as jnp
import numpy as np

from kss_icp.ops.aivs import (
    accurate_cut,
    aivs_resample,
    box_quotas,
    classify_curvature,
    stratified_fps,
)
from kss_icp.ops.spatial import build_voxel_grid
from helpers import random_cloud


def _padded(rng, n, pad=512):
    pts = random_cloud(rng, n).astype(np.float32)
    padded = np.zeros((pad, 3), np.float32)
    padded[:n] = pts
    mask = np.zeros((pad,), bool)
    mask[:n] = True
    return jnp.asarray(padded), jnp.asarray(mask)


def test_box_quotas_rounding():
    counts = jnp.asarray(np.array([10, 10, 10, 10], np.int32))
    # rate 0.525 -> ideal 5.25 each, fraction 0.25 > 0.2 -> round up to 6.
    q = np.asarray(box_quotas(counts, 21))
    np.testing.assert_array_equal(q, [6, 6, 6, 6])
    # rate 0.51 -> ideal 5.1, fraction 0.1 <= 0.2 -> floor 5.
    q = np.asarray(box_quotas(counts, 20.4))
    np.testing.assert_array_equal(q, [5, 5, 5, 5])
    # Quota never exceeds the box population.
    q = np.asarray(box_quotas(jnp.asarray(np.array([2, 100], np.int32)), 80))
    assert q[0] <= 2


def test_stratified_fps_meets_quotas(rng):
    pts, mask = _padded(rng, 400)
    grid = build_voxel_grid(pts, mask, 3)
    quotas = box_quotas(grid.counts, 100)
    sel, rounds = stratified_fps(pts, mask, grid.box_id, quotas,
                                 max_rounds=int(np.asarray(quotas).max()))
    sel, rounds = np.asarray(sel), np.asarray(rounds)
    # pick_round marks every selected point with its lockstep round.
    assert (rounds[sel] < len(sel)).all()
    assert (rounds[~sel] == len(sel)).all()
    box_id = np.asarray(grid.box_id)
    q = np.asarray(quotas)
    for b in range(27):
        got = int(sel[box_id == b].sum())
        want = min(q[b], int((box_id == b).sum()))
        assert got == want, (b, got, want)
    assert not sel[~np.asarray(mask)].any()


def test_accurate_cut_to_exact_count(rng):
    pts, mask = _padded(rng, 100, pad=128)
    sel0 = np.asarray(mask).copy()
    sel = np.asarray(accurate_cut(pts, jnp.asarray(sel0), 90, max_cuts=16))
    assert sel.sum() == 90
    # Cut points were in the tightest spots: surviving min spacing must not
    # shrink.
    p = np.asarray(pts)

    def min_spacing(s):
        d = np.linalg.norm(p[s][:, None] - p[s][None, :], axis=-1)
        np.fill_diagonal(d, np.inf)
        return d.min()

    assert min_spacing(sel) >= min_spacing(sel0) - 1e-7


def test_aivs_resample_exact_n(rng):
    pts, mask = _padded(rng, 450)
    out, sel = aivs_resample(pts, mask, 120, boxes_per_axis=3)
    assert int(np.asarray(sel).sum()) == 120
    # Selected points are spread: mean NN spacing within 2.5x of global FPS.
    from kss_icp.ops.resample import farthest_point_sampling

    idx, fmask = farthest_point_sampling(pts, mask, 120)
    p = np.asarray(pts)

    def spacing(sel_pts):
        d = np.linalg.norm(sel_pts[:, None] - sel_pts[None, :], axis=-1)
        np.fill_diagonal(d, np.inf)
        return d.min(axis=1).mean()

    s_aivs = spacing(p[np.asarray(sel)])
    s_fps = spacing(p[np.asarray(idx)[np.asarray(fmask)]])
    assert s_aivs > 0.4 * s_fps


def test_classify_curvature_flat_vs_edge(rng):
    # Flat sheet: all normals aligned -> class 0. Random normals -> class 2.
    n = 256
    pts, mask = _padded(rng, n, pad=256)
    flat_normals = jnp.asarray(np.tile([0, 0, 1.0], (256, 1)).astype(np.float32))
    cls = np.asarray(classify_curvature(flat_normals, pts, mask))
    assert (cls[:n] == 0).all()

    noisy = rng.normal(size=(256, 3)).astype(np.float32)
    noisy /= np.linalg.norm(noisy, axis=1, keepdims=True)
    cls = np.asarray(classify_curvature(jnp.asarray(noisy), pts, mask))
    assert (cls[:n] >= 1).mean() > 0.9


def test_aivs_resample_packed_prefix_is_stratified(rng):
    # Packed output: selected points first, ordered by lockstep round — a
    # prefix therefore holds every box's round-0 picks before any round-1
    # pick, i.e. a stratified uniform subsample (the contract the pipeline's
    # coarse_points/screen_points slicing needs).
    from kss_icp.ops.aivs import aivs_resample_packed

    pts, mask = _padded(rng, 450)
    out, sel = aivs_resample_packed(pts, mask, 120, pad=256, boxes_per_axis=3)
    sel = np.asarray(sel)
    assert out.shape == (256, 3)
    n_sel = int(sel.sum())
    assert 100 <= n_sel <= 120  # quota round-down can land slightly under
    assert sel[:n_sel].all() and not sel[n_sel:].any()  # packed prefix
    # The prefix must cover the cloud: its mean-NN spread within 3x of a
    # global-FPS subsample of the same size.
    k = n_sel // 2
    prefix = np.asarray(out)[:k]
    from kss_icp.ops.resample import farthest_point_sampling

    idx, fmask = farthest_point_sampling(pts, mask, k)
    fps_pts = np.asarray(pts)[np.asarray(idx)[np.asarray(fmask)]]

    def spread(x):
        d = np.linalg.norm(x[:, None] - x[None, :], axis=-1)
        np.fill_diagonal(d, np.inf)
        return d.min(axis=1).mean()

    assert spread(prefix) > 0.33 * spread(fps_pts)


def test_pipeline_with_aivs_resampler(rng):
    # cfg.resampler="aivs" drives the whole registration pipeline through
    # the reference's default sampler (VERDICT round-1 item #7).

    from kss_icp.config import KSSICPConfig
    from kss_icp.core.transforms import apply_similarity, euler_xyz_matrix
    from kss_icp.metrics import registration_measure
    from kss_icp.models.kss_icp import register_pair

    cfg = KSSICPConfig(
        rotation_steps=8, max_candidates=8, max_resample_points=256,
        resample_pad=256, max_icp_iterations=100, rotation_chunk=64,
        resampler="aivs", aivs_boxes_per_axis=4,
    )
    tgt = np.asarray(random_cloud(rng, 800), np.float32)
    r = np.asarray(euler_xyz_matrix(jnp.array([1.56, 0.0, 0.0])), np.float32)
    src = tgt @ r
    res = register_pair(src, tgt, cfg)
    aligned = np.asarray(apply_similarity(res.transform, jnp.asarray(src)))
    m = registration_measure(aligned, tgt)
    assert m["rmse"] < 0.03, m

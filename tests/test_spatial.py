"""Voxel-grid spatial index (ops/spatial.py) vs. BallRegion semantics
(ballRegionCompute.hpp) and numpy oracles."""

import jax.numpy as jnp
import numpy as np

from kss_icp.ops.spatial import (
    box_coloring,
    build_voxel_grid,
    estimate_box_scale,
    estimate_radius,
    knn_cache,
    neighbor_box_ids,
    points_in_neighborhood,
)
from helpers import random_cloud


def _padded(rng, n, pad=256):
    pts = random_cloud(rng, n).astype(np.float32)
    padded = np.zeros((pad, 3), np.float32)
    padded[:n] = pts
    mask = np.zeros((pad,), bool)
    mask[:n] = True
    return jnp.asarray(padded), jnp.asarray(mask), pts


def test_box_scale_ladder():
    # ballRegionCompute.hpp:1194-1214
    assert estimate_box_scale(500) == 10
    assert estimate_box_scale(9_999) == 10
    assert estimate_box_scale(10_000) == 20
    assert estimate_box_scale(60_000) == 30
    assert estimate_box_scale(200_000) == 40
    assert estimate_box_scale(600_000) == 50
    assert estimate_box_scale(8_000_000) == 100  # cbrt(8e6 / 8)


def test_grid_membership_counts(rng):
    pts_j, mask_j, pts = _padded(rng, 200)
    nb = 4
    grid = build_voxel_grid(pts_j, mask_j, nb)
    assert int(grid.counts.sum()) == 200
    # Oracle: recompute box ids in numpy.
    lo = pts.min(axis=0)
    unit = np.maximum(pts.max(axis=0) - lo, np.finfo(np.float32).eps) / nb
    ijk = np.clip(np.floor((pts - lo) / unit).astype(int), 0, nb - 1)
    flat = (ijk[:, 0] * nb + ijk[:, 1]) * nb + ijk[:, 2]
    np.testing.assert_array_equal(np.asarray(grid.box_id)[:200], flat)
    assert np.all(np.asarray(grid.box_id)[200:] == -1)
    counts = np.bincount(flat, minlength=nb**3)
    np.testing.assert_array_equal(np.asarray(grid.counts), counts)
    np.testing.assert_array_equal(np.asarray(grid.occupied), counts > 0)


def test_grid_center_point_is_nearest(rng):
    pts_j, mask_j, pts = _padded(rng, 150)
    nb = 3
    grid = build_voxel_grid(pts_j, mask_j, nb)
    box_id = np.asarray(grid.box_id)[:150]
    centers = np.asarray(grid.centers)
    cp = np.asarray(grid.center_point)
    for b in range(nb**3):
        members = np.where(box_id == b)[0]
        if members.size == 0:
            assert cp[b] == pts_j.shape[0]
            continue
        d = np.linalg.norm(pts[members] - centers[b], axis=1)
        assert cp[b] == members[np.argmin(d)]


def test_estimate_radius_matches_bruteforce(rng):
    pts_j, mask_j, pts = _padded(rng, 100)
    r = float(estimate_radius(pts_j, mask_j, k=12))
    d = np.linalg.norm(pts[:, None] - pts[None, :], axis=-1)
    d_sorted = np.sort(d, axis=1)
    oracle = d_sorted[:, 12].max()  # 12th non-self neighbor
    np.testing.assert_allclose(r, oracle, rtol=1e-5)


def test_knn_cache_excludes_self(rng):
    pts_j, mask_j, pts = _padded(rng, 80)
    d, idx = knn_cache(pts_j, mask_j, k=5)
    idx = np.asarray(idx)[:80]
    assert not np.any(idx == np.arange(80)[:, None])
    # First neighbor distance matches brute force.
    dm = np.linalg.norm(pts[:, None] - pts[None, :], axis=-1)
    np.fill_diagonal(dm, np.inf)
    np.testing.assert_allclose(np.asarray(d)[:80, 0], dm.min(axis=1), rtol=1e-4)


def test_box_coloring_parity():
    nb = 4
    colors = np.asarray(box_coloring(nb)).reshape(nb, nb, nb)
    for i, j, k in [(0, 0, 0), (1, 0, 0), (0, 1, 1), (3, 2, 1)]:
        assert colors[i, j, k] == (i % 2) * 4 + (j % 2) * 2 + (k % 2)
    # Neighbors in the 3^3 stencil never share a color with the center's
    # opposite-parity cells: each color class is an independent set at
    # stride 2 (the AIVS conflict-freedom property).
    assert set(np.unique(colors)) == set(range(8))


def test_neighbor_box_ids_stencil():
    nb = 3
    nbrs = np.asarray(neighbor_box_ids(nb))
    assert nbrs.shape == (27, 27)
    # Center box (1,1,1) has all 27 neighbors valid.
    center = (1 * nb + 1) * nb + 1
    assert np.all(nbrs[center] >= 0)
    assert set(nbrs[center]) == set(range(27))
    # Corner box (0,0,0) has exactly 8 valid neighbors.
    assert (nbrs[0] >= 0).sum() == 8


def test_points_in_neighborhood(rng):
    pts_j, mask_j, pts = _padded(rng, 120)
    nb = 3
    grid = build_voxel_grid(pts_j, mask_j, nb)
    center = (1 * nb + 1) * nb + 1
    sel = np.asarray(points_in_neighborhood(grid, nb, center))
    # Oracle: all valid points whose box is within Chebyshev distance 1.
    box_id = np.asarray(grid.box_id)
    ijk = np.stack([box_id // (nb * nb), (box_id // nb) % nb, box_id % nb], -1)
    cheb = np.abs(ijk - np.array([1, 1, 1])).max(axis=-1)
    oracle = (box_id >= 0) & (cheb <= 1)
    np.testing.assert_array_equal(sel, oracle)

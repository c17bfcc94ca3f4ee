"""FPS and voxel downsample: determinism, exact-N, mask correctness,
uniformity (the property AIVS exists to provide)."""

import jax.numpy as jnp
import numpy as np

from kss_icp.ops.resample import (
    farthest_point_sampling,
    fps_points,
    voxel_downsample,
)
from helpers import random_cloud


def test_fps_exact_count_and_unique(rng):
    pts = random_cloud(rng, 500)
    idx, mask = farthest_point_sampling(
        jnp.asarray(pts, jnp.float32), jnp.ones(500, bool), 64
    )
    idx, mask = np.asarray(idx), np.asarray(mask)
    assert mask.all()
    assert len(np.unique(idx)) == 64


def test_fps_deterministic(rng):
    pts = jnp.asarray(random_cloud(rng, 300), jnp.float32)
    i1, _ = farthest_point_sampling(pts, jnp.ones(300, bool), 32)
    i2, _ = farthest_point_sampling(pts, jnp.ones(300, bool), 32)
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))


def test_fps_respects_mask(rng):
    pts = random_cloud(rng, 200)
    pts[150:] = 1e6  # poison the padding region
    mask = np.arange(200) < 150
    idx, smask = farthest_point_sampling(
        jnp.asarray(pts, jnp.float32), jnp.asarray(mask), 50
    )
    assert np.asarray(smask).all()
    assert np.all(np.asarray(idx) < 150)


def test_fps_fewer_valid_than_samples(rng):
    pts = random_cloud(rng, 100)
    mask = np.arange(100) < 10
    _, smask = farthest_point_sampling(
        jnp.asarray(pts, jnp.float32), jnp.asarray(mask), 32
    )
    assert np.asarray(smask).sum() == 10


def test_fps_uniformity_beats_random(rng):
    """Min pairwise distance of an FPS sample should far exceed a random
    subsample's — the uniformity contract of AIVS resampling."""
    pts = random_cloud(rng, 2000)
    sampled, smask = fps_points(jnp.asarray(pts, jnp.float32), jnp.ones(2000, bool), 128)
    s = np.asarray(sampled)[np.asarray(smask)]

    def min_pair_dist(x):
        d2 = ((x[:, None] - x[None, :]) ** 2).sum(-1)
        np.fill_diagonal(d2, np.inf)
        return np.sqrt(d2.min())

    rand = pts[rng.choice(2000, 128, replace=False)]
    assert min_pair_dist(s) > 2.0 * min_pair_dist(rand)


def test_voxel_downsample_one_per_cell(rng):
    pts = random_cloud(rng, 400)
    cell = jnp.asarray(0.25, jnp.float32)
    out_pts, keep = voxel_downsample(
        jnp.asarray(pts, jnp.float32), jnp.ones(400, bool), cell
    )
    out = np.asarray(out_pts)[np.asarray(keep)]
    # Every survivor in a distinct voxel.
    lo = pts.min(0)
    ijk = np.floor((out - lo) / 0.25).astype(int)
    keys = {tuple(v) for v in ijk}
    assert len(keys) == out.shape[0]
    # Survivors are real input points.
    d2 = ((out[:, None] - pts[None]) ** 2).sum(-1)
    assert d2.min(axis=1).max() < 1e-10


def test_voxel_downsample_keeps_nearest_to_center(rng):
    pts = np.array(
        [[0.1, 0.1, 0.1], [0.45, 0.45, 0.45], [0.26, 0.26, 0.26]], dtype=np.float64
    )
    # one voxel [0, 0.5)^3 (lo at first point); center at 0.35 offset from lo
    out_pts, keep = voxel_downsample(
        jnp.asarray(pts, jnp.float32), jnp.ones(3, bool), jnp.asarray(0.5, jnp.float32)
    )
    out = np.asarray(out_pts)[np.asarray(keep)]
    assert out.shape[0] == 1
    # Voxel center = lo + 0.25 = 0.35; nearest real point is [0.26, ...]
    np.testing.assert_allclose(out[0], pts[2], atol=1e-6)

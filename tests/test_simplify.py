"""Grid/hierarchy/octree simplification."""

import jax.numpy as jnp
import numpy as np

from kss_icp.ops.simplify import grid_simplify, hierarchy_simplify, octree_simplify
from helpers import random_cloud


def test_hierarchy_cluster_size_bound(rng):
    pts = random_cloud(rng, 1024).astype(np.float32)
    out, keep = hierarchy_simplify(jnp.asarray(pts), jnp.ones(1024, bool),
                                   max_cluster_size=16)
    kept = np.asarray(out)[np.asarray(keep)]
    # One representative per cluster: at least P/max_cluster and at most P.
    assert 1024 // 16 <= kept.shape[0] <= 1024
    # Representatives are real input points.
    d2 = ((kept[:, None] - pts[None]) ** 2).sum(-1).min(1)
    assert d2.max() < 1e-10


def test_hierarchy_respects_mask(rng):
    pts = random_cloud(rng, 256).astype(np.float32)
    pts[200:] = 1e5
    mask = np.arange(256) < 200
    out, keep = hierarchy_simplify(jnp.asarray(pts), jnp.asarray(mask),
                                   max_cluster_size=8)
    kept = np.asarray(out)[np.asarray(keep)]
    assert np.abs(kept).max() < 10.0


def test_hierarchy_reduces_count(rng):
    pts = random_cloud(rng, 2048).astype(np.float32)
    _, keep = hierarchy_simplify(jnp.asarray(pts), jnp.ones(2048, bool),
                                 max_cluster_size=32)
    n = int(np.asarray(keep).sum())
    assert n < 2048 // 4  # strong reduction with size-32 clusters


def test_grid_simplify_wraps_voxel(rng):
    pts = random_cloud(rng, 500).astype(np.float32)
    out, keep = grid_simplify(jnp.asarray(pts), jnp.ones(500, bool), 0.3)
    assert 0 < int(np.asarray(keep).sum()) < 500


def test_octree_target_scaling(rng):
    pts = random_cloud(rng, 4000).astype(np.float32)
    _, keep_small = octree_simplify(jnp.asarray(pts), jnp.ones(4000, bool),
                                    target_points=50)
    _, keep_big = octree_simplify(jnp.asarray(pts), jnp.ones(4000, bool),
                                  target_points=2000)
    assert int(np.asarray(keep_small).sum()) < int(np.asarray(keep_big).sum())


def test_hierarchy_simplify_variation_stop(rng):
    # The surVar criterion (Method_CGAL.hpp:88): a curved cloud must split
    # deeper (=> keep more representatives) when max_variation is tightened,
    # even though every cluster is already under the size cap.
    from kss_icp.ops.simplify import hierarchy_simplify

    n = 512
    u = rng.uniform(-1, 1, n)
    v = rng.uniform(-1, 1, n)
    pts = np.stack([u, v, 0.5 * np.sin(4 * u) * np.cos(4 * v)], -1).astype(np.float32)
    mask = np.ones(n, bool)
    _, keep_size_only = hierarchy_simplify(
        jnp.asarray(pts), jnp.asarray(mask), max_cluster_size=256)
    _, keep_var = hierarchy_simplify(
        jnp.asarray(pts), jnp.asarray(mask), max_cluster_size=256,
        max_variation=0.01)
    assert int(keep_var.sum()) > int(keep_size_only.sum())
    # Flat plane: variation ~0 everywhere, so the tight cap changes nothing.
    flat = pts.copy(); flat[:, 2] = 0.0
    _, k1 = hierarchy_simplify(jnp.asarray(flat), jnp.asarray(mask),
                               max_cluster_size=64)
    _, k2 = hierarchy_simplify(jnp.asarray(flat), jnp.asarray(mask),
                               max_cluster_size=64, max_variation=0.01)
    assert int(k1.sum()) == int(k2.sum())

"""Normal estimation: planar oracle, orientation consistency."""

import jax.numpy as jnp
import numpy as np

from kss_icp.ops.normals import (
    estimate_normals,
    estimate_oriented_normals,
    orient_normals,
)


def plane_cloud(rng, n, normal, noise=0.0):
    normal = np.asarray(normal, float)
    normal /= np.linalg.norm(normal)
    # Basis of the plane.
    a = np.array([1.0, 0.0, 0.0])
    if abs(normal[0]) > 0.9:
        a = np.array([0.0, 1.0, 0.0])
    u = np.cross(normal, a)
    u /= np.linalg.norm(u)
    v = np.cross(normal, u)
    coef = rng.uniform(-1, 1, (n, 2))
    pts = coef[:, :1] * u + coef[:, 1:] * v
    pts += noise * rng.normal(size=(n, 1)) * normal
    return pts, normal


def test_plane_normals(rng):
    pts, n_true = plane_cloud(rng, 300, [1.0, 2.0, 3.0])
    normals = np.asarray(
        estimate_normals(jnp.asarray(pts, jnp.float32), jnp.ones(300, bool), k=12)
    )
    dots = np.abs(normals @ n_true)
    assert (dots > 0.99).mean() > 0.95


def test_normals_unit_length(rng):
    pts = rng.normal(size=(200, 3)).astype(np.float32)
    normals = np.asarray(estimate_normals(jnp.asarray(pts), jnp.ones(200, bool)))
    np.testing.assert_allclose(np.linalg.norm(normals, axis=1), 1.0, atol=1e-5)


def test_orientation_consistency_on_sphere(rng):
    """On a (connected-sampled) sphere, oriented normals must all point the
    same way radially — the sign pattern BFS/propagation exists to fix."""
    v = rng.normal(size=(600, 3))
    pts = (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)
    mask = jnp.ones(600, bool)
    normals = estimate_oriented_normals(jnp.asarray(pts), mask, k=16, k_orient=10)
    radial = np.sum(np.asarray(normals) * pts, axis=1)
    signs = np.sign(radial)
    # All agree (either all outward or all inward).
    assert np.abs(signs.sum()) > 0.95 * 600


def test_orient_respects_mask(rng):
    pts = rng.normal(size=(100, 3)).astype(np.float32)
    mask = np.arange(100) < 60
    n = estimate_normals(jnp.asarray(pts), jnp.asarray(mask))
    out = np.asarray(orient_normals(jnp.asarray(pts), n, jnp.asarray(mask)))
    assert out.shape == (100, 3)
    assert np.isfinite(out).all()

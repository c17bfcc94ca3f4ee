"""Unit tests for core transforms against tiny numpy oracles, including
parity with the reference's axis-rotation formulas
(initRegistrationKSS.hpp:365-404)."""

import jax.numpy as jnp
import numpy as np
import pytest

from kss_icp.core.transforms import (
    Similarity,
    apply_similarity,
    compose,
    euler_xyz_matrix,
    rot_x,
    rot_y,
    rot_z,
)


def reference_transfer(cord, angle, pts):
    """Literal re-statement of initRegistration_Transfer semantics."""
    pts = np.array(pts, dtype=np.float64)
    out = pts.copy()
    c, s = np.cos(angle), np.sin(angle)
    if cord == 1:  # x-axis
        out[:, 1] = pts[:, 1] * c - pts[:, 2] * s
        out[:, 2] = pts[:, 1] * s + pts[:, 2] * c
    elif cord == 2:  # y-axis
        out[:, 0] = pts[:, 2] * s + pts[:, 0] * c
        out[:, 2] = pts[:, 2] * c - pts[:, 0] * s
    else:  # z-axis
        out[:, 0] = pts[:, 0] * c - pts[:, 1] * s
        out[:, 1] = pts[:, 0] * s + pts[:, 1] * c
    return out


@pytest.mark.parametrize("cord,rot", [(1, rot_x), (2, rot_y), (3, rot_z)])
@pytest.mark.parametrize("angle", [0.0, 0.7875, 1.56, 3.0, 5.5125])
def test_axis_rotations_match_reference(rng, cord, rot, angle):
    pts = rng.normal(size=(50, 3))
    expected = reference_transfer(cord, angle, pts)
    got = np.asarray(pts @ np.asarray(rot(angle)).T)
    np.testing.assert_allclose(got, expected, atol=1e-12)


def test_euler_xyz_application_order(rng):
    """X then Y then Z (initRegistrationKSS.hpp:86-88)."""
    pts = rng.normal(size=(20, 3))
    a, b, c = 0.3, 1.1, 2.5
    expected = reference_transfer(3, c, reference_transfer(2, b, reference_transfer(1, a, pts)))
    r = np.asarray(euler_xyz_matrix(jnp.array([a, b, c])))
    np.testing.assert_allclose(pts @ r.T, expected, atol=1e-12)


def test_rotation_matrices_are_orthonormal(rng):
    angles = rng.uniform(0, 6.3, size=(10, 3))
    r = np.asarray(euler_xyz_matrix(jnp.asarray(angles)))
    eye = np.broadcast_to(np.eye(3), r.shape)
    np.testing.assert_allclose(r @ np.swapaxes(r, -1, -2), eye, atol=1e-6)
    np.testing.assert_allclose(np.linalg.det(r), 1.0, atol=1e-6)


def test_similarity_compose_matches_sequential(rng):
    pts = jnp.asarray(rng.normal(size=(30, 3)), jnp.float64)
    a = Similarity(
        scale=jnp.asarray(1.7, jnp.float64),
        rotation=jnp.asarray(euler_xyz_matrix(jnp.array([0.2, 0.4, 0.6])), jnp.float64),
        translation=jnp.asarray([1.0, -2.0, 0.5], jnp.float64),
    )
    b = Similarity(
        scale=jnp.asarray(0.4, jnp.float64),
        rotation=jnp.asarray(euler_xyz_matrix(jnp.array([1.2, 0.1, 2.0])), jnp.float64),
        translation=jnp.asarray([-0.3, 0.7, 2.2], jnp.float64),
    )
    seq = apply_similarity(a, apply_similarity(b, pts))
    fused = apply_similarity(compose(a, b), pts)
    np.testing.assert_allclose(np.asarray(fused), np.asarray(seq), atol=1e-12)


def test_identity_is_noop(rng):
    pts = jnp.asarray(rng.normal(size=(10, 3)), jnp.float32)
    out = apply_similarity(Similarity.identity(), pts)
    np.testing.assert_allclose(np.asarray(out), np.asarray(pts), atol=1e-7)

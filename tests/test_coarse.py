"""Rotation-grid coarse search: field semantics, local minima, recovery of
known rotations."""

import jax.numpy as jnp
import numpy as np

from kss_icp.core.transforms import euler_xyz_matrix
from kss_icp.models.coarse import (
    coarse_align,
    grid_angles,
    local_minima_mask,
    rotation_grid,
    score_rotation_field,
)
from helpers import random_cloud


def test_grid_angles_match_reference_loop():
    """Reference: for (i = 0; i < 6.3; i += 6.3/8) ⇒ 8 values i*0.7875."""
    a = np.asarray(grid_angles(8, 6.3))
    np.testing.assert_allclose(a, np.arange(8) * 6.3 / 8, rtol=1e-6)
    assert a[-1] < 6.3


def test_rotation_grid_row_major_order():
    g = np.asarray(rotation_grid(4, 6.3))
    assert g.shape == (64, 3)
    unit = 6.3 / 4
    # (i, j, k) row-major: k varies fastest (the reference's inner loop).
    np.testing.assert_allclose(g[1], [0, 0, unit], atol=1e-6)
    np.testing.assert_allclose(g[4], [0, unit, 0], atol=1e-6)
    np.testing.assert_allclose(g[16], [unit, 0, 0], atol=1e-6)


def brute_field(src, tgt, steps, span=6.3):
    """Numpy oracle for the error field."""
    angles = np.arange(steps) * span / steps
    field = np.zeros((steps, steps, steps))
    for ii, a in enumerate(angles):
        for jj, b in enumerate(angles):
            for kk, c in enumerate(angles):
                r = np.asarray(euler_xyz_matrix(jnp.array([a, b, c])))
                rs = src @ r.T
                d2 = ((rs[:, None] - tgt[None]) ** 2).sum(-1)
                field[ii, jj, kk] = np.sqrt(d2.min(1)).mean()
    return field


def test_score_field_matches_oracle(rng):
    src = random_cloud(rng, 60).astype(np.float32)
    tgt = random_cloud(rng, 70).astype(np.float32)
    steps = 3
    field = np.asarray(
        score_rotation_field(
            jnp.asarray(src), jnp.ones(60, bool),
            jnp.asarray(tgt), jnp.ones(70, bool),
            steps=steps, chunk=9,
        )
    )
    expected = brute_field(src.astype(np.float64), tgt.astype(np.float64), steps)
    np.testing.assert_allclose(field, expected, rtol=1e-4, atol=1e-5)


def test_local_minima_clamped_edges():
    """A strictly increasing 1D-style field has exactly one local minimum at
    the low corner (clamped window, no wrap — reference behavior)."""
    s = 6
    i, j, k = np.meshgrid(np.arange(s), np.arange(s), np.arange(s), indexing="ij")
    field = (i + j + k).astype(np.float32)
    mask = np.asarray(local_minima_mask(jnp.asarray(field), radius=2))
    assert mask[0, 0, 0]
    # Corners far from origin are NOT minima (their cube contains smaller values).
    assert not mask[5, 5, 5]
    # Plateau semantics: non-strict comparison ⇒ ties are all minima.
    flat = np.zeros((s, s, s), np.float32)
    assert np.asarray(local_minima_mask(jnp.asarray(flat), radius=2)).all()


def test_coarse_align_recovers_grid_rotation(rng):
    """Source rotated by an exact grid angle must be found exactly."""
    tgt = random_cloud(rng, 400).astype(np.float32)
    unit = 6.3 / 8
    true_angles = np.array([2 * unit, 5 * unit, 1 * unit], np.float32)
    r = np.asarray(euler_xyz_matrix(jnp.asarray(true_angles)), np.float32)
    # Source such that rotating it BY true_angles gives the target:
    src = tgt @ r  # src = R^T tgt  ⇒  R src = tgt
    res = coarse_align(
        jnp.asarray(src), jnp.ones(400, bool),
        jnp.asarray(tgt), jnp.ones(400, bool),
        steps=8, max_candidates=16,
    )
    np.testing.assert_allclose(np.asarray(res.best_angles), true_angles, atol=1e-5)
    # Candidate 0 is the global minimum.
    np.testing.assert_allclose(
        np.asarray(res.candidate_angles[0]), true_angles, atol=1e-5
    )
    assert bool(res.candidate_mask[0])
    assert float(res.candidate_errors[0]) < 1e-3


def test_error_metric_variants(rng):
    # masked_nn_error reproduces all three reference field flavors
    # (initRegistrationKSS.hpp:406-479) against a numpy oracle.
    from kss_icp.ops.nn import masked_nn_error

    q = rng.normal(size=(40, 3)).astype(np.float32)
    r = rng.normal(size=(64, 3)).astype(np.float32)
    qm = np.ones(40, bool); qm[35:] = False
    rm = np.ones(64, bool); rm[60:] = False
    full = ((q[:, None, :] - r[None, :, :]) ** 2).sum(-1)
    full[:, ~rm] = np.inf
    min_d2 = full.min(1)[qm]
    d = np.sqrt(min_d2)
    expect = {
        "ave": d.mean(),
        "max": min_d2.max(),          # the reference never sqrts this one
        "diff": d.max() - d.mean(),
    }
    for metric, want in expect.items():
        got = float(masked_nn_error(
            jnp.asarray(q), jnp.asarray(qm), jnp.asarray(r), jnp.asarray(rm),
            metric=metric,
        ))
        np.testing.assert_allclose(got, want, rtol=1e-5), metric


def test_coarse_error_metric_field_shapes(rng):
    # All three metrics produce a usable field and the same global best on a
    # clean single-axis rotation.
    src = np.asarray(random_cloud(rng, 300), np.float32)
    ang = 2 * 6.3 / 4
    c, s = np.cos(ang), np.sin(ang)
    rz = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    tgt = src @ rz.T  # rotating src by +ang about z aligns them
    bests = {}
    for metric in ("ave", "max", "diff"):
        res = coarse_align(
            jnp.asarray(src), jnp.ones(300, bool),
            jnp.asarray(tgt), jnp.ones(300, bool),
            steps=4, max_candidates=4, error_metric=metric,
        )
        assert res.field.shape == (4, 4, 4)
        bests[metric] = np.asarray(res.best_angles)
    np.testing.assert_allclose(bests["ave"], [0, 0, ang], atol=1e-6)
    np.testing.assert_allclose(bests["max"], bests["ave"], atol=1e-6)

"""Kabsch vs closed-form oracle; ICP recovers known rigid transforms."""

import jax
import jax.numpy as jnp
import numpy as np

from kss_icp.core.transforms import euler_xyz_matrix
from kss_icp.models.icp import ICPParams, icp, kabsch
from kss_icp.config import KSSICPConfig
from helpers import random_cloud


def _params(cfg=None):
    return ICPParams.from_config(cfg or KSSICPConfig(), jnp.float32)


def test_kabsch_exact_recovery(rng):
    src = random_cloud(rng, 100)
    r_true = np.asarray(euler_xyz_matrix(jnp.array([0.3, 1.2, 2.1])))
    t_true = np.array([0.5, -1.0, 2.0])
    tgt = src @ r_true.T + t_true
    r, t = kabsch(
        jnp.asarray(src, jnp.float64),
        jnp.asarray(tgt, jnp.float64),
        jnp.ones(100, jnp.float64),
    )
    np.testing.assert_allclose(np.asarray(r), r_true, atol=1e-9)
    np.testing.assert_allclose(np.asarray(t), t_true, atol=1e-9)


def test_kabsch_weighted(rng):
    """Zero-weight points (outliers) must not affect the estimate."""
    src = random_cloud(rng, 50)
    r_true = np.asarray(euler_xyz_matrix(jnp.array([0.1, 0.2, 0.3])))
    tgt = src @ r_true.T
    src_o = np.concatenate([src, rng.normal(size=(10, 3)) * 100])
    tgt_o = np.concatenate([tgt, rng.normal(size=(10, 3)) * 100])
    w = np.concatenate([np.ones(50), np.zeros(10)])
    r, t = kabsch(
        jnp.asarray(src_o, jnp.float64),
        jnp.asarray(tgt_o, jnp.float64),
        jnp.asarray(w, jnp.float64),
    )
    np.testing.assert_allclose(np.asarray(r), r_true, atol=1e-9)
    np.testing.assert_allclose(np.asarray(t), np.zeros(3), atol=1e-9)


def test_kabsch_proper_rotation_under_reflection(rng):
    """Degenerate correspondences must still yield det(R) = +1."""
    src = random_cloud(rng, 30)
    tgt = src * np.array([-1.0, 1.0, 1.0])  # a reflection
    r, _ = kabsch(
        jnp.asarray(src, jnp.float64),
        jnp.asarray(tgt, jnp.float64),
        jnp.ones(30, jnp.float64),
    )
    assert np.linalg.det(np.asarray(r)) > 0.99


def test_icp_recovers_small_rigid_transform(rng):
    src = random_cloud(rng, 400).astype(np.float32)
    r_true = np.asarray(euler_xyz_matrix(jnp.array([0.1, -0.15, 0.08])), np.float32)
    t_true = np.array([0.05, -0.02, 0.1], np.float32)
    tgt = src @ r_true.T + t_true
    res = icp(
        jnp.asarray(src),
        jnp.ones(400, bool),
        jnp.asarray(tgt),
        jnp.ones(400, bool),
        _params(),
    )
    aligned = src @ np.asarray(res.rotation).T + np.asarray(res.translation)
    assert float(res.fitness) < 1e-6  # f32 noise floor
    np.testing.assert_allclose(aligned, tgt, atol=1e-3)


def test_icp_with_padding_matches_unpadded(rng):
    src = random_cloud(rng, 200).astype(np.float32)
    r_true = np.asarray(euler_xyz_matrix(jnp.array([0.05, 0.1, -0.07])), np.float32)
    tgt = (src @ r_true.T).astype(np.float32)

    res_u = icp(
        jnp.asarray(src), jnp.ones(200, bool), jnp.asarray(tgt), jnp.ones(200, bool),
        _params(),
    )
    pad_src = np.concatenate([src, np.full((56, 3), 9.0, np.float32)])
    pad_tgt = np.concatenate([tgt, np.full((56, 3), -9.0, np.float32)])
    smask = np.arange(256) < 200
    res_p = icp(
        jnp.asarray(pad_src), jnp.asarray(smask), jnp.asarray(pad_tgt),
        jnp.asarray(smask), _params(),
    )
    np.testing.assert_allclose(
        np.asarray(res_p.rotation), np.asarray(res_u.rotation), atol=1e-5
    )
    np.testing.assert_allclose(float(res_p.fitness), float(res_u.fitness), atol=1e-7)


def test_icp_vmapped_multistart(rng):
    """Batched multi-start: the candidate starting nearest the truth wins."""
    src = random_cloud(rng, 300).astype(np.float32)
    r_true = np.asarray(euler_xyz_matrix(jnp.array([0.12, 0.0, 0.0])), np.float32)
    tgt = src @ r_true.T

    starts = jnp.asarray(
        np.stack([src, src @ np.asarray(
            euler_xyz_matrix(jnp.array([np.pi, 0.0, 0.0])), np.float32).T])
    )
    res = jax.vmap(icp, in_axes=(0, None, None, None, None))(
        starts, jnp.ones(300, bool), jnp.asarray(tgt), jnp.ones(300, bool), _params()
    )
    fits = np.asarray(res.fitness)
    assert fits[0] < 1e-6  # near-identity start converges
    assert fits.shape == (2,)


def test_point_to_plane_recovers_transform(rng):
    """Chen & Medioni variant: converges on a smooth surface and matches the
    known rigid transform (opt-in improvement, not in the reference)."""
    import jax.numpy as jnp

    from kss_icp.config import KSSICPConfig
    from kss_icp.models.icp import ICPParams, icp
    from kss_icp.ops.normals import estimate_normals
    from helpers import random_cloud

    tgt = random_cloud(rng, 600).astype(np.float32)
    ang = 0.25
    c, s = np.cos(ang), np.sin(ang)
    r_true = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    src = tgt @ r_true.T + np.array([0.04, -0.03, 0.02], np.float32)
    mask = jnp.ones((600,), bool)
    normals = estimate_normals(jnp.asarray(tgt), mask)

    params = ICPParams.from_config(KSSICPConfig(max_icp_iterations=80))
    res = icp(jnp.asarray(src), mask, jnp.asarray(tgt), mask, params,
              variant="point_to_plane", target_normals=normals)
    np.testing.assert_allclose(np.asarray(res.rotation) @ r_true,
                               np.eye(3), atol=5e-3)
    assert float(res.fitness) < 1e-5


def test_pipeline_point_to_plane_variant(rng):
    import dataclasses

    import jax.numpy as jnp

    from kss_icp.config import KSSICPConfig
    from kss_icp.core.transforms import apply_similarity, euler_xyz_matrix
    from kss_icp.metrics import registration_measure
    from kss_icp.models.kss_icp import register_pair
    from helpers import random_cloud

    tgt = random_cloud(rng, 800)
    r = np.asarray(euler_xyz_matrix(jnp.array([1.2, 0.4, 2.0])))
    src = tgt @ r
    cfg = KSSICPConfig(rotation_steps=8, max_candidates=8,
                       max_resample_points=256, resample_pad=256,
                       max_icp_iterations=100, icp_variant="point_to_plane")
    res = register_pair(src, tgt, cfg)
    aligned = np.asarray(apply_similarity(res.transform, jnp.asarray(src, jnp.float32)))
    m = registration_measure(aligned, tgt.astype(np.float32))
    assert m["rmse"] < 0.02, m

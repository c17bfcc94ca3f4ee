"""Tests for the CPU oracle (kss_icp/oracle.py) and its agreement with
the JAX pipeline's building blocks.

The oracle is the measured-baseline generator (scripts/measure_baseline.py,
VERDICT round-1 item #1): a faithful numpy/scipy replica of the reference
pipeline. These tests pin (a) its internal contracts, (b) its agreement with
the production JAX components on shared math, and (c) end-to-end recovery of
a known transform — the transfer.txt protocol (SURVEY.md §4.2).
"""

import numpy as np
import pytest

from kss_icp.oracle import (
    OracleInitRegistration,
    _axis_rotate,
    aivs_simplify,
    estimate_box_scale,
    pcl_icp,
    pcr_qm,
    register_pair_oracle,
)


def _wavy(n, seed=0):
    rng = np.random.default_rng(seed)
    u = rng.uniform(-1, 1, n)
    v = rng.uniform(-1, 1, n)
    return np.stack([u, v, 0.3 * np.sin(3 * u) * np.cos(2 * v)], -1)


def test_box_scale_ladder():
    # ballRegionCompute.hpp:1194-1214
    assert estimate_box_scale(5_000) == 10
    assert estimate_box_scale(20_000) == 20
    assert estimate_box_scale(99_999) == 30
    assert estimate_box_scale(400_000) == 40
    assert estimate_box_scale(900_000) == 50
    # int-truncated cbrt, like the reference's (int)pow(n/8, 1/3):
    # cbrt(1e6) computes as 99.999... in binary floating point -> 99.
    assert estimate_box_scale(8_000_000) == 99


def test_aivs_exact_count_and_subset():
    pts = _wavy(3000)
    out = aivs_simplify(pts, 500)
    assert out.shape == (500, 3)
    # Every sample is an input point (AIVS selects, never synthesizes).
    d = np.abs(out[:, None, :] - pts[None, :500 * 6, :]).sum(-1)
    # (subset check against the full cloud, chunked to bound memory)
    tree_hits = 0
    from scipy.spatial import cKDTree

    dist, _ = cKDTree(pts).query(out)
    assert float(dist.max()) == 0.0
    del d, tree_hits


def test_pcl_icp_recovers_small_rigid():
    src = _wavy(800, seed=1)
    ang = 0.15
    c, s = np.cos(ang), np.sin(ang)
    r = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
    tgt = src @ r.T + np.array([0.02, -0.01, 0.03])
    res = pcl_icp(src, tgt)
    assert res.converged
    assert res.fitness < 1e-6
    np.testing.assert_allclose(res.transformation[:3, :3], r, atol=1e-4)


def test_oracle_axis_rotations_match_jax_euler():
    # Oracle applies X then Y then Z (initRegistrationKSS.hpp:86-88); the
    # production euler_xyz_matrix encodes the same composition.
    import jax.numpy as jnp

    from kss_icp.core.transforms import euler_xyz_matrix

    pts = _wavy(100, seed=2)
    ang = np.array([0.3, 1.1, 2.2])
    ref = _axis_rotate(3, ang[2], _axis_rotate(2, ang[1], _axis_rotate(1, ang[0], pts)))
    ours = np.asarray(pts @ np.asarray(euler_xyz_matrix(jnp.asarray(ang)), np.float64).T)
    np.testing.assert_allclose(ref, ours, atol=1e-5)


def test_oracle_middle_align_matches_preshape():
    import jax.numpy as jnp

    from kss_icp.core.preshape import middle_align

    src = _wavy(300, seed=3) * 2.0 + 0.5
    tgt = _wavy(400, seed=4)
    ir = OracleInitRegistration.__new__(OracleInitRegistration)
    ir.source, ir.target, ir.step = src, tgt, 2.0  # tiny grid: cheap scan
    ir.__post_init__()
    sim, _, scale = middle_align(
        jnp.asarray(src, jnp.float32), jnp.ones(len(src), bool),
        jnp.asarray(tgt, jnp.float32), jnp.ones(len(tgt), bool),
    )
    assert abs(float(scale) - ir.scale) < 1e-4
    aligned = np.asarray(src) * ir.scale + (ir.middle_s - ir.scale * src.mean(0))
    np.testing.assert_allclose(ir.point_source, aligned, atol=1e-9)


def test_oracle_end_to_end_recovers_transfer():
    # transfer.txt protocol: known axis rotation + scale + shift must be
    # recovered (SURVEY.md §4.2, transferPC.hpp:66-130).
    tgt = _wavy(1200, seed=5)
    ang = 1.56
    src = _axis_rotate(1, ang, tgt * 1.3) + np.array([0.2, -0.1, 0.05])
    res = register_pair_oracle(src, tgt)
    m = pcr_qm(res.aligned, tgt)
    assert m["rmse"] < 0.05, m
    assert res.num_candidates >= 1


def test_oracle_and_pipeline_agree_on_golden_shape():
    # The oracle and the production pipeline must land in the same basin on
    # an easy pair: same data, both should reach RMSE < 0.05.
    from kss_icp.config import KSSICPConfig
    from kss_icp.core.transforms import apply_similarity
    from kss_icp.models.kss_icp import register_pair

    tgt = _wavy(1000, seed=6)
    src = _axis_rotate(2, 0.9, tgt)
    o = register_pair_oracle(src, tgt)
    om = pcr_qm(o.aligned, tgt)

    cfg = KSSICPConfig(max_candidates=8, coarse_points=512, refine_candidates=2)
    r = register_pair(src.astype(np.float32), tgt.astype(np.float32), cfg)
    aligned = np.asarray(apply_similarity(r.transform, np.asarray(src, np.float32)))
    pm = pcr_qm(aligned, tgt)
    assert om["rmse"] < 0.05
    assert pm["rmse"] < 0.05
    # Ours must not be dramatically worse than the faithful replica.
    assert pm["rmse"] < max(2.0 * om["rmse"], 0.03)

"""End-to-end registration: recover synthetic similarity transforms
(the reference's known-transform protocol, SURVEY.md §4.2) and run the
bundled golden pairs."""

import jax.numpy as jnp
import numpy as np
import pytest

from kss_icp.config import KSSICPConfig
from kss_icp.core.transforms import apply_similarity, euler_xyz_matrix
from kss_icp.io.formats import load_points
from kss_icp.metrics import registration_measure
from kss_icp.models.kss_icp import register_pair
from helpers import random_cloud

# Small, fast config for synthetic tests.
FAST = KSSICPConfig(
    rotation_steps=8,
    max_candidates=8,
    max_resample_points=256,
    resample_pad=256,
    max_icp_iterations=100,
    rotation_chunk=64,
)


def _register_and_measure(src, tgt, cfg):
    res = register_pair(src, tgt, cfg)
    aligned = np.asarray(
        apply_similarity(res.transform, jnp.asarray(src, jnp.float32))
    )
    return res, registration_measure(aligned, tgt.astype(np.float32))


def test_recover_axis_rotation(rng):
    """The transfer.txt protocol: a pure axis rotation (e.g. 'ant x:1.56')."""
    tgt = random_cloud(rng, 800)
    r = np.asarray(euler_xyz_matrix(jnp.array([1.56, 0.0, 0.0])))
    src = tgt @ r  # rotate target by R^T to make the source
    res, m = _register_and_measure(src, tgt, FAST)
    assert m["rmse"] < 0.02, m


def test_recover_similarity_transform(rng):
    """Rotation + scale + translation (registration_scale protocol)."""
    tgt = random_cloud(rng, 1000)
    r = np.asarray(euler_xyz_matrix(jnp.array([0.9, 2.2, 0.4])))
    src = (tgt @ r) * 0.35 + np.array([2.0, -1.0, 3.0])
    res, m = _register_and_measure(src, tgt, FAST)
    assert m["rmse"] < 0.02, m
    # The recovered scale must invert the synthetic shrink.
    np.testing.assert_allclose(float(res.transform.scale), 1 / 0.35, rtol=0.05)


def test_identity_pair_is_near_zero_error(rng):
    tgt = random_cloud(rng, 500)
    res, m = _register_and_measure(tgt.copy(), tgt, FAST)
    assert m["rmse"] < 1e-2, m


def test_register_pair_different_sizes(rng):
    tgt = random_cloud(rng, 900)
    perm = rng.permutation(900)[:600]
    r = np.asarray(euler_xyz_matrix(jnp.array([0.0, 1.1, 0.0])))
    src = tgt[perm] @ r
    res, m = _register_and_measure(src, tgt, FAST)
    assert m["rmse"] < 0.05, m


@pytest.mark.parametrize("model,axis_angle", [("Bunny", ("x", 1.1)), ("Cat", ("y", 1.56))])
def test_bundled_golden_pair(reference_data_dir, model, axis_angle):
    """Golden fixtures: .gird clouds + transfer.txt recorded transforms.

    The .gird/.wlop pairs on disk are *already* related by the recorded
    synthetic rotation; registering source=.gird onto target=.wlop must
    bring RMSE well under the cloud radius (reference success list ICP.txt
    includes Bunny and Cat)."""
    gird = load_points(reference_data_dir / "registration" / f"{model}.gird")
    wlop = load_points(reference_data_dir / "registration" / f"{model}.wlop")
    cfg = KSSICPConfig(max_resample_points=1000, resample_pad=1024,
                       max_icp_iterations=200, max_candidates=16)
    res, m = _register_and_measure(gird, wlop, cfg)
    # Clouds are unit-scale ([-1,1]^3); success = sub-1% RMSE.
    assert m["rmse"] < 0.05, (model, m)


def test_two_phase_matches_full_multistart(rng):
    """The two-phase screen+refine multi-start must land on the same
    alignment quality as the reference-shaped full multi-start."""
    import dataclasses

    tgt = random_cloud(rng, 900)
    r = np.asarray(euler_xyz_matrix(jnp.array([2.8, 0.6, 1.9])))
    src = (tgt @ r) * 0.6 + 1.0
    cfg2 = dataclasses.replace(FAST, multistart_mode="two_phase",
                               screen_points=128, screen_iterations=15,
                               refine_candidates=4)
    cfgf = dataclasses.replace(FAST, multistart_mode="full")
    _, m2 = _register_and_measure(src, tgt, cfg2)
    _, mf = _register_and_measure(src, tgt, cfgf)
    assert m2["rmse"] < 0.02, m2
    assert abs(m2["rmse"] - mf["rmse"]) < 0.01, (m2, mf)


def test_tiered_refine_matches_untied(rng):
    """Resolution-tiered two-tier refine (capped lanes rank on a target
    FPS-prefix, winner converges on the full target) must land on the same
    alignment quality as the untiered refine."""
    import dataclasses

    tgt = random_cloud(rng, 900)
    r = np.asarray(euler_xyz_matrix(jnp.array([0.9, 2.1, 0.4])))
    src = (tgt @ r) * 1.4 - 0.5
    base = dataclasses.replace(FAST, multistart_mode="two_phase",
                               screen_points=128, screen_iterations=15,
                               refine_candidates=3)
    tiered = dataclasses.replace(base, refine_tier_iterations=10,
                                 refine_tier_target_points=128)
    _, m0 = _register_and_measure(src, tgt, base)
    _, mt = _register_and_measure(src, tgt, tiered)
    assert mt["rmse"] < 0.02, mt
    assert abs(mt["rmse"] - m0["rmse"]) < 0.01, (mt, m0)


@pytest.mark.parametrize("model", ["ant", "Cat"])
def test_bundled_pair_recovers_recorded_rotation(reference_data_dir, model):
    """The full known-transform protocol on the bundled data: the .gird cloud
    was perturbed by the rotation recorded in transfer.txt ("ant x:1.56",
    "Cat y:1.56"); registering it onto the .wlop target must recover the
    inverse rotation (trace-angle residual < 10 deg)."""
    from kss_icp.transfer import axis_rotation_matrix, load_transfer_log

    recs = {r.name: r for r in load_transfer_log(
        reference_data_dir / "registration" / "transfer.txt")}
    rec = recs[model]
    gird = load_points(reference_data_dir / "registration" / f"{model}.gird")
    wlop = load_points(reference_data_dir / "registration" / f"{model}.wlop")
    cfg = KSSICPConfig(max_resample_points=1000, resample_pad=1024,
                       max_icp_iterations=200, max_candidates=16)
    res = register_pair(gird, wlop, cfg)
    r_rec = np.asarray(res.transform.rotation, np.float64)
    resid = r_rec @ axis_rotation_matrix(rec.axis, rec.angle)
    cos_angle = np.clip((np.trace(resid) - 1.0) / 2.0, -1.0, 1.0)
    assert np.degrees(np.arccos(cos_angle)) < 10.0, (model, resid)
    # And the recovered scale is ~1 (pure rotation in the bundled set).
    np.testing.assert_allclose(float(res.transform.scale), 1.0, rtol=0.05)


def test_pose_tiebreak_select_prefers_true_pose():
    """Symmetric-pose tie-break (VERDICT r3 item 3): on a cylinder with one
    symmetry-breaking bump, the TRUE pose carries uniform moderate error
    (ICP run-to-run noise analogue) while the 180-degree-slid pose carries
    small error everywhere EXCEPT a large localized bump mismatch — equal
    means, different tails. This fixture is pinned in the regime where
    argmin(fitness) picks the SLID pose (fitness ratio 1.03) but the
    0.95-quantile NN distance picks the TRUE one."""
    import jax.numpy as jnp

    from kss_icp.config import KSSICPConfig
    from kss_icp.models.kss_icp import _pose_tiebreak_select
    from kss_icp.ops.nn import masked_mean_nn_sqdist

    r0 = np.random.default_rng(0)
    n = 1200
    th = r0.uniform(0, 2 * np.pi, n)
    z = r0.uniform(-1, 1, n)
    pts = np.stack([np.cos(th), np.sin(th), z], -1)
    # bump: small radial bulge near theta=pi (wrapped), z=0.5
    w = np.exp(-((np.mod(th + np.pi, 2 * np.pi) - np.pi) ** 2 / 0.05
                 + (z - 0.5) ** 2 / 0.025))
    tgt = (pts * (1 + 0.035 * w[:, None])).astype(np.float32)
    rot = np.array([[-1, 0, 0], [0, -1, 0], [0, 0, 1]], np.float32)

    r1 = np.random.default_rng(1)
    true_c = tgt + r1.normal(scale=0.045, size=tgt.shape).astype(np.float32)
    slid_c = (tgt + r1.normal(scale=0.012, size=tgt.shape).astype(np.float32)) @ rot.T
    cand = np.stack([true_c, slid_c])
    mask = jnp.ones(n, bool)
    tgt_j = jnp.asarray(tgt)

    fits = jnp.stack([
        masked_mean_nn_sqdist(jnp.asarray(cand[k]), mask, tgt_j, mask)
        for k in range(2)])
    # Premise: plain argmin picks the WRONG (slid) pose, and the tie is
    # within the escalation tier's 12% margin.
    assert int(jnp.argmin(fits)) == 1
    assert float(jnp.max(fits) / jnp.min(fits)) < 1.12

    cfg = KSSICPConfig(pose_tiebreak_margin=0.12)
    pick = _pose_tiebreak_select(
        fits, jnp.asarray(cand), mask, tgt_j, mask, cfg)
    assert int(pick) == 0  # the true pose, against argmin(fit)


def test_overlap_gate_ratio_signature(rng):
    """The crop-signature gate's premise (r4): the pairs that sit above
    the escalation trigger WITHOUT being partial are density-mismatched
    remesh pairs (sparse .gird source vs dense .wlop target) — their
    reverse NN direction carries its own large floor, so bidirectional
    trimmed / standard fitness lands >= ~1 (measured 1.19-1.24 on the
    serving corpus); a partial pair's crop tail pushes it well below
    (measured 0.41-0.97)."""
    import jax.numpy as jnp

    from kss_icp.core.transforms import Similarity
    from kss_icp.models.kss_icp import trimmed_fitness
    from kss_icp.ops.nn import masked_mean_nn_sqdist

    t = rng.uniform(-1, 1, (1200, 2))
    surf = np.concatenate(
        [t, 0.4 * np.sin(2 * t[:, :1]) * np.cos(t[:, 1:2])], -1
    ).astype(np.float32)
    ident = Similarity.identity()

    def ratio(src, tgt):
        spj, tpj = jnp.asarray(src), jnp.asarray(tgt)
        smj = jnp.ones(len(src), bool)
        tmj = jnp.ones(len(tgt), bool)
        tf = float(trimmed_fitness(ident, spj, smj, tpj, tmj, 0.7))
        fit = float(masked_mean_nn_sqdist(spj, smj, tpj, tmj))
        return tf / fit

    # full overlap, density-mismatched (the real floor-pair shape):
    # sparse independent sampling of the same surface as source
    t2 = rng.uniform(-1, 1, (400, 2))
    sparse = np.concatenate(
        [t2, 0.4 * np.sin(2 * t2[:, :1]) * np.cos(t2[:, 1:2])], -1
    ).astype(np.float32)
    r_full = ratio(sparse, surf)

    # partial: equal density, a 30% crop's worth of off-surface points
    t3 = rng.uniform(-1, 1, (1200, 2))
    src_part = np.concatenate(
        [t3, 0.4 * np.sin(2 * t3[:, :1]) * np.cos(t3[:, 1:2])], -1
    ).astype(np.float32)
    src_part[:360] += np.array([0, 0, 0.35], np.float32)
    r_part = ratio(src_part, surf)

    assert r_full > 1.0, r_full
    assert r_part < 0.6, r_part
    assert r_part < r_full * 0.6  # the gate has real separation

"""Procedural category-level challenge corpus (kss_icp/challenge.py) —
the ModelNet40/SHREC/RGB-D analogue the reference claims but does not ship
(README.md:9, Examples/{modelNet40,shrec,RGB3D}.pdf). The full sweep runs
in scripts/challenge_test.py; here: corpus contract, determinism, the
symmetry-breaking warp, and a reduced-budget registration subset."""

import numpy as np
import pytest
from scipy.spatial import cKDTree

from kss_icp.challenge import (
    FAMILIES,
    _instance,
    category_corpus,
    challenge_corpus,
    deform_corpus,
    partial_corpus,
    transform_rmse,
    truth_aligned,
)
from kss_icp.config import KSSICPConfig


def test_corpus_shapes_and_determinism():
    cat = category_corpus(instances=2, n_points=2000)
    assert len(cat) == 4 * 2
    cat2 = category_corpus(instances=2, n_points=2000)
    for (n1, s1, t1, g1), (n2, s2, t2, g2) in zip(cat, cat2):
        assert n1 == n2
        np.testing.assert_array_equal(s1, s2)
        np.testing.assert_array_equal(t1, t2)
    for name, src, tgt, gt in cat:
        assert src.shape == (2000, 3) and tgt.shape == (2000, 3)
        assert src.dtype == np.float32
        # Ground truth maps the source back onto the instance surface.
        ta = truth_aligned(src, gt)
        assert np.abs(ta).max() <= 1.0 + 1e-4


def test_samples_share_shape_not_points():
    for f in range(len(FAMILIES)):
        a = _instance(f, 0, 2000, sample=0)
        b = _instance(f, 0, 2000, sample=1)
        assert np.abs(a - b).max() > 0.01  # independent point draws
        d, _ = cKDTree(a).query(b)  # ...of the SAME surface
        assert d.mean() < 0.06, (f, d.mean())


def test_partial_and_deform_contracts():
    part = partial_corpus(n_points=2000, keep=0.8)
    for name, src, tgt, gt in part:
        # Each side keeps ~80% (+1% outliers on the target).
        assert 1500 <= len(src) <= 1700
        assert 1500 <= len(tgt) <= 1700
    dfm = deform_corpus(n_points=2000, amplitude=0.04)
    for name, src, tgt, gt in dfm:
        # The deformation moves the target < ~3x amplitude off the surface.
        base = _instance([f for f, (nm, _) in enumerate(FAMILIES)
                          if name.split("/")[1][:-1] == nm][0],
                         int(name[-1]), 2000, sample=0)
        d, _ = cKDTree(base).query(tgt)
        assert d.max() < 0.15


def test_transform_rmse_zero_for_truth():
    name, src, tgt, gt = category_corpus(instances=1, n_points=512)[0]
    assert transform_rmse(truth_aligned(src, gt), src, gt) < 1e-6


def test_scenarios_registry():
    scen = challenge_corpus()
    assert [s[0] for s in scen] == ["category", "partial", "deform", "scale"]
    assert all(len(s[1]) > 0 for s in scen)


@pytest.mark.slow
def test_category_subset_registers_with_identifiable_pose():
    """The symmetry-breaking warp makes the pose identifiable: a
    reduced-budget solve must recover the ground-truth similarity (pose
    error, not just surface RMSE) on one instance of each family."""
    from kss_icp.core.transforms import apply_similarity
    from kss_icp.parallel.batch import register_many
    import jax

    corpus = category_corpus(instances=1, n_points=2000)
    cfg = KSSICPConfig(
        max_candidates=8, coarse_points=256, refine_candidates=2,
        max_resample_points=512, resample_pad=512, screen_points=256,
        max_icp_iterations=200, escalate_rotation_steps=12,
    )
    res, _ = register_many([(s, t) for _, s, t, _ in corpus], cfg,
                           full_pad=2048)
    for i, (name, src, _t, gt) in enumerate(corpus):
        tr = jax.tree.map(lambda x: x[i], res.transform)
        rec = np.asarray(apply_similarity(tr, np.asarray(src, np.float32)))
        err = transform_rmse(rec, src, gt)
        # 512-point working resolution: pose recovers to ~the sampling
        # density (~0.1 here); symmetric-slide failures sit at 0.25-1.8.
        assert err < 0.15, (name, err)

"""The wider accuracy corpus: perturbed Remesh/Advancing OFF models
(kss_icp/stress.py remesh_corpus).

protocol="transfer" (the benchmark corpus, VERDICT round-2 item #4) loads
committed fixtures built through the REAL TransferPC resampling protocol —
target = WLOP(8000), source = grid-simplify(radius/1.5) perturbed
(transferPC.hpp:144-151) — so source and target come from different
samplers like the reference's own .gird/.wlop pairs. protocol="halves" is
the legacy identically-distributed pairing. The full 25-pair sweep runs on
the GPU inside chip_smoke.py; here a subset registers on the CPU test mesh with a
reduced-budget config to pin the corpus contract and recoverability.
"""

from pathlib import Path

import numpy as np
import pytest

from kss_icp.config import KSSICPConfig
from kss_icp.stress import FIXTURE_NPZ, REMESH, remesh_corpus


@pytest.mark.skipif(not FIXTURE_NPZ.exists(), reason="fixtures not generated")
def test_remesh_transfer_corpus_shape():
    corpus = remesh_corpus()
    assert len(corpus) == 25
    names = [c[0] for c in corpus]
    assert len(set(names)) == 25
    corpus2 = remesh_corpus()  # deterministic: fixtures load bit-identically
    np.testing.assert_array_equal(corpus[3][1], corpus2[3][1])
    for name, src, tgt, rec in corpus:
        # Cross-sampler pairing: grid source is sparser than the WLOP target.
        assert 256 <= len(src) < len(tgt) <= 8000
        # WLOP repulsion can push samples slightly past the [-1,1]^3 input box.
        assert np.abs(tgt).max() <= 1.05
        assert {"axis", "angle", "scale", "translation"} <= set(rec)


def test_remesh_halves_corpus_shape():
    if not Path(REMESH).exists():
        pytest.skip("reference Remesh data not present")
    corpus = remesh_corpus(protocol="halves")
    assert len(corpus) == 25
    for name, src, tgt, rec in corpus:
        assert abs(len(src) - len(tgt)) <= 1
        assert np.abs(tgt).max() <= 1.0 + 1e-6


@pytest.mark.skipif(not FIXTURE_NPZ.exists(), reason="fixtures not generated")
def test_remesh_transfer_subset_registers():
    corpus = remesh_corpus()
    subset = [corpus[i] for i in (0, 5, 12, 21)]  # mixed axes/scales/shifts

    from kss_icp.parallel.batch import register_many

    cfg = KSSICPConfig(
        max_candidates=8, coarse_points=256, refine_candidates=2,
        max_resample_points=512, resample_pad=512, screen_points=256,
        max_icp_iterations=200,
        escalate_rotation_steps=12,
    )
    pairs = [(src, tgt) for _, src, tgt, _ in subset]
    res, metrics = register_many(pairs, cfg, full_pad=8192)
    # RMSE floor at <=512-point working resolution on unit-scale clouds is
    # ~0.01-0.05 for the cross-sampler pairing; failures sit at 0.1+.
    assert (metrics["rmse"] < 0.08).all(), metrics["rmse"]

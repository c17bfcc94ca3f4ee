"""Accuracy parity vs the measured reference baseline (BASELINE_ORACLE.json).

The oracle numbers are recorded by scripts/measure_baseline.py (faithful
numpy/scipy replica of the reference pipeline — protocol
registrationMeasure.hpp:47-98). This test batch-registers ALL 23 golden
pairs with the production pipeline at the bench config in one jitted call
and asserts, per pair, that RMSE does not drift above the oracle's beyond
the measured multi-start noise band, plus the corpus-median bound — the
full parity table from BASELINE.md enforced in CI (VERDICT round-2 item #3:
drift on ANY pair fails pytest, not just Cat/woodMan).
"""

import json
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
ORACLE = REPO / "BASELINE_ORACLE.json"
DATA = Path("/root/reference/PS_AIS_Simplification/data/registration")

pytestmark = pytest.mark.skipif(
    not (ORACLE.exists() and DATA.exists()),
    reason="oracle baseline or reference data not present",
)

# Multi-start basin noise measured at ±0.005 across runs (BASELINE.md);
# anything beyond oracle + NOISE_BAND is a real accuracy regression.
NOISE_BAND = 0.006
MEDIAN_BOUND = 0.0140


@pytest.mark.slow
def test_all_golden_pairs_within_oracle_band():
    import sys

    from kss_icp.parallel.batch import register_many
    from kss_icp.stress import golden_corpus

    sys.path.insert(0, str(REPO))
    from bench import bench_config  # the SHIPPING config — never a copy

    oracle = json.loads(ORACLE.read_text())["pairs"]
    corpus = golden_corpus()
    assert len(corpus) == 23 and set(n for n, _, _ in corpus) == set(oracle)

    _, metrics = register_many([(s, t) for _, s, t in corpus], bench_config())

    failures = []
    for i, (name, _, _) in enumerate(corpus):
        ours, ref = float(metrics["rmse"][i]), oracle[name]["rmse"]
        if ours > ref + NOISE_BAND:
            failures.append(f"{name}: ours {ours:.5f} > oracle {ref:.5f} + {NOISE_BAND}")
    assert not failures, failures
    median = float(np.median(metrics["rmse"]))
    assert median <= MEDIAN_BOUND, median

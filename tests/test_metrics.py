"""PCR_QM metric contract (registrationMeasure.hpp:47-98)."""

import numpy as np

from kss_icp.metrics import registration_measure
from helpers import random_cloud


def brute_pcr_qm(aligned, target):
    d2 = ((aligned[:, None] - target[None]) ** 2).sum(-1).min(1)
    mse = d2.mean()
    return {"mse": mse, "rmse": np.sqrt(mse), "mae": np.sqrt(d2).mean()}


def test_metric_oracle(rng):
    a = random_cloud(rng, 300)
    t = random_cloud(rng, 400)
    got = registration_measure(a, t)
    expected = brute_pcr_qm(a, t)
    for k in ("mse", "rmse", "mae"):
        np.testing.assert_allclose(got[k], expected[k], rtol=1e-4)


def test_metric_zero_for_identical(rng):
    a = random_cloud(rng, 100)
    got = registration_measure(a, a.copy())
    assert got["mse"] < 1e-10
    assert got["mae"] < 1e-5


def test_metric_chunked_consistency(rng):
    a = random_cloud(rng, 512)
    t = random_cloud(rng, 300)
    g1 = registration_measure(a, t, chunk=None)
    g2 = registration_measure(a, t, chunk=128)
    np.testing.assert_allclose(g1["mse"], g2["mse"], rtol=1e-6)

"""simMeasurement-equivalent: displacement of originals onto the simplified
surface proxy."""

import jax.numpy as jnp
import numpy as np

from kss_icp.measure_resample import simplification_measure
from kss_icp.ops.resample import fps_points
from helpers import random_cloud


def test_identity_simplification_small_error(rng):
    """Identity 'simplification' leaves only the MLS smoothing residual,
    which must be far below the cloud scale (~2 here)."""
    pts = random_cloud(rng, 400).astype(np.float32)
    m = simplification_measure(
        jnp.asarray(pts), jnp.ones(400, bool), jnp.asarray(pts), jnp.ones(400, bool)
    )
    # MLS smoothing with the reference's global max-12-NN support radius
    # leaves a ~2% residual on this curvy fixture.
    assert float(m["avg_displacement"]) < 0.06
    assert abs(float(m["sampling_rate"]) - 1.0) < 1e-6


def test_denser_simplification_is_better(rng):
    pts = random_cloud(rng, 2000).astype(np.float32)
    mask = jnp.ones(2000, bool)
    s64, m64 = fps_points(jnp.asarray(pts), mask, 64)
    s512, m512 = fps_points(jnp.asarray(pts), mask, 512)
    e64 = simplification_measure(jnp.asarray(pts), mask, s64, m64)
    e512 = simplification_measure(jnp.asarray(pts), mask, s512, m512)
    assert float(e512["avg_displacement"]) < float(e64["avg_displacement"])
    np.testing.assert_allclose(float(e512["sampling_rate"]), 512 / 2000, rtol=1e-5)


def test_displacement_bounded_by_spacing(rng):
    pts = random_cloud(rng, 1000).astype(np.float32)
    mask = jnp.ones(1000, bool)
    s, sm = fps_points(jnp.asarray(pts), mask, 250)
    m = simplification_measure(jnp.asarray(pts), mask, s, sm)
    assert float(m["avg_displacement"]) < 0.1
    assert float(m["max_displacement"]) < 1.0

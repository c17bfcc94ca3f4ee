"""Kendall pre-shape normalization vs the reference's MiddleAlign semantics
(initRegistrationKSS.hpp:144-220)."""

import jax.numpy as jnp
import numpy as np

from kss_icp.core.preshape import masked_centroid, masked_mean_radius, middle_align
from kss_icp.core.transforms import apply_similarity


def reference_middle_align(src, tgt):
    """Literal restatement: translate by centroid diff, scale about target
    centroid by mean-radius ratio."""
    cs, ct = src.mean(0), tgt.mean(0)
    rs = np.linalg.norm(src - cs, axis=1).mean()
    rt = np.linalg.norm(tgt - ct, axis=1).mean()
    s = rt / rs
    moved = src + (ct - cs)
    return ct + (moved - ct) * s, s, ct


def test_masked_centroid(rng):
    pts = rng.normal(size=(50, 3))
    mask = np.zeros(50, bool)
    mask[:30] = True
    got = np.asarray(masked_centroid(jnp.asarray(pts), jnp.asarray(mask)))
    np.testing.assert_allclose(got, pts[:30].mean(0), atol=1e-12)


def test_masked_mean_radius(rng):
    pts = rng.normal(size=(40, 3))
    mask = np.ones(40, bool)
    c = pts.mean(0)
    got = float(
        masked_mean_radius(jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(c))
    )
    np.testing.assert_allclose(got, np.linalg.norm(pts - c, axis=1).mean(), rtol=1e-10)


def test_middle_align_matches_reference(rng):
    src = rng.normal(size=(60, 3)) * 0.5 + np.array([3.0, -1.0, 2.0])
    tgt = rng.normal(size=(80, 3)) * 2.0 + np.array([-2.0, 0.5, 1.0])
    sim, c_t, scale = middle_align(
        jnp.asarray(src), jnp.ones(60, bool), jnp.asarray(tgt), jnp.ones(80, bool)
    )
    expected, s_ref, ct_ref = reference_middle_align(src, tgt)
    got = np.asarray(apply_similarity(sim, jnp.asarray(src)))
    np.testing.assert_allclose(got, expected, atol=1e-9)
    np.testing.assert_allclose(float(scale), s_ref, rtol=1e-10)
    np.testing.assert_allclose(np.asarray(c_t), ct_ref, atol=1e-12)


def test_middle_align_padded_equals_unpadded(rng):
    src = rng.normal(size=(30, 3))
    tgt = rng.normal(size=(45, 3))
    pad_src = np.concatenate([src, np.full((10, 3), 77.0)], axis=0)
    pad_tgt = np.concatenate([tgt, np.full((5, 3), -55.0)], axis=0)
    smask = np.arange(40) < 30
    tmask = np.arange(50) < 45
    sim_p, _, _ = middle_align(
        jnp.asarray(pad_src), jnp.asarray(smask), jnp.asarray(pad_tgt), jnp.asarray(tmask)
    )
    sim_u, _, _ = middle_align(
        jnp.asarray(src), jnp.ones(30, bool), jnp.asarray(tgt), jnp.ones(45, bool)
    )
    np.testing.assert_allclose(float(sim_p.scale), float(sim_u.scale), rtol=1e-12)
    np.testing.assert_allclose(
        np.asarray(sim_p.translation), np.asarray(sim_u.translation), atol=1e-12
    )


def test_max_radius_scale_mode(rng):
    """The reference's commented-out max-length size variant
    (initRegistrationKSS.hpp:166-170)."""
    import jax.numpy as jnp

    from kss_icp.core.preshape import middle_align
    from kss_icp.core.transforms import apply_similarity
    from helpers import random_cloud

    tgt = random_cloud(rng, 300).astype(np.float32)
    src = (tgt * 0.25 + 1.0).astype(np.float32)
    mask = jnp.ones((300,), bool)
    sim, _, scale = middle_align(
        jnp.asarray(src), mask, jnp.asarray(tgt), mask, scale_mode="max_radius"
    )
    out = np.asarray(apply_similarity(sim, jnp.asarray(src)))
    # Max radius ratio of a scaled copy is exactly the scale factor, so the
    # alignment is exact.
    np.testing.assert_allclose(float(scale), 4.0, rtol=1e-4)
    np.testing.assert_allclose(out, tgt, atol=1e-4)

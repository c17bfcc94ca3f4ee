"""Exact-f32 1-NN kernel (ops/nn_triton.py) vs. float64 brute force and the
plain path, in Pallas interpret mode on CPU. The compiled kernel is compared
on the GPU by chip_smoke.py (phase "kernel nn")."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kss_icp.ops import nn as nn_mod
from kss_icp.ops import nn_triton
from kss_icp.ops.nn import nearest_neighbor
from kss_icp.ops.nn_triton import nearest_neighbor_kernel
from helpers import random_cloud


def _kernel(query, ref, mask):
    return nearest_neighbor_kernel(
        jnp.asarray(query, jnp.float32), jnp.asarray(ref, jnp.float32),
        jnp.asarray(mask), interpret=True)


def _brute(query, ref, mask):
    d = ((np.asarray(query, np.float64)[:, None]
          - np.asarray(ref, np.float64)[None]) ** 2).sum(-1)
    d[:, ~np.asarray(mask)] = np.inf
    return d.min(1), d.argmin(1)


def test_matches_float64_brute_force(rng):
    q = random_cloud(rng, 300).astype(np.float32)
    r = random_cloud(rng, 500).astype(np.float32)
    mask = np.ones((500,), bool)
    d2, idx = _kernel(q, r, mask)
    want_d2, want_idx = _brute(q, r, mask)
    np.testing.assert_allclose(np.asarray(d2), want_d2, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(idx), want_idx)


def test_respects_ref_mask(rng):
    q = random_cloud(rng, 64).astype(np.float32)
    r = np.concatenate([random_cloud(rng, 100), q[:10] + 1e-4]).astype(np.float32)
    mask = np.ones((110,), bool)
    mask[100:] = False  # the near-duplicates are invalid; must never win
    d2, idx = _kernel(q, r, mask)
    assert np.asarray(idx).max() < 100
    want_d2, want_idx = _brute(q, r, mask)
    np.testing.assert_allclose(np.asarray(d2), want_d2, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(idx), want_idx)


@pytest.mark.parametrize("q_n,r_n", [(137, 391), (1, 5), (65, 64)])
def test_non_tile_sizes(rng, q_n, r_n):
    q = random_cloud(rng, q_n).astype(np.float32)
    r = random_cloud(rng, r_n).astype(np.float32)
    mask = np.ones((r_n,), bool)
    d2, idx = _kernel(q, r, mask)
    assert d2.shape == (q_n,) and idx.shape == (q_n,)
    want_d2, want_idx = _brute(q, r, mask)
    np.testing.assert_allclose(np.asarray(d2), want_d2, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(idx), want_idx)


def test_running_min_across_reference_tiles(rng):
    # Several reference tiles; the true NN sits in the last one.
    q = np.zeros((8, 3), np.float32)
    r = random_cloud(rng, 512).astype(np.float32) + 5.0
    r[-1] = [0.01, 0.0, 0.0]
    d2, idx = _kernel(q, r, np.ones((512,), bool))  # 8 reference tiles
    np.testing.assert_array_equal(np.asarray(idx), 511)
    np.testing.assert_allclose(np.asarray(d2), 1e-4, rtol=1e-4)


def test_all_masked_reports_big(rng):
    q = random_cloud(rng, 16).astype(np.float32)
    r = random_cloud(rng, 32).astype(np.float32)
    d2, idx = _kernel(q, r, np.zeros((32,), bool))
    assert np.all(np.asarray(d2) >= 1e29)
    assert ((np.asarray(idx) >= 0) & (np.asarray(idx) < 32)).all()


def test_ties_resolve_to_first_index(rng):
    # Exact duplicates in different lanes and tiles: jnp.argmin semantics.
    base = random_cloud(rng, 70).astype(np.float32)
    r = np.concatenate([base, base, base])          # 210 rows, 3 copies
    q = base[::7] + np.float32(1e-3)
    d2, idx = _kernel(q, r, np.ones((210,), bool))
    d2_p, idx_p = nearest_neighbor(jnp.asarray(q), jnp.asarray(r),
                                   jnp.ones((210,), bool))
    assert (np.asarray(idx) < 70).all()
    np.testing.assert_array_equal(np.asarray(idx), np.asarray(idx_p))


def test_vmap_batches_lanes(rng):
    q = np.stack([random_cloud(rng, 40) for _ in range(6)]).astype(np.float32)
    q = q.reshape(2, 3, 40, 3)
    r = np.stack([random_cloud(rng, 90) for _ in range(2)]).astype(np.float32)
    mask = np.ones((2, 90), bool)
    mask[1, 60:] = False
    f = jax.vmap(jax.vmap(
        lambda a, b, c: nearest_neighbor_kernel(a, b, c, interpret=True),
        in_axes=(0, None, None)))
    d2, idx = f(jnp.asarray(q), jnp.asarray(r), jnp.asarray(mask))
    for i in range(2):
        for j in range(3):
            want_d2, want_idx = _brute(q[i, j], r[i], mask[i])
            np.testing.assert_allclose(np.asarray(d2[i, j]), want_d2, atol=1e-6)
            np.testing.assert_array_equal(np.asarray(idx[i, j]), want_idx)


def test_metric_contract(rng):
    """The metric built on the kernel's d2 equals the plain metric."""
    from kss_icp.metrics import registration_measure

    a = random_cloud(rng, 700)
    t = random_cloud(rng, 900)
    d2, _ = _kernel(a, t, np.ones((900,), bool))
    d2 = np.asarray(d2, np.float64)
    m = registration_measure(a, t)
    assert abs(m["mse"] - d2.mean()) < 1e-7
    assert abs(m["mae"] - np.sqrt(d2).mean()) < 1e-6


def test_broadcast_wrapper_matches_plain(rng, monkeypatch):
    """ops.nn's kernel branch: leading batch axes of the query, a shared or
    per-batch reference, outputs in the plain path's shapes."""
    monkeypatch.setattr(
        nn_triton, "nearest_neighbor_kernel",
        lambda q, r, m: nearest_neighbor_kernel(q, r, m, interpret=True))
    q = jnp.asarray(np.stack([random_cloud(rng, 30) for _ in range(4)]),
                    jnp.float32).reshape(2, 2, 30, 3)
    r1 = jnp.asarray(random_cloud(rng, 50)[None], jnp.float32)   # (1, R, 3)
    m1 = jnp.ones((1, 50), bool)
    d2, idx = nn_mod._nearest_neighbor_kernel(q, r1, m1)
    d2_p, idx_p = nearest_neighbor(q, r1, m1)
    assert d2.shape == d2_p.shape == (2, 2, 30)
    np.testing.assert_allclose(np.asarray(d2), np.asarray(d2_p), atol=1e-6)
    np.testing.assert_array_equal(np.asarray(idx), np.asarray(idx_p))
    r2 = jnp.asarray(np.stack([random_cloud(rng, 50) for _ in range(2)]),
                     jnp.float32)[:, None]                        # (2, 1, R, 3)
    m2 = jnp.ones((2, 1, 50), bool)
    d2, idx = nn_mod._nearest_neighbor_kernel(q, r2, m2)
    d2_p, idx_p = nearest_neighbor(q, r2, m2)
    np.testing.assert_allclose(np.asarray(d2), np.asarray(d2_p), atol=1e-6)
    np.testing.assert_array_equal(np.asarray(idx), np.asarray(idx_p))

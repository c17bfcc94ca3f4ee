"""Per-cloud FPS kernel (ops/resample_triton.py) vs. the plain fori_loop
path, in Pallas interpret mode on CPU. The compiled kernel is compared on
the GPU by chip_smoke.py (phase "kernel fps")."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kss_icp.ops.resample import farthest_point_sampling
from kss_icp.ops.resample_triton import MAX_POINTS, fps_batch, fps_fits
from helpers import random_cloud


def _plain(points, mask, s):
    f = jax.vmap(lambda p, m: farthest_point_sampling(p, m, s))
    return f(jnp.asarray(points), jnp.asarray(mask))


def _kernel(points, mask, s):
    return fps_batch(jnp.asarray(points, jnp.float32), jnp.asarray(mask), s,
                     interpret=True)


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("p,s", [(100, 40), (1000, 120), (8192, 24)])
def test_identical_indices_to_plain(rng, p, s, b):
    pts = np.stack([random_cloud(rng, p) for _ in range(b)]).astype(np.float32)
    mask = np.ones((b, p), bool)
    mask[-1, (3 * p) // 4:] = False  # last cloud shorter than the rest
    idx_k, sm_k = _kernel(pts, mask, s)
    idx_p, sm_p = _plain(pts, mask, s)
    np.testing.assert_array_equal(np.asarray(idx_k), np.asarray(idx_p))
    np.testing.assert_array_equal(np.asarray(sm_k), np.asarray(sm_p))


def test_fewer_points_than_samples(rng):
    b, p, s = 2, 64, 100
    pts = np.stack([random_cloud(rng, p) for _ in range(b)]).astype(np.float32)
    mask = np.ones((b, p), bool)
    mask[0, 40:] = False
    idx_k, sm_k = _kernel(pts, mask, s)
    idx_p, sm_p = _plain(pts, mask, s)
    np.testing.assert_array_equal(np.asarray(sm_k), np.asarray(sm_p))
    # The valid prefix matches; the tail is masked out.
    np.testing.assert_array_equal(np.asarray(idx_k)[0, :40],
                                  np.asarray(idx_p)[0, :40])
    np.testing.assert_array_equal(np.asarray(idx_k)[1], np.asarray(idx_p)[1])
    assert np.asarray(sm_k)[0].sum() == 40


def test_all_masked_row(rng):
    pts = np.stack([random_cloud(rng, 300) for _ in range(2)]).astype(np.float32)
    mask = np.ones((2, 300), bool)
    mask[1] = False
    idx_k, sm_k = _kernel(pts, mask, 50)
    idx_p, sm_p = _plain(pts, mask, 50)
    assert not np.asarray(sm_k)[1].any()
    np.testing.assert_array_equal(np.asarray(sm_k), np.asarray(sm_p))
    np.testing.assert_array_equal(np.asarray(idx_k)[0], np.asarray(idx_p)[0])
    assert ((np.asarray(idx_k) >= 0) & (np.asarray(idx_k) < 300)).all()


def test_shape_rule():
    assert fps_fits(MAX_POINTS)
    assert not fps_fits(MAX_POINTS + 1)
    with pytest.raises(ValueError):
        fps_batch(jnp.zeros((1, MAX_POINTS + 1, 3)),
                  jnp.ones((1, MAX_POINTS + 1), bool), 4, interpret=True)

"""The Pallas kernels as compiled for the card, not in interpret mode,
against their plain references. Marked gpu: they skip without a GPU. On
the card: python -m pytest -m gpu tests/"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kss_icp.ops.nn_triton import nearest_neighbor_kernel
from kss_icp.ops.resample import farthest_point_sampling
from kss_icp.ops.resample_triton import fps_batch
from helpers import random_cloud

pytestmark = pytest.mark.gpu


@pytest.fixture()
def gpu():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (python -m pytest -m gpu on the card)")
    return dev


def test_fps_kernel_compiled_matches_plain(gpu, rng):
    pts = np.stack([random_cloud(rng, 1000) for _ in range(3)]).astype(np.float32)
    mask = np.ones((3, 1000), bool)
    mask[2, 700:] = False
    idx_k, sm_k = fps_batch(jnp.asarray(pts), jnp.asarray(mask), 300)
    idx_p, sm_p = jax.vmap(lambda p, m: farthest_point_sampling(p, m, 300))(
        jnp.asarray(pts), jnp.asarray(mask))
    np.testing.assert_array_equal(np.asarray(idx_k), np.asarray(idx_p))
    np.testing.assert_array_equal(np.asarray(sm_k), np.asarray(sm_p))


def test_nn_kernel_compiled_matches_float64(gpu, rng):
    q = random_cloud(rng, 500).astype(np.float32)
    r = random_cloud(rng, 3000).astype(np.float32)
    mask = rng.random(3000) > 0.2
    d2, idx = nearest_neighbor_kernel(jnp.asarray(q), jnp.asarray(r),
                                      jnp.asarray(mask))
    d = ((q[:, None].astype(np.float64) - r[None]) ** 2).sum(-1)
    d[:, ~mask] = np.inf
    np.testing.assert_allclose(np.asarray(d2), d.min(1), atol=1e-6)
    picked = d[np.arange(500), np.asarray(idx)]
    assert np.all(picked - d.min(1) < 1e-6)

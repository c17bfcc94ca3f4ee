"""Kernel choice at lowering time (ops/dispatch.on_cuda) and the plain
path's precision.

The choice is made at lowering time, so it is checked here by lowering the
same traced program for CUDA and for the CPU (no GPU needed): every call
site of a kernel lowers to the Triton custom call for CUDA and to the plain
path for the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kss_icp.ops.dispatch import on_cuda
from kss_icp.ops.nn import nearest_neighbor, nearest_neighbor_plain
from helpers import random_cloud

TRITON = "__gpu$xla.gpu.triton"


def _lowered(fn, *args, platform):
    return jax.jit(fn).trace(*args).lower(
        lowering_platforms=(platform,)).as_text()


def _nn_args(q=64, r=200):
    return (jnp.zeros((q, 3), jnp.float32), jnp.zeros((r, 3), jnp.float32),
            jnp.ones((r,), bool))


def _icp(q, r, m):
    from kss_icp.config import DEFAULT_CONFIG
    from kss_icp.models.icp import ICPParams, icp

    params = ICPParams.from_config(DEFAULT_CONFIG)
    return icp(q, jnp.ones(q.shape[:1], bool), r, m, params).fitness


def _overlap(q, r, m):
    from kss_icp.core.transforms import Similarity
    from kss_icp.models.kss_icp import trimmed_fitness

    ident = Similarity(scale=jnp.ones(()), rotation=jnp.eye(3),
                       translation=jnp.zeros(3))
    return trimmed_fitness(ident, q, jnp.ones(q.shape[:1], bool), r, m, 0.7)


def _field(q, r, m):
    from kss_icp.models.coarse import score_rotation_field

    return score_rotation_field(q, jnp.ones(q.shape[:1], bool), r, m, steps=2)


def _metric(q, r, m):
    from kss_icp.metrics import registration_measure_padded

    return registration_measure_padded(q, jnp.ones(q.shape[:1], bool), r, m)


SITES = {"icp": _icp, "overlap": _overlap, "field": _field,
         "metric": _metric}


def test_on_cuda_picks_plain_off_cuda():
    x = jnp.arange(4.0)
    got = jax.jit(lambda a: on_cuda(lambda b: b + 1.0, lambda b: b + 2.0,
                                    a))(x)
    np.testing.assert_array_equal(np.asarray(got), np.arange(4.0) + 2.0)


@pytest.mark.parametrize("site", ["icp", "overlap", "field", "metric"])
def test_nn_site_lowers_to_kernel_for_cuda_only(site):
    f = SITES[site]
    assert TRITON in _lowered(f, *_nn_args(), platform="cuda")
    assert TRITON not in _lowered(f, *_nn_args(), platform="cpu")


def test_plain_path_lowers_to_plain_for_cuda():
    assert TRITON not in _lowered(nearest_neighbor_plain, *_nn_args(),
                                  platform="cuda")


def test_plain_path_products_are_highest():
    """The plain path's distance product is pinned to HIGHEST, never the
    GPU's TF32 default."""
    text = _lowered(nearest_neighbor_plain, *_nn_args(), platform="cuda")
    dots = [line for line in text.splitlines() if "dot_general" in line]
    assert dots
    assert all("precision = [HIGHEST, HIGHEST]" in line for line in dots)


def test_on_cuda_runs_plain_on_cpu(rng):
    q = jnp.asarray(random_cloud(rng, 50), jnp.float32)
    r = jnp.asarray(random_cloud(rng, 80), jnp.float32)
    m = jnp.ones((80,), bool)
    d_site, i_site = jax.jit(nearest_neighbor)(q, r, m)
    d_plain, i_plain = jax.jit(nearest_neighbor_plain)(q, r, m)
    np.testing.assert_array_equal(np.asarray(d_site), np.asarray(d_plain))
    np.testing.assert_array_equal(np.asarray(i_site), np.asarray(i_plain))


@pytest.mark.parametrize("n,kernel", [(8192, True), (8193, False)])
def test_fps_site_shape_rule(n, kernel):
    from kss_icp.config import KSSICPConfig
    from kss_icp.models.kss_icp import resample_batch

    cfg = KSSICPConfig(resample_pad=64)
    pts = jnp.zeros((2, n, 3), jnp.float32)
    msk = jnp.ones((2, n), bool)
    pn = jnp.asarray([64, 64])
    text = _lowered(lambda a, b, c: resample_batch(a, b, c, cfg),
                    pts, msk, pn, platform="cuda")
    assert (TRITON in text) == kernel


def test_pipeline_lowers_with_kernels_for_cuda():
    """The whole register_resampled program traces and lowers for CUDA with
    the kernels in it (the Triton lowering runs here, without a GPU)."""
    from kss_icp.config import KSSICPConfig
    from kss_icp.models.kss_icp import register_resampled

    cfg = KSSICPConfig(rotation_steps=2, max_candidates=2, resample_pad=64,
                       screen_points=32, refine_candidates=1)
    pts = jnp.zeros((64, 3), jnp.float32)
    msk = jnp.ones((64,), bool)
    text = _lowered(lambda a, b, c, d: register_resampled(a, b, c, d, cfg),
                    pts, msk, pts, msk, platform="cuda")
    assert text.count(TRITON) >= 2

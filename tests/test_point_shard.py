"""Point-axis sharding (parallel/point_shard.py) on the virtual 8-device CPU
mesh: sharded ICP / metric must match the single-device solve exactly."""

import jax
import jax.numpy as jnp
import numpy as np

from kss_icp.config import KSSICPConfig
from kss_icp.models.icp import ICPParams, icp
from kss_icp.ops.nn import masked_mean_nn_distance
from kss_icp.parallel.mesh import make_mesh
from kss_icp.parallel.point_shard import (
    icp_point_sharded,
    mean_nn_distance_sharded,
)
from helpers import random_cloud


def _pair(rng, n=512):
    tgt = random_cloud(rng, n).astype(np.float32)
    ang = 0.35
    c, s = np.cos(ang), np.sin(ang)
    r = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    src = tgt @ r.T + np.array([0.05, -0.02, 0.01], np.float32)
    mask = np.ones((n,), bool)
    return (jnp.asarray(src), jnp.asarray(mask),
            jnp.asarray(tgt), jnp.asarray(mask))


def test_sharded_icp_matches_single_device(rng):
    assert jax.device_count() >= 8
    mesh = make_mesh(("points",))
    src, smask, tgt, tmask = _pair(rng)
    params = ICPParams.from_config(KSSICPConfig(max_icp_iterations=60))

    ref = icp(src, smask, tgt, tmask, params)
    shd = icp_point_sharded(src, smask, tgt, tmask, params, mesh=mesh)
    np.testing.assert_allclose(
        np.asarray(shd.rotation), np.asarray(ref.rotation), atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(shd.translation), np.asarray(ref.translation), atol=1e-5
    )
    np.testing.assert_allclose(
        float(shd.fitness), float(ref.fitness), rtol=1e-4, atol=1e-9
    )
    # psum reduction order can flip the convergence test by one iteration.
    assert abs(int(shd.iterations) - int(ref.iterations)) <= 1
    # And it actually solved the problem.
    assert float(shd.fitness) < 1e-6


def test_sharded_icp_respects_masks(rng):
    mesh = make_mesh(("points",))
    src, smask, tgt, tmask = _pair(rng, n=256)
    smask = smask & (jnp.arange(256) < 200)  # padded tail
    params = ICPParams.from_config(KSSICPConfig(max_icp_iterations=40))
    ref = icp(src, smask, tgt, tmask, params)
    shd = icp_point_sharded(src, smask, tgt, tmask, params, mesh=mesh)
    np.testing.assert_allclose(
        np.asarray(shd.rotation), np.asarray(ref.rotation), atol=1e-5
    )


def test_sharded_mean_nn_distance(rng):
    mesh = make_mesh(("points",))
    q = jnp.asarray(random_cloud(rng, 512).astype(np.float32))
    r = jnp.asarray(random_cloud(rng, 300).astype(np.float32))
    qm = jnp.asarray(np.arange(512) < 480)
    rm = jnp.ones((300,), bool)
    ref = masked_mean_nn_distance(q, qm, r, rm)
    shd = mean_nn_distance_sharded(q, qm, r, rm, mesh=mesh)
    np.testing.assert_allclose(float(shd), float(ref), rtol=1e-5)

"""The rotation field (models/coarse.score_rotation_field) on the plain
path, which every platform but CUDA runs, against a float64 numpy brute
force: masks and batching."""

import jax
import jax.numpy as jnp
import numpy as np

from kss_icp.core.transforms import euler_xyz_matrix
from kss_icp.models.coarse import rotation_grid, score_rotation_field
from helpers import random_cloud

STEPS = 3


def _brute(src, smask, tgt, tmask):
    rots = np.asarray(euler_xyz_matrix(rotation_grid(STEPS, 6.3)), np.float64)
    s = np.asarray(src, np.float64)
    t = np.asarray(tgt, np.float64)[tmask]
    out = []
    for r in rots:
        d2 = (((s @ r.T)[:, None] - t[None]) ** 2).sum(-1).min(1)
        out.append(np.sqrt(d2)[smask].mean())
    return np.asarray(out).reshape(STEPS, STEPS, STEPS)


def _field(src, smask, tgt, tmask):
    return np.asarray(score_rotation_field(
        jnp.asarray(src), jnp.asarray(smask), jnp.asarray(tgt),
        jnp.asarray(tmask), steps=STEPS))


def test_target_mask(rng):
    src = random_cloud(rng, 120)
    tgt = random_cloud(rng, 90)
    smask = np.ones((120,), bool)
    tmask = np.ones((90,), bool)
    tmask[60:] = False
    np.testing.assert_allclose(_field(src, smask, tgt, tmask),
                               _brute(src, smask, tgt, tmask), rtol=1e-5)


def test_source_mask_weighting(rng):
    src = random_cloud(rng, 120)
    tgt = random_cloud(rng, 90)
    smask = np.zeros((120,), bool)
    smask[::3] = True
    tmask = np.ones((90,), bool)
    got = _field(src, smask, tgt, tmask)
    np.testing.assert_allclose(got, _brute(src, smask, tgt, tmask), rtol=1e-5)
    # Masked source rows carry no weight: dropping them changes nothing.
    np.testing.assert_allclose(
        got, _field(src[smask], smask[smask], tgt, tmask), rtol=1e-6)


def test_vmap_over_pairs(rng):
    src = np.stack([random_cloud(rng, 100) for _ in range(3)])
    tgt = np.stack([random_cloud(rng, 80) for _ in range(3)])
    smask = np.ones((3, 100), bool)
    tmask = np.ones((3, 80), bool)
    tmask[1, 50:] = False
    batched = np.asarray(jax.vmap(
        lambda a, b, c, d: score_rotation_field(
            a, b, c, d, steps=STEPS))(
        jnp.asarray(src), jnp.asarray(smask), jnp.asarray(tgt),
        jnp.asarray(tmask)))
    for i in range(3):
        np.testing.assert_allclose(
            batched[i], _brute(src[i], smask[i], tgt[i], tmask[i]), rtol=1e-5)

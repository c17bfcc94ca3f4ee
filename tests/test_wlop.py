"""WLOP resampling: regularity improvement, surface adherence, masks."""

import jax.numpy as jnp
import numpy as np

from kss_icp.ops.resample import fps_points
from kss_icp.ops.wlop import wlop_resample
from helpers import random_cloud


def min_pair_dists(x):
    d2 = ((x[:, None] - x[None, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    return np.sqrt(d2.min(axis=1))


def test_wlop_regularizes_spacing(rng):
    """WLOP's contract: sample spacing becomes more uniform than raw FPS
    (lower coefficient of variation of NN distances)."""
    pts = random_cloud(rng, 3000).astype(np.float32)
    mask = jnp.ones(3000, bool)
    m = 200
    fps, fmask = fps_points(jnp.asarray(pts), mask, m)
    wl, wmask = wlop_resample(jnp.asarray(pts), mask, m, iterations=25)
    fps_d = min_pair_dists(np.asarray(fps)[np.asarray(fmask)])
    wl_d = min_pair_dists(np.asarray(wl)[np.asarray(wmask)])
    cv_fps = fps_d.std() / fps_d.mean()
    cv_wl = wl_d.std() / wl_d.mean()
    assert cv_wl < cv_fps


def test_wlop_stays_on_surface(rng):
    pts = random_cloud(rng, 2000).astype(np.float32)
    wl, wmask = wlop_resample(jnp.asarray(pts), jnp.ones(2000, bool), 128,
                              iterations=20)
    samples = np.asarray(wl)[np.asarray(wmask)]
    # Every sample within a small distance of the input cloud.
    d2 = ((samples[:, None] - pts[None]) ** 2).sum(-1).min(1)
    assert np.sqrt(d2).max() < 0.15


def test_wlop_respects_input_mask(rng):
    pts = random_cloud(rng, 500).astype(np.float32)
    pts[400:] = 50.0  # poisoned padding
    mask = np.arange(500) < 400
    wl, wmask = wlop_resample(jnp.asarray(pts), jnp.asarray(mask), 64,
                              iterations=10)
    samples = np.asarray(wl)[np.asarray(wmask)]
    assert np.abs(samples).max() < 5.0


def test_wlop_exact_count(rng):
    pts = random_cloud(rng, 1000).astype(np.float32)
    wl, wmask = wlop_resample(jnp.asarray(pts), jnp.ones(1000, bool), 77,
                              iterations=5)
    assert np.asarray(wmask).sum() == 77

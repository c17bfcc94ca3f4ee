"""CI coverage for the exact jitted programs bench.py runs.

bench.py only executes on the GPU, so bugs in its program constructors
(make_programs) would surface mid-benchmark after a multi-minute compile.
This compiles and runs the same pipeline / measure /
polish jits on CPU at a tiny configuration — the program SURFACE is
identical (same functions, same signatures), only the static shapes and
knob values shrink."""

import numpy as np
import pytest


@pytest.fixture(scope="module")
def programs():
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import bench

    return bench.make_programs()


def _tiny_cfg(**kw):
    from kss_icp.config import KSSICPConfig

    return KSSICPConfig(
        rotation_steps=4, max_candidates=4, max_resample_points=128,
        resample_pad=128, screen_points=64, rotation_chunk=16,
        refine_candidates=2, refine_tier_iterations=4, **kw)


def _batch(b=3, n=512, seed=0):
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    u = rng.uniform(-1, 1, (b, n))
    v = rng.uniform(-1, 1, (b, n))
    tgt = np.stack([u, v, 0.3 * np.sin(3 * u) * np.cos(2 * v)
                    + 0.2 * np.sin(2 * v)], -1).astype(np.float32)
    ang = 0.8
    c, s = np.cos(ang), np.sin(ang)
    r = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    src = tgt @ r.T
    mask = np.ones((b, n), bool)
    pn = np.full((b,), 128, np.int32)
    return tuple(map(jnp.asarray, (src, mask, tgt, mask, pn)))


def test_pipeline_and_measure(programs):
    pipeline, measure_all = programs[0], programs[1]
    cfg = _tiny_cfg(refine_max_iterations=40)
    a = _batch()
    tr, packed = pipeline(*a, cfg)
    assert packed.shape == (3, 2)
    fit = np.asarray(packed[:, 0])
    hit = np.asarray(packed[:, 1]) > 0.5
    # Same-surface pairs align to the coarse 4^3-grid budget's floor.
    assert (fit < 5e-2).all(), fit
    assert not hit.any()               # ...and converge under the cap
    rm = np.asarray(measure_all(tr, *a[:4]))
    assert rm.shape == (3,) and (rm < 0.2).all(), rm


def test_polish_program(programs):
    import jax
    import jax.numpy as jnp

    pipeline, measure_all, polish = programs[:3]
    # Force hit-cap lanes with a 1-iteration stage-1 cap.
    cfg = _tiny_cfg(refine_max_iterations=1, refine_polish_iterations=40)
    a = _batch()
    tr, packed = pipeline(*a, cfg)
    hit = np.asarray(packed[:, 1]) > 0.5
    assert hit.any()
    sel = jnp.asarray(np.nonzero(hit)[0])
    tot, fit2 = polish(sel, *a, tr, cfg)
    assert np.asarray(fit2).shape == (int(hit.sum()),)
    # Continuing the cut converge should not materially regress any lane:
    # ICP fitness is not guaranteed strictly monotone across a restart (the
    # correspondence set can change), so allow a small relative tolerance —
    # the production path's guarantee is the keep-better MERGE below, which
    # is what must never regress (ADVICE r3).
    fit1 = np.asarray(packed[:, 0])[np.asarray(sel)]
    assert (np.asarray(fit2) <= fit1 * 1.05 + 1e-6).all(), (fit1, np.asarray(fit2))

    tr_np = jax.tree.map(lambda x: np.asarray(x).copy(), tr)

    def put(full, new):
        full[np.asarray(sel)] = np.asarray(new)
        return full

    merged = jax.tree.map(put, tr_np, jax.tree.map(np.asarray, tot))
    rm_before = np.asarray(measure_all(tr, *a[:4]))
    rm = np.asarray(measure_all(jax.tree.map(jnp.asarray, merged), *a[:4]))
    assert (rm <= rm_before + 1e-3).all(), (rm_before, rm)


def test_overlap_program(programs):
    """The overlap-tier resolve program (escalate.overlap_rerun contract):
    gathers flagged rows, solves overlap-robustly, returns comparable
    bidirectional trimmed fitnesses for new + incumbent transforms."""
    import jax
    import jax.numpy as jnp

    pipeline, overlap = programs[0], programs[3]
    cfg = _tiny_cfg()
    ocfg = cfg.overlap_config()
    a = _batch()
    tr, packed = pipeline(*a, cfg)
    # Inputs are pre-gathered (the program's shape depends only on the
    # chunk size, never the corpus size).
    sel = np.asarray([0, 2])
    a_sel = tuple(jnp.asarray(np.asarray(x)[sel]) for x in a)
    tr_sel = jax.tree.map(lambda x: jnp.asarray(np.asarray(x)[sel]), tr)
    tot, fit_std, tf_new, tf_old = overlap(*a_sel, tr_sel, ocfg)
    assert np.asarray(fit_std).shape == (2,)
    assert np.asarray(tf_new).shape == (2,) and np.asarray(tf_old).shape == (2,)
    # Full-overlap, already-good pairs: the incumbent's trimmed fitness sits
    # at the tiny config's accuracy floor (4^3 grid, 128-pt clouds), and the
    # overlap solve cannot beat it by the adopt margin (no spurious
    # replacement on full-overlap data).
    assert (np.asarray(tf_old) < 5e-2).all(), np.asarray(tf_old)
    # And the overlap solve itself still lands in the right basin.
    assert (np.asarray(fit_std) < 5e-2).all(), np.asarray(fit_std)

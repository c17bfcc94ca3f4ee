"""escalate.py host machinery: padded selection, fitness-gated rerun,
flag-gated polish rerun, and the two-stage-converge equivalence
(KSSICPConfig.refine_polish_iterations; reference intent KSS_ICP.hpp:99-121
for escalation — polish has no reference analogue, the reference solves
serially and never pays a lockstep tail)."""

import numpy as np
import pytest

from kss_icp.escalate import escalate_rerun, padded_selection, polish_rerun


def test_padded_selection():
    sel = padded_selection(np.array([3, 7]), 4)
    assert sel.tolist() == [3, 7, 3, 3]
    assert padded_selection(np.array([1, 2, 3, 4]), 4).tolist() == [1, 2, 3, 4]
    assert padded_selection(np.array([5]), 4, cap=2).tolist() == [5, 5]


def test_escalate_rerun_fitness_gate():
    fitness = np.array([1e-4, 5e-3, 2e-4, 9e-3])
    calls = []

    def resolve(sel):
        calls.append(sel.tolist())
        return {"x": np.full(len(sel), 42.0)}, np.full(len(sel), 1e-5)

    result = {"x": np.zeros(4)}
    out, fit, wins, n = escalate_rerun(resolve, fitness, 3e-3, 2, result=result)
    assert n == 2
    assert len(calls) == 1 and sorted(calls[0]) == [1, 3]
    assert out["x"][1] == 42.0 and out["x"][3] == 42.0
    assert out["x"][0] == 0.0 and out["x"][2] == 0.0
    np.testing.assert_allclose(fit[[1, 3]], 1e-5)


def test_escalate_rerun_flags_override():
    """flags= selects rows regardless of the fitness threshold."""
    fitness = np.array([1e-4, 1e-4, 1e-4])
    flags = np.array([False, True, False])

    def resolve(sel):
        return {"x": np.full(len(sel), 1.0)}, np.full(len(sel), 5e-5)

    out, fit, wins, n = escalate_rerun(
        resolve, fitness, None, 1, result={"x": np.zeros(3)}, flags=flags)
    assert n == 1
    assert out["x"].tolist() == [0.0, 1.0, 0.0]


def test_polish_rerun_keep_better():
    """polish_rerun merges keep-better by REAL fitness: a continuation that
    somehow worsens a row must not replace it."""
    fitness = np.array([2e-3, 4e-3])
    hit = np.array([True, True])

    def resolve(sel):
        # Row 0 improves, row 1 worsens.
        f2 = np.where(np.asarray(sel) == 0, 1e-4, 9e-3)
        return {"x": np.full(len(sel), 7.0)}, f2

    out, fit, wins, n = polish_rerun(
        resolve, hit, fitness, 2, result={"x": np.zeros(2)})
    assert n == 2
    assert out["x"].tolist() == [7.0, 0.0]
    assert fit[0] == pytest.approx(1e-4) and fit[1] == pytest.approx(4e-3)


def test_two_stage_converge_matches_single_stage():
    """cap-N + warm-started polish reproduces the single-loop cap result:
    ICP correspondences depend only on current positions, so restarting
    from the composed transform continues the cut iteration sequence."""
    import dataclasses

    from kss_icp.config import KSSICPConfig
    from kss_icp.parallel.batch import register_many
    from kss_icp.stress import rot_xyz

    rng = np.random.default_rng(3)
    base = rng.uniform(-1, 1, (800, 3)).astype(np.float32)
    base[:, 2] = 0.3 * np.sin(3 * base[:, 0]) * np.cos(2 * base[:, 1])
    base += 0.15 * np.sin(2 * base[:, [1, 2, 0]])  # break planarity
    r = rot_xyz(0.9, 0.4, 1.3)
    pairs = [((base @ r.T) * 1.3 + 0.2, base)]

    cfg = KSSICPConfig(
        max_candidates=6, coarse_points=256, refine_candidates=2,
        max_resample_points=400, resample_pad=512, screen_points=256,
        refine_tier_iterations=6, refine_max_iterations=40,
    )
    cfg2 = dataclasses.replace(cfg, refine_max_iterations=4,
                               refine_polish_iterations=40)
    _, m1 = register_many(pairs, cfg, full_pad=1024, escalate=False)
    _, m2 = register_many(pairs, cfg2, full_pad=1024, escalate=False)
    # Same solve, same floor: identical up to restart bookkeeping noise.
    assert abs(float(m1["rmse"][0]) - float(m2["rmse"][0])) < 2e-3, (
        m1["rmse"], m2["rmse"])


def test_escalate_rerun_difficulty_sort_chunks():
    """Chunked escalation sorts worst-fitness rows first (r4: easy chunks
    exit their lockstep loops early) while keep-better semantics hold."""
    import numpy as np

    from kss_icp.escalate import escalate_rerun

    fitness = np.array([0.001, 0.9, 0.002, 0.5, 0.003, 0.7], np.float32)
    seen = []

    def resolve(sel):
        seen.append(list(sel))
        return {"x": np.asarray(sel, np.float32)[:, None]}, \
            np.full(len(sel), 1e-4, np.float32)

    result = {"x": np.zeros((6, 1), np.float32)}
    out, fit, wins, n = escalate_rerun(
        resolve, fitness, 0.1, pad_multiple=2, result=result, chunk=2)
    assert n == 3
    # padding repeats flagged[0] (idx 1) BEFORE the sort; chunks must then
    # be ordered worst-first: [1(0.9), 1(pad)] then [5(0.7), 3(0.5)]
    assert seen[0] == [1, 1] and seen[1] == [5, 3], seen
    # keep-better merged all three flagged rows
    assert np.allclose(fit[[1, 3, 5]], 1e-4)
    assert out["x"][1, 0] == 1 and out["x"][3, 0] == 3 and out["x"][5, 0] == 5
    assert out["x"][0, 0] == 0  # unflagged rows untouched

"""CI pin for the overlap-tier adoption calibration (VERDICT r4 item 6).

The overlap ladder's two measured constants —
``overlap_adopt_margin = 0.7`` (adopt an overlap solve iff its
bidirectional trimmed fitness beats the incumbent's by this ratio) and
``overlap_gate_ratio = 1.05`` (launch the overlap solve only when the
incumbent's trimmed/standard fitness ratio shows a heavy error tail) —
were calibrated on thin populations (12 adoption decisions, one gate
sweep; config.py). This test recomputes both ratio populations on a small
fixed corpus so a corpus or solver change that closes either gap fails
HERE, not on the challenge board.

Fixed corpus + measured populations (round 5, CPU, x64 off; the corpus
includes the round-5 bilateral partial outliers):

  wins   (partial box pairs, the 8^3-rung adoption cases):
         part/box0@keep0.8 adopt 0.687 gate 0.330;
         part/box0@keep0.92 adopt 0.683 gate 0.423
  blocks (full-overlap category pairs, correct incumbents):
         tube/0 adopt 0.990 gate 1.200; box/0 adopt 1.582 gate 1.130

The adoption margin 0.7 sits 1.44x below the closest block (0.990) and
just above the wins (0.687) — the thin win-side gap is a real property of
the round-5 corpus (source-side outliers eat into the trim quantile), so
a drift of the wins ACROSS the margin is precisely the regression this
test exists to catch. The se/rev hard pairs are excluded: their wins live
at the 16^3 rung (complementary-rung design, BASELINE.md r4), which is
too slow for CPU CI.

Protocol per pair (production-like): incumbent = bench-config solve +
prefix-fidelity 16^3 escalation when flagged; overlap solve = first rung
(overlap_config at the base grid); ratios exactly as the ladder computes
them (escalate.overlap_rerun / parallel.batch.register_many).
"""

from __future__ import annotations

import numpy as np
import pytest

SEPARATION = 1.15


@pytest.fixture(scope="module")
def populations():
    import jax.numpy as jnp

    from kss_icp.challenge import category_corpus, partial_corpus
    from kss_icp.config import KSSICPConfig
    from kss_icp.models.kss_icp import (
        register_overlap_resampled,
        register_resampled,
        resample_pairs,
        trimmed_fitness,
    )

    cfg = KSSICPConfig(
        max_candidates=6, coarse_points=512, coarse_target_points=512,
        refine_candidates=2, refine_tier_iterations=12,
        refine_max_iterations=48,
        escalate_coarse_points=512, escalate_coarse_target_points=512)

    hard = {p[0]: p for p in partial_corpus(keep=0.8)}
    part = {p[0]: p for p in partial_corpus()}
    cat = {p[0]: p for p in category_corpus(instances=2)}
    win_pairs = [("hard", hard["part/box0"]), ("part", part["part/box0"])]
    block_pairs = [("cat", cat["tube/0"]), ("cat", cat["box/0"])]

    q = cfg.overlap_trim_fraction

    def solve_ratios(tagged):
        rows = []
        for tag, (name, src, tgt, _gt) in tagged:
            pad = 8192
            sp = np.zeros((1, pad, 3), np.float32)
            sp[0, : len(src)] = src[:pad]
            sm = np.zeros((1, pad), bool)
            sm[0, : min(len(src), pad)] = True
            tp = np.zeros((1, pad, 3), np.float32)
            tp[0, : len(tgt)] = tgt[:pad]
            tm = np.zeros((1, pad), bool)
            tm[0, : min(len(tgt), pad)] = True
            pn = jnp.asarray(
                [cfg.resample_count(len(src), len(tgt))], jnp.int32)
            (rs, rsm), (rt, rtm) = resample_pairs(
                jnp.asarray(sp), jnp.asarray(sm), jnp.asarray(tp),
                jnp.asarray(tm), pn, cfg)
            a = (rs[0], rsm[0], rt[0], rtm[0])
            inc = register_resampled(*a, cfg)
            fit = float(inc.fitness)
            if fit > cfg.escalate_threshold or bool(inc.refine_hit_cap):
                inc2 = register_resampled(*a, cfg.escalation_config())
                if float(inc2.fitness) < fit:
                    inc, fit = inc2, float(inc2.fitness)
            tf_old = float(trimmed_fitness(inc.transform, *a, q))
            ovl = register_overlap_resampled(*a, cfg.overlap_config())
            tf_new = float(ovl.fitness)
            rows.append({
                "name": f"{tag}:{name}",
                "adopt_ratio": tf_new / max(tf_old, 1e-12),
                "gate_ratio": tf_old / max(fit, 1e-12),
            })
        return rows

    return {"win": solve_ratios(win_pairs),
            "block": solve_ratios(block_pairs)}


def test_adoption_margin_sits_in_gap(populations):
    from kss_icp.config import DEFAULT_CONFIG

    margin = DEFAULT_CONFIG.overlap_adopt_margin
    win = max(r["adopt_ratio"] for r in populations["win"])
    block = min(r["adopt_ratio"] for r in populations["block"])
    assert win < margin, (
        f"genuine overlap wins no longer adopt: max win ratio {win:.3f} "
        f">= margin {margin} ({populations['win']})")
    assert block > margin, (
        f"full-overlap solves would be overwritten: min block ratio "
        f"{block:.3f} <= margin {margin} ({populations['block']})")
    assert block / win >= SEPARATION, (
        f"adoption populations too close: {win:.3f} vs {block:.3f} "
        f"(separation {block / win:.2f}x < {SEPARATION}x)")


def test_gate_ratio_sits_in_gap(populations):
    from kss_icp.config import DEFAULT_CONFIG

    gate = DEFAULT_CONFIG.overlap_gate_ratio
    # Partial incumbents carry a heavy tail: trimmed << standard fitness.
    part = max(r["gate_ratio"] for r in populations["win"])
    # Well-converged full-overlap solves have uniform (density-floor)
    # error: trimming buys little, the bidirectional sum adds its own
    # floor, so the ratio sits above the gate.
    floor = min(r["gate_ratio"] for r in populations["block"])
    assert part < gate, (
        f"partial incumbents no longer pass the crop-signature gate: "
        f"{part:.3f} >= {gate} ({populations['win']})")
    assert floor > gate, (
        f"density-floor pairs would pay the overlap solves every pass: "
        f"{floor:.3f} <= {gate} ({populations['block']})")
    assert floor / part >= SEPARATION, (
        f"gate populations too close: {part:.3f} vs {floor:.3f} "
        f"(separation {floor / part:.2f}x < {SEPARATION}x)")

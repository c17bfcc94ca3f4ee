"""Benchmark: batched KSS-ICP registration throughput on one GPU.

Protocol (the reference's own benchmark shape, Main_KSS_List.cpp:151-179):
full pipeline per pair — FPS resample to 2000 pts, pre-shape align
(recovers the scale), 512-rotation coarse search, multi-start ICP — batched
and jitted as one program. Two timed figures:

  value            batch-23 golden corpus (data/registration +
                   data/registration_scale) — the round-over-round parity
                   protocol;
  value_saturated  all 78 real distinct pairs on hand (23 golden +
                   30 stress + 25 transfer-protocol remesh) as ONE batch —
                   the production serving figure at amortized dispatch.

Prints ONE JSON line:
  {"metric": ..., "value": pairs/s/chip, "unit": "pairs/s", "vs_baseline": x,
   "value_saturated": ..., "batch_saturated": 78,
   "device": {"platform": "gpu", "kind": ..., "count": ...}, ...}

It measures the GPU only: with no GPU it exits nonzero before any run.

Baseline: MEASURED by the CPU oracle (kss_icp/oracle.py, a faithful
numpy/scipy replica of the reference pipeline) — scripts/measure_baseline.py
writes BASELINE_ORACLE.json and this script reads pairs_per_sec from it.
`vs_baseline` uses the calibrated (conservative) end of the oracle's rate
bracket when present (`pairs_per_sec_calibrated` — see
scripts/calibrate_oracle.py). Falls back to the 0.1 pairs/s estimate
(single pair ~10 s on a desktop CPU per the reference's own clock()
protocol) if the oracle file is absent.

Robustness tail: per-corpus success rates over the stress (30 adversarial
compound-rotation pairs) and remesh (25 transfer-protocol fixture pairs)
corpora, with fitness-flagged pairs auto-escalated to the 16^3 grid via
the shared kss_icp.escalate helper (chunked at batch 23 so the
escalation program shape is the round-2 cached one).
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np

_ORACLE_JSON = Path(__file__).resolve().parent / "BASELINE_ORACLE.json"


def reference_pairs_per_sec() -> tuple[float, str]:
    if _ORACLE_JSON.exists():
        try:
            d = json.loads(_ORACLE_JSON.read_text())
            if "pairs_per_sec_calibrated" in d:
                return (float(d["pairs_per_sec_calibrated"]),
                        "measured+calibrated (CPU oracle, BASELINE_ORACLE.json)")
            return float(d["pairs_per_sec"]), "measured (CPU oracle, BASELINE_ORACLE.json)"
        except (KeyError, ValueError, TypeError):
            pass
    return 0.1, "estimate (no BASELINE_ORACLE.json)"


FULL_PAD = 8192
REPEAT = 3
ESC_CHUNK = 16     # escalation re-solve chunk width (round-5 probes)
FAIL_RMSE = 0.05   # unit-scale clouds: success = RMSE below this


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _short_cfg(c):
    return f"{c.rotation_steps}^3x{c.overlap_iterations}"


def bench_config():
    """The tuned bench knobs, validated RMSE-identical per pair on the 23
    golden pairs (BASELINE.md optimization ladders).

    refine_max_iterations=16 (round 4): with the hit-cap -> escalation fold
    a capped-out lane is always finished by the uncapped 16^3 keep-better
    re-solve, so the batch cap stops being an accuracy risk and becomes a
    pure lockstep-tail bound. Measured (scripts/cap_perpair.py, b78): 148.7
    -> 190.2 pairs/s, ZERO per-pair regressions, 5 hard lanes IMPROVE (the
    16^3 re-solve beats a long 8^3 converge; max RMSE 0.0435 -> 0.0248),
    and every golden lane converges within 16 so the b23 parity table is
    bit-identical. Cap 8 sent golden lanes into escalation — rejected to
    keep the golden-batch protocol escalation-free."""
    from kss_icp.config import KSSICPConfig

    return KSSICPConfig(max_candidates=6, coarse_points=512,
                        coarse_target_points=512, refine_candidates=2,
                        refine_tier_iterations=12, refine_max_iterations=16)


def make_programs():
    """(pipeline, measure_all, polish, overlap) jitted programs — the
    bench's full per-pair pipeline (resample + register), the full-res RMSE
    measure, the two-stage-converge polish pass, and the overlap-tier
    resolve. Module-level so tests/test_bench_programs.py compiles the same
    programs on CPU."""
    import jax
    import jax.numpy as jnp
    from functools import partial

    from kss_icp.core.transforms import apply_similarity
    from kss_icp.metrics import registration_measure_padded
    from kss_icp.models.kss_icp import (
        overlap_screen_solve_batch,
        overlap_solve_batch,
        polish_resampled,
        register_resampled,
        resample_pairs,
    )

    @partial(jax.jit, static_argnames=("cfg",))
    def pipeline(sp, sm_, tp, tm_, pn, cfg):
        (rs, rsm), (rt, rtm) = resample_pairs(sp, sm_, tp, tm_, pn, cfg)

        def one(spi, smi, tpi, tmi):
            res = register_resampled(spi, smi, tpi, tmi, cfg)
            return res.transform, res.fitness, res.refine_hit_cap

        tr, fit, hit = jax.vmap(one)(rs, rsm, rt, rtm)
        # Outputs stay small (no resampled clouds): fitness and the hit-cap
        # flag pack into one (B, 2) array, one host transfer per launch.
        return tr, jnp.stack([fit, hit.astype(fit.dtype)], axis=-1)

    @jax.jit
    def measure_all(tr, sp, sm_, tp, tm_):
        def one(tri, spi, smi, tpi, tmi):
            aligned = apply_similarity(tri, spi)
            return registration_measure_padded(aligned, smi, tpi, tmi)["rmse"]

        return jax.vmap(one)(tr, sp, sm_, tp, tm_)

    @partial(jax.jit, static_argnames=("cfg",))
    def polish(sel, sp, sm_, tp, tm_, pn, tr, cfg):
        # Everything INSIDE one jit — gather the selected full-res rows,
        # re-resample them (FPS is deterministic, so this reproduces the
        # pipeline's working clouds; K-lane FPS costs ~15 ms vs the ~200 ms
        # it would cost to ship resampled clouds out of the pipeline), then
        # continue the capped converge warm-started from the composed
        # transforms.
        (rs, rsm), (rt, rtm) = resample_pairs(
            sp[sel], sm_[sel], tp[sel], tm_[sel], pn[sel], cfg)
        tot, fit2, _ = jax.vmap(
            lambda a, b, c, d, t: polish_resampled(a, b, c, d, t, cfg)
        )(rs, rsm, rt, rtm, jax.tree.map(lambda x: x[sel], tr))
        return tot, fit2

    @partial(jax.jit, static_argnames=("cfg",))
    def finish(sp, sm_, tp, tm_, pn, tr, cfg):
        # Uncapped warm-started continuation of capped lanes (ADVICE r4
        # finisher). Inputs are PRE-GATHERED rows (host slices before the
        # call) so the XLA shape depends only on the chunk size, never the
        # corpus size — one compile serves the saturated batch and every
        # challenge scenario.
        (rs, rsm), (rt, rtm) = resample_pairs(sp, sm_, tp, tm_, pn, cfg)
        tot, fit2, _ = jax.vmap(
            lambda a, b, c, d, t: polish_resampled(a, b, c, d, t, cfg)
        )(rs, rsm, rt, rtm, tr)
        return tot, fit2

    @partial(jax.jit, static_argnames=("cfg",))
    def trimmed_probe(sp, sm_, tp, tm_, pn, tr, cfg):
        # Crop-signature probe (pre-gathered rows, same shape contract as
        # the overlap program): bidirectional trimmed fitness of the
        # incumbent transforms — two NN passes per row, milliseconds — used
        # to gate the overlap rungs (KSSICPConfig.overlap_gate_ratio).
        from kss_icp.models.kss_icp import trimmed_fitness

        (rs, rsm), (rt, rtm) = resample_pairs(sp, sm_, tp, tm_, pn, cfg)

        def one(a, b, c, d, t):
            return trimmed_fitness(t, a, b, c, d, cfg.overlap_trim_fraction)

        return jax.vmap(one)(rs, rsm, rt, rtm, tr)

    @partial(jax.jit, static_argnames=("cfg",))
    def overlap_screen(sp, sm_, tp, tm_, pn, tr, cfg):
        # Screen-seeded overlap rung (round 5, rung 3) — same pre-gathered
        # chunk contract as `overlap`.
        (rs, rsm), (rt, rtm) = resample_pairs(sp, sm_, tp, tm_, pn, cfg)
        return overlap_screen_solve_batch(rs, rsm, rt, rtm, tr, cfg)

    @partial(jax.jit, static_argnames=("cfg",))
    def overlap(sp, sm_, tp, tm_, pn, tr, cfg):
        # Overlap-tier resolve (escalate.overlap_rerun contract). Inputs are
        # PRE-GATHERED flagged rows (the host slices before the call) so the
        # program's XLA shape depends only on the chunk size
        # (escalate_pad), never the corpus size — one compile serves the
        # saturated batch and every challenge scenario. Re-resamples in-jit
        # (FPS is deterministic, same pattern as the polish program), runs
        # the batched overlap-robust solve and scores the incumbent
        # transform with the same bidirectional trimmed metric. cfg must be
        # the overlap config.
        (rs, rsm), (rt, rtm) = resample_pairs(sp, sm_, tp, tm_, pn, cfg)
        return overlap_solve_batch(rs, rsm, rt, rtm, tr, cfg)

    return (pipeline, measure_all, polish, overlap, trimmed_probe, finish,
            overlap_screen)


def load_pairs():
    from kss_icp.stress import golden_corpus

    pairs = golden_corpus()
    if not pairs:  # fallback: synthetic wavy-surface pairs
        rng = np.random.default_rng(0)
        for i in range(8):
            u = rng.uniform(-1, 1, (5000,))
            v = rng.uniform(-1, 1, (5000,))
            tgt = np.stack([u, v, 0.3 * np.sin(3 * u) * np.cos(2 * v)], -1)
            ang = rng.uniform(0, 2 * np.pi)
            c, s = np.cos(ang), np.sin(ang)
            r = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
            pairs.append((f"synth{i}", tgt @ r.T, tgt))
    return pairs


def main() -> int:
    import jax

    import jax.numpy as jnp

    from kss_icp.escalate import escalate_rerun, overlap_rerun
    from kss_icp.utils.compile_cache import enable_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        log(f"bench.py measures the GPU; JAX found {dev.platform} only")
        return 1
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    log(f"device: {device}; compile cache: {enable_compile_cache()}")

    cfg = bench_config()
    pairs = load_pairs()
    b = len(pairs)
    log(f"pairs: {b} -> {[p[0] for p in pairs]}")

    def pad(pts):
        out = np.zeros((FULL_PAD, 3), np.float32)
        n = min(len(pts), FULL_PAD)
        out[:n] = pts[:n]
        m = np.zeros((FULL_PAD,), bool)
        m[:n] = True
        return out, m

    def batch_arrays(corpus):
        sp = np.stack([pad(p[1])[0] for p in corpus])
        sm = np.stack([pad(p[1])[1] for p in corpus])
        tp = np.stack([pad(p[2])[0] for p in corpus])
        tm = np.stack([pad(p[2])[1] for p in corpus])
        pn = np.array(
            [cfg.resample_count(int(m1.sum()), int(m2.sum()))
             for m1, m2 in zip(sm, tm)], np.int32)
        return sp, sm, tp, tm, pn

    (pipeline, measure_all, polish, overlap_prog, trimmed_probe,
     finish_prog, overlap_screen_prog) = make_programs()

    def overlap_flags(fit_arr, tr_np, arrays, c):
        """(fitness > overlap_threshold) AND crop-signature ratio below the
        gate — computed with the tiny trimmed_probe program on 8-row
        chunks."""
        base = np.asarray(fit_arr) > c.overlap_threshold
        idxs = np.nonzero(base)[0]
        if idxs.size == 0:
            return base
        ep8 = c.escalate_pad
        selp = np.concatenate(
            [idxs, np.repeat(idxs[:1], (ep8 - idxs.size % ep8) % ep8)])
        out = np.zeros_like(base)
        spA, smA, tpA, tmA, pnA = arrays
        for c0 in range(0, selp.size, ep8):
            cs = selp[c0:c0 + ep8]
            tr_sel = jax.tree.map(
                lambda x: jnp.asarray(np.asarray(x)[cs]), tr_np)
            tf = np.asarray(trimmed_probe(
                *map(jnp.asarray, (spA[cs], smA[cs], tpA[cs], tmA[cs],
                                   pnA[cs])), tr_sel, c))
            for j, gi in enumerate(cs):
                if tf[j] < c.overlap_gate_ratio * fit_arr[gi]:
                    out[gi] = True
        return out
    args = tuple(map(jnp.asarray, batch_arrays(pairs)))

    from kss_icp.escalate import polish_rerun

    def run_to_completion(a, c=cfg):
        """One full serving solve: fused pipeline + (when the two-stage
        converge is on) the warm-started polish of hit-cap lanes. Returns
        (transform, fitness ndarray, hit_cap ndarray) — hit_cap marks lanes
        still unconverged after this pass (the escalation selection folds
        them in so no capped-out lane ships silently)."""
        tr, packed = jax.block_until_ready(pipeline(*a, c))
        packed_np = np.asarray(packed)
        fit_np, hit_np = packed_np[:, 0], packed_np[:, 1] > 0.5
        if c.refine_polish_iterations and c.refine_max_iterations and hit_np.any():
            def resolve(sel):
                tot, fit2 = polish(jnp.asarray(sel), *a, tr, c)
                return tot, np.asarray(fit2)

            tr_np, fit_np, _, _ = polish_rerun(
                resolve, hit_np, fit_np, c.escalate_pad, result=tr)
            hit_np = np.zeros_like(hit_np)  # polished lanes ran to completion
            return jax.tree.map(jnp.asarray, tr_np), fit_np, hit_np
        return tr, fit_np, hit_np

    def timed(a, n_pairs, label):
        log(f"compiling {label}...")
        t0 = time.perf_counter()
        out = run_to_completion(a)
        log(f"{label} compile+first run: {time.perf_counter() - t0:.1f}s")
        times = []
        for _ in range(REPEAT):
            t0 = time.perf_counter()
            out = run_to_completion(a)
            times.append(time.perf_counter() - t0)
        rate = n_pairs / min(times)
        log(f"{label} times: {[f'{t:.3f}' for t in times]} -> {rate:.2f} pairs/s")
        return out, rate

    out, pairs_per_sec = timed(args, b, f"batch-{b}")
    transform, fitness = out[0], out[1]

    # Accuracy: full-res RMSE per pair via the batch-b measure program;
    # larger corpora are chunked through the SAME program (one compile).
    def measure_chunked(tr_np, sp, sm_, tp, tm_):
        n = sp.shape[0]
        total = ((n + b - 1) // b) * b
        idx = np.concatenate([np.arange(n), np.zeros(total - n, np.int64)])
        parts = []
        for c in range(total // b):
            sl = idx[c * b:(c + 1) * b]
            tr_c = jax.tree.map(lambda x: jnp.asarray(np.asarray(x)[sl]), tr_np)
            parts.append(np.asarray(measure_all(
                tr_c, *map(jnp.asarray, (sp[sl], sm_[sl], tp[sl], tm_[sl])))))
        return np.concatenate(parts)[:n]

    rmses = np.asarray(measure_all(transform, *args[:4])).tolist()
    fit_np = np.asarray(fitness)
    for i, (name, _, _) in enumerate(pairs):
        log(f"  {name:10s} rmse={rmses[i]:.5f} fitness={fit_np[i]:.6f}")

    # --- Saturated serving batch: all real distinct pairs on hand ---------
    extra_results = {}
    sat_rate = None
    try:
        from kss_icp.stress import remesh_corpus, stress_corpus

        stress = stress_corpus()
        corpora = [("golden", pairs), ("stress", stress)]
        try:
            corpora.append(
                ("remesh", [(nm, s, t) for nm, s, t, _ in remesh_corpus()]))
        except Exception as e:  # fixtures absent -> degrade, keep stress
            log(f"remesh corpus unavailable: {e}")
        allp = [p for _, c in corpora for p in c]
        nsat = len(allp)
        sat = batch_arrays(allp)
        sat_j = tuple(map(jnp.asarray, sat))
        out_s, sat_rate = timed(sat_j, nsat, f"batch-{nsat} saturated")
        tr_all = jax.tree.map(np.asarray, out_s[0])
        fit_all = np.asarray(out_s[1])
        hit_all = np.asarray(out_s[2])

        # Escalation (shared helper; reference intent KSS_ICP.hpp:99-121):
        # flagged pairs re-solve on the 16^3 grid, chunked at batch b so the
        # escalation program shape is the cached batch-b one.
        ecfg = cfg.escalation_config()
        sp, sm_, tp, tm_, pn = sat

        def resolve(sel):
            out2 = pipeline(*map(jnp.asarray,
                                 (sp[sel], sm_[sel], tp[sel], tm_[sel], pn[sel])),
                            ecfg)
            p2 = np.asarray(out2[1])
            # The escalated solve's OWN hit-cap flag merges alongside the
            # transform (ADVICE r4): an escalation lane that exhausts its
            # 128-iteration cap must not ship silently either.
            return (out2[0], p2[:, 1] > 0.5), p2[:, 0]

        t0 = time.perf_counter()
        # cap at a MULTIPLE of b: padded_selection's default cap (=nsat)
        # would otherwise allow a trailing non-b chunk — a new, unprimed
        # XLA program shape.
        flags = (fit_all > cfg.escalate_threshold) | hit_all
        # Chunked at escalate_pad (8), hard lanes first: the escalation
        # while_loops pay batch-width x worst-lane iterations, so narrow
        # chunks are measurably cheaper (2.77 -> 2.08 s steady, r4 probe)
        # and the difficulty sort lets easy chunks exit early.
        ep = cfg.escalate_pad
        # Escalation chunk 16 (round 5 probes): with the 512-prefix fine
        # field the pass is launch-bound, and one 16-lane chunk beats two
        # 8-lane chunks (0.53 vs ~0.6 s steady, per-pair identical). The
        # overlap/finisher programs stay at the escalate_pad=8 shape.
        ec = ESC_CHUNK
        merged, fit_all, _, n_flagged = escalate_rerun(
            resolve, fit_all, cfg.escalate_threshold, pad_multiple=ec,
            result=(tr_all, hit_all), chunk=ec,
            cap=((nsat + ec - 1) // ec) * ec, flags=flags)
        tr_all, hit_all = merged
        hit_all = np.asarray(hit_all).astype(bool)
        fin_sel = np.nonzero(hit_all)[0]
        if hit_all.any():
            # Uncapped finisher (ADVICE r4): lanes still unconverged after
            # the keep-better merge — an escalated win that hit the cap,
            # or a capped incumbent the escalation failed to beat — continue
            # warm-started to full convergence through the polish program.
            def finish_resolve(fsel):
                tr_sel = jax.tree.map(
                    lambda x: jnp.asarray(np.asarray(x)[fsel]), tr_all)
                tot, fit2 = finish_prog(
                    *map(jnp.asarray, (sp[fsel], sm_[fsel], tp[fsel],
                                       tm_[fsel], pn[fsel])), tr_sel, ecfg)
                return tot, np.asarray(fit2)

            tr_all, fit_all, fwins, _ = polish_rerun(
                finish_resolve, hit_all, fit_all, ep, result=tr_all, chunk=ep)
            log(f"escalation finisher: {int(hit_all.sum())} capped lanes, "
                f"{len(fwins)} improved")
            hit_all = np.zeros_like(hit_all)
        # Overlap tier (VERDICT r3 item 1): pairs still fitness-flagged
        # after the fine grid get overlap-robust solves — TWO rungs (8^3
        # then 16^3; they fix complementary basins, see BASELINE.md r4) —
        # adopted by the bidirectional trimmed-fitness margin. Chunked at
        # escalate_pad (8) so each heavy program compiles one small shape.
        if cfg.overlap_escalate:
            rungs = [(cfg.overlap_config(), overlap_prog, "field"),
                     (ecfg.overlap_config(), overlap_prog, "field")]
            if cfg.overlap_screen_rung:
                rungs.append(
                    (cfg.overlap_config(), overlap_screen_prog, "screen"))
            for ocfg, oprog, otag in rungs:
                oflags = overlap_flags(fit_all, tr_all, (sp, sm_, tp, tm_, pn),
                                       cfg)

                def oresolve(sel, _a=(sp, sm_, tp, tm_, pn), _oc=ocfg,
                             _p=oprog):
                    tr_sel = jax.tree.map(
                        lambda x: jnp.asarray(np.asarray(x)[sel]), tr_all)
                    return _p(
                        *[jnp.asarray(x[sel]) for x in _a], tr_sel, _oc)

                tr_all, fit_all, owins, o_flagged = overlap_rerun(
                    oresolve, fit_all, cfg.overlap_threshold,
                    cfg.escalate_pad, cfg.overlap_adopt_margin,
                    result=tr_all, chunk=cfg.escalate_pad, flags=oflags)
                if o_flagged:
                    log(f"overlap rung {otag} {_short_cfg(ocfg)}: "
                        f"{o_flagged} flagged, {len(owins)} adopted")
        esc_dt = time.perf_counter() - t0
        rm_all = measure_chunked(tr_all, sp, sm_, tp, tm_)
        log(f"saturated batch: {nsat} pairs, escalated={n_flagged} "
            f"({esc_dt:.1f}s incl. compile on first run)")

        # Honest end-to-end serving rate: the batch figure excludes the
        # escalation pass, which IS real per-solve work whenever hard lanes
        # flag (round-4 finding: the uncapped 16^3 lockstep re-solve costs
        # ~2.7 s/launch — the true serving bottleneck). Time one
        # steady-state escalation pass over the same padded selection.
        esc_steady = 0.0
        if n_flagged:
            flagged = np.nonzero(flags)[0]
            selp = np.concatenate(
                [flagged,
                 np.repeat(flagged[:1], (ec - flagged.size % ec) % ec)])
            esc_times = []
            for _rep in range(REPEAT):
                t0 = time.perf_counter()
                for c0 in range(0, selp.size, ec):
                    resolve(selp[c0:c0 + ec])
                # The finisher launches are part of the steady serving pass
                # too (they re-fire every pass for lanes the cap leaves
                # unfinished).
                if fin_sel.size:
                    fselp = np.concatenate(
                        [fin_sel,
                         np.repeat(fin_sel[:1],
                                   (ep - fin_sel.size % ep) % ep)])
                    for c0 in range(0, fselp.size, ep):
                        fs = fselp[c0:c0 + ep]
                        tr_sel = jax.tree.map(
                            lambda x: jnp.asarray(np.asarray(x)[fs]), tr_all)
                        out_f = finish_prog(
                            *map(jnp.asarray, (sp[fs], sm_[fs], tp[fs],
                                               tm_[fs], pn[fs])), tr_sel,
                            ecfg)
                        np.asarray(out_f[1])
                esc_times.append(time.perf_counter() - t0)
            esc_steady = min(esc_times)
        e2e_rate = nsat / (nsat / sat_rate + esc_steady)
        log(f"saturated e2e (batch + steady escalation {esc_steady:.2f}s): "
            f"{e2e_rate:.1f} pairs/s")

        fit_pre = np.asarray(out_s[1])  # pre-escalation fitness per pair
        # Per-pair table at the reference's granularity
        # (Main_KSS_List.cpp:151-179 records per-model wall time + metrics):
        # recorded to a side file so the driver JSON line stays one line.
        # Timing is amortized (the batch is one fused program by design).
        per_pair = []
        off = 0
        for label, corpus in corpora:
            for i, (name, _, _) in enumerate(corpus):
                per_pair.append({
                    "name": name, "corpus": label,
                    "rmse": round(float(rm_all[off + i]), 6),
                    "fitness": round(float(fit_all[off + i]), 8),
                    "escalated": bool(fit_pre[off + i] > cfg.escalate_threshold),
                    "amortized_s": round(1.0 / sat_rate, 6),
                })
            off += len(corpus)
        pp_path = Path(__file__).resolve().parent / "BENCH_PAIRS.json"
        pp_path.write_text(json.dumps(
            {"batch": nsat, "pairs_per_sec": round(sat_rate, 4),
             "pairs": per_pair}, indent=1))
        log(f"per-pair table -> {pp_path}")

        off = 0
        for label, corpus in corpora:
            n = len(corpus)
            rm = rm_all[off:off + n]
            fails = [corpus[i][0] for i in np.nonzero(rm > FAIL_RMSE)[0]]
            esc = int(np.sum(fit_pre[off:off + n] > cfg.escalate_threshold))
            log(f"{label}: {n} pairs, escalated={esc}, failures={len(fails)} "
                f"{fails}, median rmse={np.median(rm):.5f}")
            if label != "golden":
                extra_results.update({
                    f"{label}_pairs": n,
                    f"{label}_escalated": esc,
                    f"{label}_failures": len(fails),
                    f"{label}_success_rate": round(1.0 - len(fails) / n, 4),
                    f"{label}_median_rmse": round(float(np.median(rm)), 6),
                })
            off += n
        extra_results.update({
            "value_saturated": round(sat_rate, 4),
            "value_saturated_e2e": round(e2e_rate, 4),
            "escalation_steady_s": round(esc_steady, 3),
            "batch_saturated": nsat,
            "sec_per_pair_saturated": round(1.0 / sat_rate, 6),
            "remesh_protocol": "transfer",
        })
    except Exception as e:  # corpus data unavailable -> skip, don't fail bench
        log(f"saturated corpus unavailable: {e}")

    # --- Room/block-class large scan (VERDICT r4 item 2): the protocol the
    # reference's CUDA binary exists for (EXE/start_Cuda.bat Room runs) —
    # 200k-point procedural room scans, octree pre-downsample to ~80k
    # (Method_Octree.hpp:16), standard register, full-res chunked 1-NN
    # metric. The metric at scan scale is the engine's widest 1-NN. -------
    try:
        from kss_icp.largescan import run_largescan

        ls = run_largescan(n_points=200_000, pre_downsample=80_000,
                           cfg=cfg, repeats=2)
        log(f"largescan 200k: total={ls['total_s']:.2f}s "
            f"(octree {ls['octree_s']:.2f} + register {ls['register_s']:.2f}"
            f" + metric {ls['metric_s']:.2f}), rmse={ls['rmse']:.4f}, "
            f"pose_rmse={ls['pose_rmse']:.4f}, "
            f"metric={ls['metric_pairs_per_s']:.3e} pairs/s")
        # Seed robustness: two more room geometries through the SAME
        # compiled programs (identical shapes) — scan-scale registration
        # must not hinge on one lucky scene.
        seed_poses = [ls["pose_rmse"]]
        for sd in (1, 2):
            ls_s = run_largescan(n_points=200_000, pre_downsample=80_000,
                                 cfg=cfg, seed=sd, repeats=1)
            seed_poses.append(ls_s["pose_rmse"])
        log(f"largescan seeds 0-2 pose_rmse: "
            f"{[round(p, 4) for p in seed_poses]}")
        extra_results["largescan_seed_pose_rmse_max"] = round(
            max(seed_poses), 6)
        extra_results.update({
            "largescan_points": ls["n_points"],
            "largescan_total_s": ls["total_s"],
            "largescan_octree_s": ls["octree_s"],
            "largescan_register_s": ls["register_s"],
            "largescan_metric_s": ls["metric_s"],
            "largescan_rmse": ls["rmse"],
            "largescan_pose_rmse": ls["pose_rmse"],
            "largescan_metric_pairs_per_s": ls["metric_pairs_per_s"],
        })
    except Exception as e:
        log(f"largescan unavailable: {e}")

    # --- Challenge tail (untimed): procedural ModelNet40/SHREC/RGB-D
    # analogues (kss_icp/challenge.py), judged by POSE error against
    # the recorded ground truth. Chunked through the SAME batch-b pipeline
    # program (repetition padding) so no new XLA program compiles.
    challenge_rows = []
    try:
        from kss_icp.challenge import challenge_corpus, transform_rmse
        from kss_icp.core.transforms import apply_similarity

        ecfg = cfg.escalation_config()
        for scenario, cpairs, thr in challenge_corpus(include_hard=True):
            n = len(cpairs)
            csp, csm, ctp, ctm, cpn = batch_arrays(
                [(nm, s, t) for nm, s, t, _ in cpairs])
            total = ((n + b - 1) // b) * b
            idx = np.concatenate([np.arange(n), np.zeros(total - n, np.int64)])
            trs, fits, hits = [], [], []
            for c in range(total // b):
                sl = idx[c * b:(c + 1) * b]
                tr_c, fit_c, hit_c = run_to_completion(tuple(map(
                    jnp.asarray, (csp[sl], csm[sl], ctp[sl], ctm[sl], cpn[sl]))))
                trs.append(jax.tree.map(np.asarray, tr_c))
                fits.append(fit_c)
                hits.append(hit_c)
            tr_ch = jax.tree.map(lambda *xs: np.concatenate(xs)[:n], *trs)
            fit_ch = np.concatenate(fits)[:n]
            hit_ch = np.concatenate(hits)[:n]

            def cresolve(sel, _a=(csp, csm, ctp, ctm, cpn)):
                o2 = pipeline(*map(jnp.asarray, (x[sel] for x in _a)), ecfg)
                p2 = np.asarray(o2[1])
                return (o2[0], p2[:, 1] > 0.5), p2[:, 0]

            ep = cfg.escalate_pad
            ec = ESC_CHUNK
            merged_ch, fit_ch, _, esc_n = escalate_rerun(
                cresolve, fit_ch, cfg.escalate_threshold, pad_multiple=ec,
                result=(tr_ch, hit_ch), chunk=ec,
                cap=max(((n + ec - 1) // ec) * ec, ec),
                flags=(fit_ch > cfg.escalate_threshold) | hit_ch)
            tr_ch, hit_ch = merged_ch
            hit_ch = np.asarray(hit_ch).astype(bool)
            if hit_ch.any():
                def cfinish(fsel, _a=(csp, csm, ctp, ctm, cpn)):
                    tr_sel = jax.tree.map(
                        lambda x: jnp.asarray(np.asarray(x)[fsel]), tr_ch)
                    tot, fit2 = finish_prog(
                        *[jnp.asarray(x[fsel]) for x in _a], tr_sel, ecfg)
                    return tot, np.asarray(fit2)

                tr_ch, fit_ch, _, _ = polish_rerun(
                    cfinish, hit_ch, fit_ch, ep, result=tr_ch, chunk=ep)

            if cfg.overlap_escalate:
                # Overlap tier — the pass that carries the partial
                # (RGB-D-analogue) scenario (VERDICT r3 item 1); three
                # rungs as in the saturated section (field 8^3/16^3 +
                # round-5 screen-seeded).
                rungs_ch = [(cfg.overlap_config(), overlap_prog, "field"),
                            (ecfg.overlap_config(), overlap_prog, "field")]
                if cfg.overlap_screen_rung:
                    rungs_ch.append(
                        (cfg.overlap_config(), overlap_screen_prog,
                         "screen"))
                for ocfg_ch, oprog_ch, otag_ch in rungs_ch:
                    oflags = overlap_flags(
                        fit_ch, tr_ch, (csp, csm, ctp, ctm, cpn), cfg)

                    def coresolve(sel, _a=(csp, csm, ctp, ctm, cpn),
                                  _oc=ocfg_ch, _p=oprog_ch):
                        tr_sel = jax.tree.map(
                            lambda x: jnp.asarray(np.asarray(x)[sel]), tr_ch)
                        return _p(
                            *[jnp.asarray(x[sel]) for x in _a], tr_sel, _oc)

                    tr_ch, fit_ch, owins_ch, o_fl = overlap_rerun(
                        coresolve, fit_ch, cfg.overlap_threshold,
                        cfg.escalate_pad, cfg.overlap_adopt_margin,
                        result=tr_ch, chunk=cfg.escalate_pad, flags=oflags)
                    if o_fl:
                        log(f"challenge/{scenario} overlap rung {otag_ch} "
                            f"{_short_cfg(ocfg_ch)}: {o_fl} flagged, "
                            f"{len(owins_ch)} adopted")
            errs = np.asarray([
                transform_rmse(
                    np.asarray(apply_similarity(
                        jax.tree.map(lambda x, _i=i: jnp.asarray(x[_i]), tr_ch),
                        jnp.asarray(cpairs[i][1], jnp.float32))),
                    cpairs[i][1], cpairs[i][3])
                for i in range(n)])

            # Truth-seeded pose-floor audit (VERDICT r4 item 3): warm-start
            # the final converge at the recorded ground truth and record the
            # pose error it settles at — the measured identifiability floor
            # of each instance (symmetry-breaking bumps leave pose slack the
            # solver cannot remove from ANY start). A solved pose within
            # ~1.2x of its floor is at the instance's precision limit, not a
            # solver miss. Untimed; chunked through the finisher program.
            floors = np.full(n, np.nan)
            try:
                from kss_icp.core.transforms import Similarity

                g_scale = np.array(
                    [1.0 / cpairs[i][3]["s"] for i in range(n)], np.float32)
                g_rot = np.stack(
                    [cpairs[i][3]["R"].T for i in range(n)]).astype(np.float32)
                g_tr = np.stack(
                    [-(cpairs[i][3]["R"].T @ np.asarray(
                        cpairs[i][3]["t"], np.float64)) / cpairs[i][3]["s"]
                     for i in range(n)]).astype(np.float32)
                ep_f = cfg.escalate_pad
                total_f = ((n + ep_f - 1) // ep_f) * ep_f
                idx_f = np.concatenate(
                    [np.arange(n), np.zeros(total_f - n, np.int64)])
                for c0 in range(0, total_f, ep_f):
                    sl = idx_f[c0:c0 + ep_f]
                    tr_gt = Similarity(
                        scale=jnp.asarray(g_scale[sl]),
                        rotation=jnp.asarray(g_rot[sl]),
                        translation=jnp.asarray(g_tr[sl]))
                    tot, _f2 = finish_prog(
                        *map(jnp.asarray, (csp[sl], csm[sl], ctp[sl],
                                           ctm[sl], cpn[sl])), tr_gt, ecfg)
                    tot_np = jax.tree.map(np.asarray, tot)
                    for j, gi in enumerate(sl):
                        if c0 + j < n:
                            floors[gi] = transform_rmse(
                                np.asarray(apply_similarity(
                                    jax.tree.map(lambda x, _j=j:
                                                 jnp.asarray(x[_j]), tot_np),
                                    jnp.asarray(cpairs[gi][1], jnp.float32))),
                                cpairs[gi][1], cpairs[gi][3])
            except Exception as fe:
                log(f"floor audit unavailable for {scenario}: {fe}")

            fails = [cpairs[i][0] for i in np.nonzero(errs > thr)[0]]
            med = float(np.median(errs))
            log(f"challenge/{scenario}: {n} pairs, escalated={esc_n}, "
                f"failures(pose>{thr})={len(fails)} {fails}, "
                f"median pose_rmse={med:.5f}, "
                f"median floor={np.nanmedian(floors):.5f}")
            extra_results.update({
                f"challenge_{scenario}_pairs": n,
                f"challenge_{scenario}_success_rate":
                    round(1.0 - len(fails) / n, 4),
                f"challenge_{scenario}_median_pose_rmse": round(med, 6),
            })
            challenge_rows.extend(
                {"name": cpairs[i][0], "scenario": scenario,
                 "pose_rmse": round(float(errs[i]), 6),
                 "floor_pose_rmse": (round(float(floors[i]), 6)
                                     if np.isfinite(floors[i]) else None),
                 "threshold": thr, "ok": bool(errs[i] <= thr)}
                for i in range(n))
    except Exception as e:
        log(f"challenge corpus unavailable: {e}")

    if challenge_rows:
        # Append to the per-pair side file so the one-line JSON stays one
        # line (same pattern as the saturated per-pair table).
        pp_path = Path(__file__).resolve().parent / "BENCH_PAIRS.json"
        try:
            existing = json.loads(pp_path.read_text()) if pp_path.exists() else {}
        except ValueError:
            existing = {}
        existing["challenge"] = challenge_rows
        pp_path.write_text(json.dumps(existing, indent=1))
        log(f"challenge per-pair pose table -> {pp_path}")

    base_rate, base_src = reference_pairs_per_sec()
    result = {
        "metric": "registration_pairs_per_sec_per_chip",
        "value": round(pairs_per_sec, 4),
        "unit": "pairs/s",
        "vs_baseline": round(pairs_per_sec / base_rate, 2),
        "baseline_pairs_per_sec": base_rate,
        "baseline_source": base_src,
        "batch": b,
        "median_rmse": round(float(np.median(rmses)), 6),
        **extra_results,
        "device": device,
    }
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Batched pair registration sharded over a device mesh.

The ModelNet40/SHREC sweep axis: B independent (source, target) pairs,
vmapped into one program and sharded along "pairs". No collectives cross
pair boundaries, so weak scaling is communication-free by construction —
the accelerator answer to the reference's one-pair-at-a-time Main_KSS_List loop
(Main_KSS_List.cpp:151-179).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from kss_icp.config import DEFAULT_CONFIG, KSSICPConfig
from kss_icp.models.kss_icp import RegistrationResult, register_resampled


def _lcm(a: int, b: int) -> int:
    import math

    return a * b // math.gcd(a, b)


def _vmapped(cfg: KSSICPConfig):
    def one(sp, sm, tp, tm):
        return register_resampled(sp, sm, tp, tm, cfg)

    return jax.vmap(one)


@partial(jax.jit, static_argnames=("cfg", "mesh", "pair_axis"))
def register_batch(
    source_points: jnp.ndarray,   # (B, P, 3)
    source_mask: jnp.ndarray,     # (B, P)
    target_points: jnp.ndarray,   # (B, P, 3)
    target_mask: jnp.ndarray,     # (B, P)
    cfg: KSSICPConfig = DEFAULT_CONFIG,
    mesh: Optional[Mesh] = None,
    pair_axis: str = "pairs",
) -> RegistrationResult:
    """Register B resampled pairs at once.

    With a mesh, the batch axis is split across `pair_axis` devices via
    shard_map: each device runs the whole vmapped pipeline on its LOCAL
    slice of pairs with zero cross-pair communication. shard_map (rather
    than a sharding constraint on a global vmap) is load-bearing: the
    Pallas kernels inside the pipeline see local shapes instead of asking
    the SPMD partitioner to split custom calls. A batch that does not
    divide the axis size is padded by repeating pair 0, and the padding
    rows are dropped from the result.
    """
    args = (source_points, source_mask, target_points, target_mask)
    if mesh is None:
        return _vmapped(cfg)(*args)
    b = source_points.shape[0]
    extra = (-b) % mesh.shape[pair_axis]
    if extra:
        rows = jnp.concatenate([jnp.arange(b), jnp.zeros((extra,), jnp.int32)])
        args = tuple(a[rows] for a in args)
    spec = P(pair_axis)
    out = jax.shard_map(
        _vmapped(cfg),
        mesh=mesh,
        in_specs=(spec, spec, spec, spec),
        out_specs=spec,
        check_vma=False,
    )(*args)
    return jax.tree.map(lambda x: x[:b], out) if extra else out


@partial(jax.jit, static_argnames=("cfg", "mesh", "pair_axis", "solver"))
def overlap_batch(
    source_points: jnp.ndarray,   # (B, P, 3) resampled
    source_mask: jnp.ndarray,
    target_points: jnp.ndarray,
    target_mask: jnp.ndarray,
    baseline,                     # (B,) incumbent Similarity tree
    cfg: KSSICPConfig = DEFAULT_CONFIG,
    mesh: Optional[Mesh] = None,
    pair_axis: str = "pairs",
    solver: str = "field",
):
    """Overlap-tier resolve sharded over the pairs mesh: the escalation
    ladder's heaviest stage must not pin to one device. Same contract as models/kss_icp.overlap_solve_batch; falls back to
    the unmeshed program when B does not divide the axis. solver picks the
    rung: "field" (trimmed-field candidates, rungs 1-2) or "screen" (the
    round-5 screen-seeded rung 3)."""
    from kss_icp.models.kss_icp import (
        overlap_screen_solve_batch,
        overlap_solve_batch,
    )

    solve = overlap_solve_batch if solver == "field" else overlap_screen_solve_batch
    if mesh is not None and source_points.shape[0] % mesh.shape[pair_axis] == 0:
        spec = P(pair_axis)
        fn = jax.shard_map(
            partial(solve, cfg=cfg),
            mesh=mesh,
            in_specs=(spec, spec, spec, spec, spec),
            out_specs=(spec, spec, spec, spec),
            check_vma=False,
        )
        return fn(source_points, source_mask, target_points, target_mask,
                  baseline)
    return solve(source_points, source_mask, target_points,
                 target_mask, baseline, cfg)


def register_many(
    pairs,
    cfg: KSSICPConfig = DEFAULT_CONFIG,
    mesh: Optional[Mesh] = None,
    full_pad: int = 8192,
    escalate: Optional[bool] = None,
    escalate_threshold: Optional[float] = None,
    escalate_cfg: Optional[KSSICPConfig] = None,
):
    """Host-facing batched sweep: [(source (Ns,3), target (Nt,3)), ...] of
    raw variable-size numpy clouds -> (RegistrationResult batch, metrics).

    Pads all clouds to one static shape, FPS-resamples each to its
    reference-rule working size (min(Ns,Nt)//2 capped), registers the whole
    batch as one jitted program (sharded along "pairs" when a mesh is
    given), applies each winning transform to its full-resolution source and
    returns per-pair MSE/RMSE/MAE. This is the Main_KSS_List sweep as a
    single XLA program.

    Escalation (default ON via cfg.auto_escalate) adds a second pass the
    reference does not have: pairs whose final ICP fitness exceeds
    cfg.escalate_threshold (mean squared NN distance — well-aligned
    unit-scale pairs land at 2e-4..1.5e-3) are re-registered on a finer
    rotation grid (cfg.escalation_config(): 16^3 = 4096 rotations with a
    wider candidate budget) and the better fitness wins per pair. Measured
    on 30 adversarial compound-rotation pairs: 0 failures vs 2 for the
    reference-full protocol (BASELINE.md). The flagged subset is padded by
    repetition to a multiple of cfg.escalate_pad so the second pass compiles
    a bounded set of program shapes."""
    import numpy as np

    from kss_icp.models.kss_icp import resample_pairs

    if escalate is None:
        escalate = cfg.auto_escalate
    if escalate_threshold is None:
        escalate_threshold = cfg.escalate_threshold

    def pad(cloud):
        pts = np.asarray(cloud, np.float32)[:full_pad]
        out = np.zeros((full_pad, 3), np.float32)
        out[: len(pts)] = pts
        m = np.zeros((full_pad,), bool)
        m[: len(pts)] = True
        return out, m

    src = [pad(s) for s, _ in pairs]
    tgt = [pad(t) for _, t in pairs]
    s_pts = jnp.asarray(np.stack([x[0] for x in src]))
    s_msk = jnp.asarray(np.stack([x[1] for x in src]))
    t_pts = jnp.asarray(np.stack([x[0] for x in tgt]))
    t_msk = jnp.asarray(np.stack([x[1] for x in tgt]))
    pnum = jnp.asarray(
        [cfg.resample_count(int(a[1].sum()), int(b[1].sum()))
         for a, b in zip(src, tgt)]
    )
    from kss_icp.models.kss_icp import _resolve_aivs_boxes

    cfg = _resolve_aivs_boxes(
        cfg, max(int(x[1].sum()) for x in src + tgt)
    )

    (sp, sm), (tp, tm) = resample_pairs(s_pts, s_msk, t_pts, t_msk, pnum, cfg)
    res = register_batch(sp, sm, tp, tm, cfg, mesh=mesh)

    if cfg.refine_polish_iterations and cfg.refine_max_iterations:
        # Two-stage converge: continue only the lanes whose capped batch
        # converge ran out of budget (see KSSICPConfig.refine_polish_iterations).
        from kss_icp.escalate import polish_rerun
        from kss_icp.models.kss_icp import polish_resampled

        def polish_resolve(sel):
            sel_j = jnp.asarray(sel)
            tot, fit2, _ = jax.vmap(
                lambda a, b, c, d, t: polish_resampled(a, b, c, d, t, cfg)
            )(sp[sel_j], sm[sel_j], tp[sel_j], tm[sel_j],
              jax.tree.map(lambda x: x[sel_j], res.transform))
            return tot, np.asarray(fit2)

        tr_np, fit, _, _ = polish_rerun(
            polish_resolve, np.asarray(res.refine_hit_cap), res.fitness,
            cfg.escalate_pad, result=res.transform,
        )
        res = res._replace(
            transform=jax.tree.map(jnp.asarray, tr_np),
            fitness=jnp.asarray(fit),
        )

    if escalate:
        from kss_icp.escalate import escalate_rerun

        ecfg = escalate_cfg or cfg.escalation_config()

        # Re-register only the flagged pairs (sharded over the pairs mesh
        # when one is supplied — VERDICT r4 item 5: on a pod the escalation
        # pass is the e2e bottleneck, so pinning it to one device compounds
        # the gap; the selection is padded by repetition to a multiple of
        # the mesh size so shard_map always sees a divisible batch).
        esc_pad = ecfg.escalate_pad
        if mesh is not None:
            esc_pad = _lcm(esc_pad, mesh.shape["pairs"])

        def resolve(sel):
            sel_j = jnp.asarray(sel)
            r2 = register_batch(sp[sel_j], sm[sel_j], tp[sel_j], tm[sel_j],
                                ecfg, mesh=mesh)
            return (r2.transform, np.asarray(r2.refine_hit_cap)), \
                np.asarray(r2.fitness)

        # Selection: fitness-flagged pairs, plus — when no polish pass ran —
        # lanes whose capped final converge ran out of budget
        # (refine_hit_cap): an unconverged lane must not ship silently just
        # because its fitness sits under the threshold (ADVICE r3). The
        # escalation solve itself runs under a 128-iteration cap
        # (config.escalation_config), so its OWN hit-cap flag is merged
        # alongside the transform and any lane still unfinished after the
        # keep-better merge — an escalated win that hit the 128 cap, or a
        # capped incumbent the escalation failed to beat — is finished by an
        # uncapped warm-started polish below (ADVICE r4).
        flags = np.asarray(res.fitness) > escalate_threshold
        if not (cfg.refine_polish_iterations and cfg.refine_max_iterations):
            flags = flags | np.asarray(res.refine_hit_cap)
        merged, fit, _, _ = escalate_rerun(
            resolve, res.fitness, escalate_threshold, esc_pad,
            result=(res.transform, np.asarray(res.refine_hit_cap)),
            flags=flags,
        )
        tr_np, hit_np = merged
        res = res._replace(
            transform=jax.tree.map(jnp.asarray, tr_np),
            fitness=jnp.asarray(fit),
            refine_hit_cap=jnp.asarray(hit_np),
        )

        hit_np = np.asarray(hit_np).astype(bool)
        if hit_np.any():
            # Uncapped finisher for lanes still unconverged after the
            # escalation merge (ADVICE r4): warm-started full converge from
            # the current composed transform (polish_resampled with
            # refine_polish_iterations=0 runs to max_icp_iterations).
            from kss_icp.escalate import polish_rerun
            from kss_icp.models.kss_icp import polish_resampled

            def finish_resolve(sel):
                sel_j = jnp.asarray(sel)
                tot, fit2, _ = jax.vmap(
                    lambda a, b, c, d, t: polish_resampled(a, b, c, d, t, ecfg)
                )(sp[sel_j], sm[sel_j], tp[sel_j], tm[sel_j],
                  jax.tree.map(lambda x: jnp.asarray(np.asarray(x))[sel_j],
                               res.transform))
                return tot, np.asarray(fit2)

            tr_np, fit, _, _ = polish_rerun(
                finish_resolve, hit_np, res.fitness, esc_pad,
                result=res.transform)
            res = res._replace(
                transform=jax.tree.map(jnp.asarray, tr_np),
                fitness=jnp.asarray(fit),
                refine_hit_cap=jnp.zeros_like(res.refine_hit_cap),
            )

        if cfg.overlap_escalate:
            # Overlap tier (VERDICT r3 item 1): pairs still fitness-flagged
            # after the fine grid get one overlap-robust re-solve, adopted
            # by the bidirectional trimmed-fitness margin (escalate.
            # overlap_rerun). Full-overlap corpora never reach this tier.
            from kss_icp.escalate import overlap_rerun

            # Two rungs — coarse-grid then fine-grid overlap solves fix
            # COMPLEMENTARY basins (see register_pair); each adoption
            # updates the incumbent the next rung must beat by the margin.
            ep = esc_pad

            def gated_flags():
                # Crop-signature gate (KSSICPConfig.overlap_gate_ratio):
                # only launch the heavy solves where the incumbent's error
                # carries a heavy tail.
                fit_np = np.asarray(res.fitness)
                base = fit_np > cfg.overlap_threshold
                idxs = np.nonzero(base)[0]
                if idxs.size == 0:
                    return base
                selp = np.concatenate(
                    [idxs, np.repeat(idxs[:1], (ep - idxs.size % ep) % ep)])
                out = np.zeros_like(base)
                sel_j = jnp.asarray(selp)
                tfv = np.asarray(_trimmed_fitness_batch(
                    sp[sel_j], sm[sel_j], tp[sel_j], tm[sel_j],
                    jax.tree.map(lambda x: jnp.asarray(x)[sel_j],
                                 res.transform), cfg.overlap_trim_fraction))
                for j, gi in enumerate(selp):
                    if tfv[j] < cfg.overlap_gate_ratio * fit_np[gi]:
                        out[gi] = True
                return out

            rungs = [(cfg.overlap_config(), "field"),
                     (ecfg.overlap_config(), "field")]
            if cfg.overlap_screen_rung:
                rungs.append((cfg.overlap_config(), "screen"))
            for ocfg, osolver in rungs:
                def oresolve(sel, _oc=ocfg, _sv=osolver):
                    sel_j = jnp.asarray(sel)
                    tr_sel = jax.tree.map(
                        lambda x: jnp.asarray(x)[sel_j], res.transform)
                    return overlap_batch(
                        sp[sel_j], sm[sel_j], tp[sel_j], tm[sel_j],
                        tr_sel, _oc, mesh=mesh, solver=_sv)

                tr_np, fit, _, _ = overlap_rerun(
                    oresolve, res.fitness, cfg.overlap_threshold,
                    ep, cfg.overlap_adopt_margin,
                    result=res.transform, chunk=ep, flags=gated_flags(),
                )
                res = res._replace(
                    transform=jax.tree.map(jnp.asarray, tr_np),
                    fitness=jnp.asarray(fit),
                )

    metrics = _measure_batch(res.transform, s_pts, s_msk, t_pts, t_msk)
    return res, {k: np.asarray(v) for k, v in metrics.items()}


# Module-level jits so repeated register_many calls reuse one compiled
# program each instead of tracing and compiling a fresh wrapper per call.
@jax.jit
def _measure_batch(transform, s_pts, s_msk, t_pts, t_msk):
    from kss_icp.core.transforms import apply_similarity
    from kss_icp.metrics import registration_measure_padded

    aligned = jax.vmap(apply_similarity)(transform, s_pts)
    return jax.vmap(partial(registration_measure_padded, chunk=None))(
        aligned, s_msk, t_pts, t_msk)


@partial(jax.jit, static_argnames=("trim_fraction",))
def _trimmed_fitness_batch(sp, sm, tp, tm, transform, trim_fraction):
    from kss_icp.models.kss_icp import trimmed_fitness

    return jax.vmap(lambda a, b, c, d, t: trimmed_fitness(
        t, a, b, c, d, trim_fraction))(sp, sm, tp, tm, transform)

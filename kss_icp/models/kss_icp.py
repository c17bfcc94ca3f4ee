"""The full KSS-ICP registration pipeline.

Accelerator re-design of KSSICP_Registration (KSS_ICP.hpp:69-131):

  1. resample both clouds to pNumber = min(|S|,|T|)//2 (≤2000) — global
     masked FPS instead of AIVS (ops/resample.py);
  2. Kendall pre-shape alignment (core/preshape.py);
  3. exhaustive rotation-grid coarse search + local-minima candidate list
     (models/coarse.py);
  4. multi-start ICP — the reference's serial per-candidate ICP loop
     (KSS_ICP.hpp:100-118) becomes ONE vmapped batched solve; the
     fitness>0.0005 gate (KSS_ICP.hpp:99) is reproduced as a select:
     candidate 0 is always the best grid angle, so "gate passes" = "pick
     candidate 0" and "gate fails" = "pick argmin fitness". The reference's
     final ICP re-run (KSS_ICP.hpp:130) is the chosen candidate's ICP, so no
     second solve is needed;
  5. the winning transform is composed algebraically (Sim3) and applied to
     the full-resolution source in one pass (vs. the reference's repeated
     whole-cloud mutation at :119-125, :222-230).

Everything from step 2 on is a single jitted function of fixed-shape arrays;
it vmaps over a batch of pairs (parallel/batch.py shards that axis over a
device mesh).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from kss_icp.config import DEFAULT_CONFIG, KSSICPConfig
from kss_icp.core.cloud import PointCloud
from kss_icp.core.preshape import middle_align
from kss_icp.core.transforms import (
    Similarity,
    apply_similarity,
    compose,
    euler_xyz_matrix,
)
from kss_icp.models.coarse import CoarseResult, coarse_align
from kss_icp.models.icp import ICPParams, icp
from kss_icp.ops.dispatch import on_cuda
from kss_icp.ops.resample import farthest_point_sampling

_BIG = 1e30


class RegistrationResult(NamedTuple):
    transform: Similarity        # full-resolution source -> target frame
    fitness: jnp.ndarray         # chosen candidate's ICP fitness (mean sq NN dist)
    judge_fitness: jnp.ndarray   # fitness from the best grid angle (the gate probe)
    used_multistart: jnp.ndarray  # bool: gate failed, argmin-fitness candidate used
    chosen_candidate: jnp.ndarray  # int index into coarse.candidate_angles
    icp_iterations: jnp.ndarray  # iterations of the chosen candidate's ICP
    refine_hit_cap: jnp.ndarray  # bool: the final converge ran out of its
    # iteration budget (cfg.refine_max_iterations / max_icp_iterations) —
    # the lane a host-side polish pass (polish_resampled) should continue
    coarse: CoarseResult


@partial(jax.jit, static_argnames=("cfg",))
def register_resampled(
    source_points: jnp.ndarray,
    source_mask: jnp.ndarray,
    target_points: jnp.ndarray,
    target_mask: jnp.ndarray,
    cfg: KSSICPConfig = DEFAULT_CONFIG,
) -> RegistrationResult:
    """Register two already-resampled padded clouds (steps 2-5 above).

    This is the jittable hot path; shapes (P, 3)/(P,). Use jax.vmap over a
    leading batch axis for batched pair registration.
    """
    dtype = source_points.dtype

    # 2. Kendall pre-shape normalization (initRegistrationKSS.hpp:144-220).
    sim0, _, _ = middle_align(source_points, source_mask, target_points, target_mask)
    src_aligned = apply_similarity(sim0, source_points)

    # 3. Rotation-grid coarse search + local minima. Scoring may use a
    # uniform FPS-prefix subsample (cfg.coarse_points, a static slice so
    # the scoring kernel's work actually shrinks); candidates are refined
    # by ICP at full resolution either way.
    score_src, score_mask = src_aligned, source_mask
    if cfg.coarse_points and cfg.coarse_points < source_points.shape[0]:
        score_src = src_aligned[: cfg.coarse_points]
        score_mask = source_mask[: cfg.coarse_points]
    score_tgt, score_tmask = target_points, target_mask
    if cfg.coarse_target_points and cfg.coarse_target_points < target_points.shape[0]:
        # The target is FPS-resampled too, so its prefix is a uniform
        # subsample; thinning it raises every rotation's mean-NN error
        # near-uniformly, preserving the ranking the field exists for.
        score_tgt = target_points[: cfg.coarse_target_points]
        score_tmask = target_mask[: cfg.coarse_target_points]
    coarse = coarse_align(
        score_src,
        score_mask,
        score_tgt,
        score_tmask,
        steps=cfg.rotation_steps,
        span=cfg.angle_span,
        radius=cfg.kernel_radius,
        max_candidates=cfg.max_candidates,
        chunk=cfg.rotation_chunk,
        error_metric=cfg.coarse_error_metric,
        trim_fraction=cfg.coarse_trim_fraction,
    )

    # 4. Batched multi-start ICP over all candidate angles at once.
    r_cand = euler_xyz_matrix(coarse.candidate_angles)  # (K, 3, 3)
    rotated = jnp.einsum("kij,pj->kpi", r_cand, src_aligned, precision=jax.lax.Precision.HIGHEST)
    params = ICPParams.from_config(cfg, dtype)

    tgt_normals = None
    if cfg.icp_variant == "point_to_plane":
        from kss_icp.ops.normals import estimate_normals

        tgt_normals = estimate_normals(target_points, target_mask)

    if cfg.multistart_mode == "two_phase":
        # Screen every candidate with a short, subsampled solve. FPS emits
        # points in pick order, so the first screen_points rows of the
        # resampled source are themselves a uniform subsample — SLICED (not
        # just masked) so the screening NN matmuls are (screen_points, T)
        # instead of (P, T): a masked row still costs a full query row.
        p = source_points.shape[0]
        sp_n = min(cfg.screen_points, p)
        screen_src = rotated[:, :sp_n]
        screen_mask = source_mask[:sp_n]
        screen_tgt, screen_tmask = target_points, target_mask
        st_normals = tgt_normals
        if cfg.screen_target_points and cfg.screen_target_points < target_points.shape[0]:
            # Ranking-only solve: a target FPS-prefix halves every screening
            # correspondence matmul (same argument as coarse_target_points).
            screen_tgt = target_points[: cfg.screen_target_points]
            screen_tmask = target_mask[: cfg.screen_target_points]
            if tgt_normals is not None:
                st_normals = tgt_normals[: cfg.screen_target_points]
        screen_params = params._replace(
            max_iterations=jnp.asarray(cfg.screen_iterations, jnp.int32)
        )
        screen_icp = partial(icp, variant=cfg.icp_variant,
                             target_normals=st_normals,
                             trim_fraction=cfg.icp_trim_fraction,
                             estimate_scale=cfg.icp_estimate_scale)
        res1 = jax.vmap(screen_icp, in_axes=(0, None, None, None, None))(
            screen_src, screen_mask, screen_tgt, screen_tmask, screen_params
        )
        fit1 = jnp.where(coarse.candidate_mask, res1.fitness, _BIG)
        # Candidate 0 (the best grid angle) must survive screening: the
        # fitness gate (KSS_ICP.hpp:99) is defined on it.
        n_refine = min(cfg.refine_candidates, fit1.shape[0])
        sel = jnp.argsort(fit1.at[0].set(-jnp.inf))[:n_refine]
        refine_icp = partial(icp, variant=cfg.icp_variant,
                             target_normals=tgt_normals,
                             trim_fraction=cfg.icp_trim_fraction,
                             estimate_scale=cfg.icp_estimate_scale)
        # Final-converge iteration cap (cfg.refine_max_iterations): bounds
        # the slowest-lane while_loop tail of the batched solve; escalation
        # lifts it for flagged pairs.
        refine_params = params
        if cfg.refine_max_iterations:
            refine_params = params._replace(
                max_iterations=jnp.asarray(
                    min(cfg.refine_max_iterations, cfg.max_icp_iterations),
                    jnp.int32))
        if cfg.refine_tier_iterations:
            # Two-tier refine: capped full-res solve on every selected lane
            # (ranking + gate probe), then full convergence on the single
            # winning lane — the slowest-lane while_loop tail is paid once,
            # not refine_candidates times. The capped lanes may match a
            # target FPS-prefix (refine_tier_target_points): they only rank
            # + warm-start, and the winner re-converges on the full target.
            cap = params._replace(
                max_iterations=jnp.asarray(cfg.refine_tier_iterations, jnp.int32)
            )
            cap_tgt, cap_tmask = target_points, target_mask
            cap_normals = tgt_normals
            rtp = cfg.refine_tier_target_points
            if rtp and rtp < target_points.shape[0]:
                cap_tgt = target_points[:rtp]
                cap_tmask = target_mask[:rtp]
                if tgt_normals is not None:
                    cap_normals = tgt_normals[:rtp]
            cap_icp = partial(icp, variant=cfg.icp_variant,
                              target_normals=cap_normals,
                              trim_fraction=cfg.icp_trim_fraction,
                              estimate_scale=cfg.icp_estimate_scale)
            res_a = jax.vmap(cap_icp, in_axes=(0, None, None, None, None, 0, 0, 0))(
                rotated[sel], source_mask, cap_tgt, cap_tmask, cap,
                res1.rotation[sel], res1.translation[sel], res1.scale[sel],
            )
            fit_a = jnp.where(coarse.candidate_mask[sel], res_a.fitness, _BIG)
            judge_a = fit_a[0]
            if rtp and rtp < target_points.shape[0]:
                # The gate (KSS_ICP.hpp:99) compares an ABSOLUTE threshold,
                # and a prefix target inflates mean squared NN distance —
                # re-evaluate candidate 0's fitness against the FULL target
                # (max_iterations=0 runs no steps, just the warm-started
                # fitness evaluation; one NN pass for one lane).
                probe = refine_icp(
                    rotated[sel][0], source_mask, target_points, target_mask,
                    params._replace(max_iterations=jnp.asarray(0, jnp.int32)),
                    res_a.rotation[0], res_a.translation[0], res_a.scale[0],
                )
                judge_a = jnp.where(coarse.candidate_mask[sel][0],
                                    probe.fitness, _BIG)
            best_a = jnp.argmin(fit_a)
            if cfg.pose_tiebreak_margin:
                al_a = (res_a.scale[:, None, None]
                        * jnp.einsum("kij,kpj->kpi", res_a.rotation,
                                     rotated[sel],
                                     precision=jax.lax.Precision.HIGHEST)
                        + res_a.translation[:, None, :])
                best_a = _pose_tiebreak_select(
                    fit_a, al_a, source_mask, target_points, target_mask, cfg)
            local_a = jnp.where(judge_a <= cfg.multistart_fitness_gate,
                                0, best_a)
            res = refine_icp(
                rotated[sel][local_a], source_mask, target_points, target_mask,
                refine_params, res_a.rotation[local_a],
                res_a.translation[local_a], res_a.scale[local_a],
            )
            choice = sel[local_a]
            icp_sim = Similarity(scale=res.scale, rotation=res.rotation,
                                 translation=res.translation)
            cand_sim = Similarity.from_rigid(r_cand[choice], jnp.zeros((3,), dtype))
            total = compose(icp_sim, compose(cand_sim, sim0))
            fitness_t = res.fitness
            if cfg.neighborhood_fracs:
                # Precision mode: restarts run UNCAPPED (params, not the
                # capped refine_params) — the whole point is converging
                # the narrow basin fully.
                total, fitness_t = _neighborhood_polish(
                    total, fitness_t, source_points, source_mask,
                    target_points, target_mask, params, cfg)
            return RegistrationResult(
                transform=total,
                fitness=fitness_t,
                judge_fitness=judge_a,
                used_multistart=judge_a > cfg.multistart_fitness_gate,
                chosen_candidate=choice,
                icp_iterations=res_a.iterations[local_a] + res.iterations,
                # A lane that converges exactly on its last allowed iteration
                # is NOT capped-out — only flag genuinely unfinished lanes
                # (ADVICE r3: a converged flag wasted a polish dispatch).
                refine_hit_cap=jnp.logical_and(
                    res.iterations >= refine_params.max_iterations,
                    jnp.logical_not(res.converged)),
                coarse=coarse,
            )
        res = jax.vmap(refine_icp, in_axes=(0, None, None, None, None, 0, 0, 0))(
            rotated[sel], source_mask, target_points, target_mask, refine_params,
            res1.rotation[sel], res1.translation[sel], res1.scale[sel],
        )
        fit = jnp.where(coarse.candidate_mask[sel], res.fitness, _BIG)
        final_cap = refine_params.max_iterations
    else:
        sel = jnp.arange(coarse.candidate_angles.shape[0])
        full_icp = partial(icp, variant=cfg.icp_variant,
                           target_normals=tgt_normals,
                           trim_fraction=cfg.icp_trim_fraction,
                           estimate_scale=cfg.icp_estimate_scale)
        full_params = params
        if cfg.refine_max_iterations:
            # The final-converge cap applies in full-multistart mode too —
            # its whole point is bounding the lockstep while_loop tail.
            full_params = params._replace(
                max_iterations=jnp.asarray(
                    min(cfg.refine_max_iterations, cfg.max_icp_iterations),
                    jnp.int32))
        res = jax.vmap(full_icp, in_axes=(0, None, None, None, None))(
            rotated, source_mask, target_points, target_mask, full_params
        )
        fit = jnp.where(coarse.candidate_mask, res.fitness, _BIG)
        final_cap = full_params.max_iterations

    judge_fitness = fit[0]  # slot 0 == best grid angle in both modes
    use_best = judge_fitness <= cfg.multistart_fitness_gate
    best_k = jnp.argmin(fit)
    if cfg.pose_tiebreak_margin:
        al_k = (res.scale[:, None, None]
                * jnp.einsum("kij,kpj->kpi", res.rotation, rotated[sel],
                             precision=jax.lax.Precision.HIGHEST)
                + res.translation[:, None, :])
        best_k = _pose_tiebreak_select(
            fit, al_k, source_mask, target_points, target_mask, cfg)
    local = jnp.where(use_best, 0, best_k)
    choice = sel[local]

    # 5. Compose: full transform = ICP ∘ R_candidate ∘ preshape.
    icp_sim = Similarity(scale=res.scale[local], rotation=res.rotation[local],
                         translation=res.translation[local])
    cand_sim = Similarity.from_rigid(
        r_cand[choice], jnp.zeros((3,), dtype)
    )
    total = compose(icp_sim, compose(cand_sim, sim0))

    fitness_t = fit[local]
    if cfg.neighborhood_fracs:
        total, fitness_t = _neighborhood_polish(
            total, fitness_t, source_points, source_mask,
            target_points, target_mask, params, cfg)

    return RegistrationResult(
        transform=total,
        fitness=fitness_t,
        judge_fitness=judge_fitness,
        used_multistart=jnp.logical_not(use_best),
        chosen_candidate=choice,
        icp_iterations=res.iterations[local],
        refine_hit_cap=jnp.logical_and(
            res.iterations[local] >= final_cap,
            jnp.logical_not(res.converged[local])),
        coarse=coarse,
    )



def _neighborhood_polish(
    total: Similarity,
    fitness: jnp.ndarray,
    source_points: jnp.ndarray,
    source_mask: jnp.ndarray,
    target_points: jnp.ndarray,
    target_mask: jnp.ndarray,
    params,
    cfg: KSSICPConfig,
):
    """Winner-neighborhood precision restarts
    (KSSICPConfig.neighborhood_fracs): re-converge from small Euler
    perturbations of the WINNING pose and keep the best fitness. Exists
    for narrow-basin instances whose best converge point hides inside the
    winner's grid cell (tube/1: fitness 1.22e-3 -> 9.75e-4, pose 0.117 ->
    0.051 with fracs (0.25, 0.5)); a pure keep-better, so it can only
    improve fitness."""
    from kss_icp.models.icp import icp

    step = cfg.angle_span / cfg.rotation_steps
    offs = []
    for f in cfg.neighborhood_fracs:
        for ax in range(3):
            for sgn in (-1.0, 1.0):
                o = [0.0, 0.0, 0.0]
                o[ax] = sgn * f * step
                offs.append(o)
    ro = euler_xyz_matrix(jnp.asarray(offs, source_points.dtype))

    def one(r_off):
        pert = Similarity(scale=total.scale,
                          rotation=r_off @ total.rotation,
                          translation=total.translation)
        cur = apply_similarity(pert, source_points)
        r2 = icp(cur, source_mask, target_points, target_mask, params,
                 trim_fraction=cfg.icp_trim_fraction,
                 estimate_scale=cfg.icp_estimate_scale)
        tot2 = compose(Similarity(scale=r2.scale, rotation=r2.rotation,
                                  translation=r2.translation), pert)
        return tot2, r2.fitness

    tots, fits = jax.vmap(one)(ro)
    k = jnp.argmin(fits)
    better = fits[k] < fitness
    best = jax.tree.map(lambda x: x[k], tots)
    total2 = jax.tree.map(
        lambda a, b: jnp.where(better, a, b), best, total)
    return total2, jnp.minimum(fits[k], fitness)


def _pose_tiebreak_select(
    fit: jnp.ndarray,            # (K,) candidate fitnesses (BIG = invalid)
    aligned: jnp.ndarray,        # (K, P, 3) candidate-aligned source clouds
    source_mask: jnp.ndarray,    # (P,)
    target_points: jnp.ndarray,
    target_mask: jnp.ndarray,
    cfg: KSSICPConfig,
) -> jnp.ndarray:
    """Symmetric-pose tie-break (KSSICPConfig.pose_tiebreak_margin): among
    candidates whose fitness is within (1+margin) of the best, pick the one
    with the smallest pose_tiebreak_quantile NN distance — a slid symmetric
    pose mismatches the shape's symmetry-breaking features locally, which
    barely moves mean squared distance but lifts the high quantile. Replaces
    plain argmin(fit) (the reference contract, KSS_ICP.hpp:100-118) only
    when margin > 0."""
    from kss_icp.ops.nn import masked_quantile_threshold, nearest_neighbor

    fmin = jnp.min(fit)
    near = fit <= fmin * (1.0 + cfg.pose_tiebreak_margin)
    d2, _ = jax.vmap(lambda a: nearest_neighbor(
        a, target_points, target_mask))(aligned)
    q = masked_quantile_threshold(
        jnp.sqrt(d2), jnp.broadcast_to(source_mask, d2.shape),
        cfg.pose_tiebreak_quantile)
    return jnp.argmin(jnp.where(near, q, _BIG))


def trimmed_fitness(
    transform: Similarity,
    source_points: jnp.ndarray,
    source_mask: jnp.ndarray,
    target_points: jnp.ndarray,
    target_mask: jnp.ndarray,
    trim_fraction: float,
    bidirectional: bool = True,
) -> jnp.ndarray:
    """Trimmed mean squared NN distance of the transformed source — the
    overlap-mode goodness metric (mean over the best trim_fraction-quantile
    of valid source points, so non-overlap points don't penalize a correct
    partial alignment). Used for keep-better comparisons between overlap
    and standard solves; both sides must be scored with THIS metric.

    bidirectional adds the target->source direction: a SLID symmetric pose
    can match every trimmed source point into the target's interior while
    leaving target regions uncovered — the reverse direction exposes
    exactly that (measured: the unidirectional metric adopted a slid pose
    on part/se0, round-4 overlap experiment)."""
    from kss_icp.ops.nn import nearest_neighbor, trimmed_masked_mean

    aligned = apply_similarity(transform, source_points)
    d2, _ = nearest_neighbor(aligned, target_points, target_mask)
    fwd = trimmed_masked_mean(d2, source_mask, trim_fraction)
    if not bidirectional:
        return fwd
    d2r, _ = nearest_neighbor(target_points, aligned, source_mask)
    rev = trimmed_masked_mean(d2r, target_mask, trim_fraction)
    return fwd + rev


@partial(jax.jit, static_argnames=("cfg",))
def register_overlap_resampled(
    source_points: jnp.ndarray,
    source_mask: jnp.ndarray,
    target_points: jnp.ndarray,
    target_mask: jnp.ndarray,
    cfg: KSSICPConfig = DEFAULT_CONFIG,
) -> RegistrationResult:
    """Overlap-robust registration of two resampled padded clouds.

    Closes the partial-scan capability gap (the reference showcases RGB-D
    partial scans, README.md:9 / Examples/RGB3D.pdf, yet its Kendall
    pre-shape normalization — initRegistrationKSS.hpp:144-220 — estimates
    centroid and scale from ALL points, so asymmetric crops bias the coarse
    field into the wrong basin). Three generalizations, all mask-native:

      1. the coarse field scores each rotation by the TRIMMED mean NN
         distance (best overlap_trim_fraction quantile) — the crop's
         non-overlap points stop vetoing the true basin;
      2. ICP gates correspondences at the same per-iteration quantile and
         reports trimmed fitness;
      3. the pre-shape is re-estimated on mutual-inlier masks: after a full
         solve, source points far from the target (and target points far
         from the aligned source) are masked out and the whole pipeline —
         normalization included — re-runs on the overlap subset
         (cfg.overlap_iterations unrolled solves, keep-better by trimmed
         fitness on the ORIGINAL masks so the comparison is consistent).

    The returned fitness is the trimmed fitness (compare only against other
    trimmed fitnesses — see escalate.overlap_rerun)."""
    from kss_icp.ops.nn import masked_quantile_threshold, nearest_neighbor

    ocfg = cfg if cfg.overlap_mode else cfg.overlap_config()
    q = ocfg.overlap_trim_fraction

    res = register_resampled(
        source_points, source_mask, target_points, target_mask, ocfg
    )
    best_fit = trimmed_fitness(res.transform, source_points, source_mask,
                               target_points, target_mask, q)

    # The mask-re-estimate iterations run under lax.fori_loop so the heavy
    # pipeline is traced and compiled TWICE in all (initial solve + loop
    # body) regardless of overlap_iterations — an unrolled version costs
    # one more compile of the whole pipeline per extra iteration.
    def body(_, carry):
        res_c, best_c = carry
        aligned = apply_similarity(res_c.transform, source_points)
        d2s, _ = nearest_neighbor(aligned, target_points, target_mask)
        sm_in = source_mask & (
            d2s <= masked_quantile_threshold(d2s, source_mask, q))
        d2t, _ = nearest_neighbor(target_points, aligned, source_mask)
        tm_in = target_mask & (
            d2t <= masked_quantile_threshold(d2t, target_mask, q))
        res2 = register_resampled(
            source_points, sm_in, target_points, tm_in, ocfg
        )
        fit2 = trimmed_fitness(res2.transform, source_points, source_mask,
                               target_points, target_mask, q)
        better = fit2 < best_c
        res_n = jax.tree.map(
            lambda a, b: jnp.where(better, a, b), res2, res_c)
        return res_n, jnp.minimum(fit2, best_c)

    res, best_fit = jax.lax.fori_loop(
        0, max(ocfg.overlap_iterations - 1, 0), body, (res, best_fit))
    return res._replace(fitness=best_fit)


@partial(jax.jit, static_argnames=("cfg",))
def register_overlap_screen_resampled(
    source_points: jnp.ndarray,
    source_mask: jnp.ndarray,
    target_points: jnp.ndarray,
    target_mask: jnp.ndarray,
    cfg: KSSICPConfig = DEFAULT_CONFIG,
) -> RegistrationResult:
    """Screen-seeded overlap solve — the third overlap rung (round 5).

    Why it exists (measured, scripts/se1_*_probe.py): under heavy crops
    the rotation-only trimmed FIELD is the wrong candidate selector — the
    crop-biased pre-shape misplaces translation/scale, so the field error
    at the TRUE rotation can exceed every local minimum's (part/se1:
    field 0.097 at truth vs 0.057-0.093 candidates) even though the
    trimmed ICP's attraction basin contains grid vertices 9-18 deg away
    (nearest 8^3 vertex converges to pose 0.029). The fix: skip the field
    and SCREEN every grid rotation with a short trimmed similarity ICP
    (cfg.overlap_screen_iters iterations on the 512-point FPS prefix —
    each seed corrects its own t/s before being judged), score each
    screened pose by BIDIRECTIONAL trimmed fitness on the full clouds,
    and fully converge only the top cfg.overlap_screen_topk.

    Complementary to the field rungs, not a replacement: on the hard
    (~60% overlap) tier it solves part/se1 (0.334 -> 0.068 pose) and
    rev0/tube1/box pairs, but loses se0/rev1 which the 16^3 field rungs
    solve — the margin-gated adoption keeps the best of both (a wrong
    screen solve has 3x worse bidirectional trimmed fitness than a
    correct incumbent and never adopts).

    Returns the best pose with fitness = its bidirectional trimmed
    fitness (compare only under escalate.overlap_rerun's margin rule).
    """
    from kss_icp.ops.nn import nearest_neighbor, trimmed_masked_mean

    ocfg = cfg if cfg.overlap_mode else cfg.overlap_config()
    q = ocfg.overlap_trim_fraction
    dtype = source_points.dtype

    sim0, _, _ = middle_align(source_points, source_mask,
                              target_points, target_mask)
    src_al = apply_similarity(sim0, source_points)

    from kss_icp.models.coarse import rotation_grid
    from kss_icp.models.icp import ICPParams, icp

    grid = rotation_grid(cfg.overlap_screen_steps, ocfg.angle_span, dtype)
    rots = euler_xyz_matrix(grid)
    params = ICPParams.from_config(ocfg, dtype)
    sparams = params._replace(
        max_iterations=jnp.asarray(cfg.overlap_screen_iters, jnp.int32))

    sp_n = min(cfg.screen_points, source_points.shape[0])
    pre = src_al[:sp_n]
    prem = source_mask[:sp_n]

    hi = jax.lax.Precision.HIGHEST

    def screen_one(r):
        rot = jnp.matmul(pre, r.T, precision=hi)
        res = icp(rot, prem, target_points, target_mask, sparams,
                  trim_fraction=ocfg.icp_trim_fraction,
                  estimate_scale=True)
        full = (res.scale * jnp.matmul(jnp.matmul(src_al, r.T, precision=hi),
                                       res.rotation.T, precision=hi)
                + res.translation)
        d2, _ = nearest_neighbor(full, target_points, target_mask)
        fwd = trimmed_masked_mean(d2, source_mask, q)
        d2r, _ = nearest_neighbor(target_points, full, source_mask)
        rev = trimmed_masked_mean(d2r, target_mask, q)
        return fwd + rev, res.rotation, res.translation, res.scale

    tfit_all, sR, sT, sS = jax.lax.map(
        screen_one, rots, batch_size=cfg.overlap_screen_batch)

    k = min(cfg.overlap_screen_topk, rots.shape[0])
    top = jnp.argsort(tfit_all)[:k]

    def converge_one(ki):
        r = rots[ki]
        rot_src = jnp.matmul(src_al, r.T, precision=hi)
        res = icp(rot_src, source_mask, target_points, target_mask, params,
                  trim_fraction=ocfg.icp_trim_fraction,
                  estimate_scale=True)
        icp_sim = Similarity(scale=res.scale, rotation=res.rotation,
                             translation=res.translation)
        tot = compose(icp_sim, compose(
            Similarity.from_rigid(r, jnp.zeros((3,), dtype)), sim0))
        tb = trimmed_fitness(tot, source_points, source_mask,
                             target_points, target_mask, q)
        return tot, tb, res.iterations

    tots, tbs, iters = jax.vmap(converge_one)(top)
    best = jnp.argmin(tbs)
    tot = jax.tree.map(lambda x: x[best], tots)
    coarse = CoarseResult(
        field=jnp.zeros((1, 1, 1), dtype),
        best_angles=grid[top[best]],
        candidate_angles=grid[top],
        candidate_mask=jnp.ones((k,), bool),
        candidate_errors=tbs,
    )
    return RegistrationResult(
        transform=tot,
        fitness=tbs[best],
        judge_fitness=tbs[best],
        used_multistart=jnp.asarray(True),
        chosen_candidate=top[best],
        icp_iterations=iters[best],
        refine_hit_cap=jnp.asarray(False),
        coarse=coarse,
    )


@partial(jax.jit, static_argnames=("cfg",))
def overlap_screen_solve_batch(
    source_points: jnp.ndarray,   # (B, P, 3) resampled
    source_mask: jnp.ndarray,
    target_points: jnp.ndarray,
    target_mask: jnp.ndarray,
    baseline: Similarity,         # (B,) incumbent transforms
    cfg: KSSICPConfig = DEFAULT_CONFIG,
):
    """Batched screen-seeded overlap rung (escalate.overlap_rerun
    contract, mirroring overlap_solve_batch)."""
    from kss_icp.ops.nn import masked_mean_nn_sqdist

    ocfg = cfg if cfg.overlap_mode else cfg.overlap_config()
    q = ocfg.overlap_trim_fraction

    def one(spi, smi, tpi, tmi, tr0):
        r = register_overlap_screen_resampled(spi, smi, tpi, tmi, cfg)
        tf_old = trimmed_fitness(tr0, spi, smi, tpi, tmi, q)
        aligned = apply_similarity(r.transform, spi)
        fit_std = masked_mean_nn_sqdist(aligned, smi, tpi, tmi)
        return r.transform, fit_std, r.fitness, tf_old

    return jax.vmap(one)(source_points, source_mask, target_points,
                         target_mask, baseline)


@partial(jax.jit, static_argnames=("cfg",))
def overlap_solve_batch(
    source_points: jnp.ndarray,   # (B, P, 3) resampled
    source_mask: jnp.ndarray,
    target_points: jnp.ndarray,
    target_mask: jnp.ndarray,
    baseline: Similarity,         # (B,) incumbent transforms to compare against
    cfg: KSSICPConfig = DEFAULT_CONFIG,
):
    """Batched overlap tier resolve (escalate.overlap_rerun contract):
    vmapped register_overlap_resampled over B flagged pairs, returning
    (transform_tree, fit_std, tfit_new, tfit_old) where the trimmed
    fitnesses of the new solve and the incumbent are computed in the same
    program so the host only compares scalars. cfg must already be an
    overlap config (…escalation_config().overlap_config())."""
    from kss_icp.ops.nn import masked_mean_nn_sqdist

    q = cfg.overlap_trim_fraction

    def one(spi, smi, tpi, tmi, tr0):
        r = register_overlap_resampled(spi, smi, tpi, tmi, cfg)
        tf_old = trimmed_fitness(tr0, spi, smi, tpi, tmi, q)
        aligned = apply_similarity(r.transform, spi)
        fit_std = masked_mean_nn_sqdist(aligned, smi, tpi, tmi)
        return r.transform, fit_std, r.fitness, tf_old

    return jax.vmap(one)(source_points, source_mask, target_points,
                         target_mask, baseline)


@partial(jax.jit, static_argnames=("cfg",))
def polish_resampled(
    source_points: jnp.ndarray,   # (P, 3) resampled source (pipeline frame)
    source_mask: jnp.ndarray,
    target_points: jnp.ndarray,
    target_mask: jnp.ndarray,
    transform: Similarity,        # the capped solve's composed transform
    cfg: KSSICPConfig = DEFAULT_CONFIG,
) -> tuple[Similarity, jnp.ndarray, jnp.ndarray]:
    """Continue a capped final converge (two-stage converge, see
    KSSICPConfig.refine_polish_iterations): warm-start full-resolution ICP
    from the already-composed transform and run up to
    refine_polish_iterations more steps. ICP correspondences depend only on
    current point positions, so restarting from the composed transform
    continues the exact iteration sequence the cap cut short.

    Returns (updated transform, fitness, iterations). vmap over a leading
    batch axis for the batched polish pass.
    """
    dtype = source_points.dtype
    current = apply_similarity(transform, source_points)
    params = ICPParams.from_config(cfg, dtype)._replace(
        max_iterations=jnp.asarray(
            min(cfg.refine_polish_iterations or cfg.max_icp_iterations,
                cfg.max_icp_iterations), jnp.int32))
    tgt_normals = None
    if cfg.icp_variant == "point_to_plane":
        from kss_icp.ops.normals import estimate_normals

        tgt_normals = estimate_normals(target_points, target_mask)
    res = icp(current, source_mask, target_points, target_mask, params,
              variant=cfg.icp_variant,
              target_normals=tgt_normals,
              trim_fraction=cfg.icp_trim_fraction,
              estimate_scale=cfg.icp_estimate_scale)
    total = compose(Similarity(scale=res.scale, rotation=res.rotation,
                               translation=res.translation), transform)
    return total, res.fitness, res.iterations


def _resolve_aivs_boxes(cfg: KSSICPConfig, n_valid: int) -> KSSICPConfig:
    """Pin the AIVS box ladder from the true valid point count (the
    reference rule, ballRegionCompute.hpp:1194) — done on the host so the
    static knob does not depend on an unrelated padding size."""
    if cfg.resampler == "aivs" and cfg.aivs_boxes_per_axis == 0:
        import dataclasses

        from kss_icp.ops.spatial import estimate_box_scale

        return dataclasses.replace(
            cfg, aivs_boxes_per_axis=estimate_box_scale(n_valid)
        )
    return cfg


@partial(jax.jit, static_argnames=("cfg", "pad"))
def resample_batch(
    points: jnp.ndarray,      # (B, N, 3)
    mask: jnp.ndarray,        # (B, N)
    pnumber: jnp.ndarray,     # (B,) traced per-pair working sizes
    cfg: KSSICPConfig = DEFAULT_CONFIG,
    pad: int | None = None,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """FPS-resample a whole batch of padded clouds to (B, resample_pad, 3).

    On the GPU (ops/dispatch.on_cuda), clouds within the
    kernel's on-chip budget (ops/resample_triton.fps_fits) run one program
    per cloud with the whole sample loop inside it; the vmapped plain
    fori_loop launches each of its ~2000 steps separately.
    """
    p = pad if pad is not None else cfg.resample_pad
    n = points.shape[-2]
    if cfg.resampler == "aivs":
        # The reference's default sampler (Method_AIVS_SimPro.hpp), jittable
        # and packed in pick-round order (ops/aivs.aivs_resample_packed).
        # boxes_per_axis must be static: host wrappers (register_pair /
        # register_many) pre-resolve it from the true valid count via
        # _resolve_aivs_boxes; inside jit the padded size is the only
        # static proxy left.
        from kss_icp.ops.aivs import aivs_resample_packed
        from kss_icp.ops.spatial import estimate_box_scale

        nb = cfg.aivs_boxes_per_axis or estimate_box_scale(n)
        pts, smask = jax.vmap(
            lambda pt, m, k: aivs_resample_packed(
                pt, m, k, p, nb, cfg.aivs_max_rounds, cfg.aivs_max_cuts
            )
        )(points, mask, pnumber)
        smask = smask & (jnp.arange(p)[None, :] < pnumber[:, None])
        return pts * smask[..., None].astype(points.dtype), smask
    from kss_icp.ops.resample_triton import fps_batch, fps_fits

    def plain(pt, m):
        return jax.vmap(lambda a, b: farthest_point_sampling(a, b, p))(pt, m)

    if fps_fits(n):
        idx, smask = on_cuda(partial(fps_batch, num_samples=p), plain,
                             points, mask)
    else:
        idx, smask = plain(points, mask)
    smask = smask & (jnp.arange(p)[None, :] < pnumber[:, None])
    pts = jnp.take_along_axis(points, idx[..., None], axis=1)
    return pts * smask[..., None].astype(points.dtype), smask


@partial(jax.jit, static_argnames=("cfg", "pad"))
def resample_pairs(
    source_points: jnp.ndarray,   # (B, N, 3)
    source_mask: jnp.ndarray,
    target_points: jnp.ndarray,   # (B, N, 3) — same padded N
    target_mask: jnp.ndarray,
    pnumber: jnp.ndarray,         # (B,)
    cfg: KSSICPConfig = DEFAULT_CONFIG,
    pad: int | None = None,
):
    """Resample B source+target pairs as ONE 2B-row batch (one kernel
    launch on the GPU). Returns ((src_pts, src_mask), (tgt_pts, tgt_mask))."""
    pts = jnp.concatenate([source_points, target_points], axis=0)
    msk = jnp.concatenate([source_mask, target_mask], axis=0)
    pn2 = jnp.concatenate([pnumber, pnumber], axis=0)
    rp, rm = resample_batch(pts, msk, pn2, cfg, pad)
    b = source_points.shape[0]
    return (rp[:b], rm[:b]), (rp[b:], rm[b:])


@partial(jax.jit, static_argnames=("cfg", "pad"))
def resample_for_registration(
    points: jnp.ndarray,
    mask: jnp.ndarray,
    pnumber: jnp.ndarray,
    cfg: KSSICPConfig = DEFAULT_CONFIG,
    pad: int | None = None,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """FPS-resample a padded cloud to (resample_pad, 3) keeping `pnumber`
    valid samples (pnumber may be traced)."""
    p = pad if pad is not None else cfg.resample_pad
    idx, smask = farthest_point_sampling(points, mask, p)
    smask = smask & (jnp.arange(p) < pnumber)
    return points[idx] * smask[:, None].astype(points.dtype), smask


def register_pair(
    source: Union[PointCloud, np.ndarray],
    target: Union[PointCloud, np.ndarray],
    cfg: KSSICPConfig = DEFAULT_CONFIG,
) -> RegistrationResult:
    """Host-facing single-pair registration (the reference `main` path).

    Accepts raw (N, 3) arrays or padded PointClouds; resamples both via FPS
    and runs the jitted core. The returned transform maps the original
    full-resolution source into the target frame — apply with
    `apply_similarity` and measure with `metrics.registration_measure`.

    With cfg.auto_escalate (the default), a pair whose final fitness exceeds
    cfg.escalate_threshold is re-solved on the finer escalation grid and the
    better result wins — the robustness default that clears the adversarial
    stress corpus 30/30 (BASELINE.md; reference intent KSS_ICP.hpp:99-121).
    """
    dtype = jnp.dtype(cfg.dtype)
    if not isinstance(source, PointCloud):
        source = PointCloud.from_points(source, dtype=dtype)
    if not isinstance(target, PointCloud):
        target = PointCloud.from_points(target, dtype=dtype)

    n_s = int(source.count)
    n_t = int(target.count)
    pnumber = cfg.resample_count(n_s, n_t)
    cfg = _resolve_aivs_boxes(cfg, max(n_s, n_t))

    pn = jnp.asarray([pnumber])
    src_pts, src_mask = resample_batch(
        source.points[None], source.mask[None], pn, cfg
    )
    tgt_pts, tgt_mask = resample_batch(
        target.points[None], target.mask[None], pn, cfg
    )
    if cfg.overlap_mode:
        # Explicit overlap mode (CLI --overlap): the caller knows the scans
        # overlap partially — run the overlap-robust solver directly.
        return register_overlap_resampled(
            src_pts[0], src_mask[0], tgt_pts[0], tgt_mask[0], cfg)
    res = register_resampled(src_pts[0], src_mask[0], tgt_pts[0], tgt_mask[0], cfg)
    if (cfg.refine_polish_iterations and cfg.refine_max_iterations
            and bool(res.refine_hit_cap)):
        # Two-stage converge continuation (KSSICPConfig.refine_polish_iterations).
        tot, fit2, _ = polish_resampled(
            src_pts[0], src_mask[0], tgt_pts[0], tgt_mask[0],
            res.transform, cfg)
        if float(fit2) < float(res.fitness):
            res = res._replace(transform=tot, fitness=fit2)
        # The polish pass is the designated finisher for capped lanes.
        res = res._replace(refine_hit_cap=jnp.asarray(False))
    if cfg.auto_escalate:
        from kss_icp.escalate import escalate_rerun

        def resolve(_sel):
            r2 = register_resampled(
                src_pts[0], src_mask[0], tgt_pts[0], tgt_mask[0],
                cfg.escalation_config(),
            )
            return r2, np.asarray(r2.fitness)[None]

        # Fold in the hit-cap flag: a lane still unconverged after the capped
        # final converge (and any polish pass) must be finished by the
        # uncapped escalation solve, whatever its fitness (ADVICE r3).
        flag = (float(res.fitness) > cfg.escalate_threshold
                or bool(res.refine_hit_cap))
        _, _, wins, _ = escalate_rerun(
            resolve, np.asarray(res.fitness)[None],
            cfg.escalate_threshold, pad_multiple=1,
            flags=np.asarray([flag]),
        )
        if wins:
            res = wins[-1][1]
        if bool(res.refine_hit_cap):
            # The escalation solve itself runs capped (128 iterations,
            # config.escalation_config) — a lane still unconverged after the
            # keep-better merge is finished by an uncapped warm-started
            # continuation (ADVICE r4: no silent-ship one tier up).
            tot, fit2, _ = polish_resampled(
                src_pts[0], src_mask[0], tgt_pts[0], tgt_mask[0],
                res.transform, cfg.escalation_config())
            if float(fit2) < float(res.fitness):
                res = res._replace(transform=tot, fitness=fit2)
            res = res._replace(refine_hit_cap=jnp.asarray(False))
        if (cfg.overlap_escalate
                and float(res.fitness) > cfg.overlap_threshold):
            # Overlap tier (VERDICT r3 item 1): fitness still poor after the
            # fine grid — the signature of a partially-overlapping pair whose
            # crop-biased pre-shape no rotation search can fix. TWO rungs —
            # the coarse-grid solve first, then the fine-grid one — because
            # they fix complementary basins (measured on the ~60%-overlap
            # tier: 16^3 recovers se/rev pairs the 8^3 misses, 8^3 recovers
            # box pairs the 16^3 misses). Adoption at each rung is by the
            # bidirectional trimmed-fitness margin, never plain fitness (a
            # correct partial alignment has WORSE untrimmed fitness than a
            # wrong crop-biased one by construction).
            from kss_icp.ops.nn import masked_mean_nn_sqdist

            a = (src_pts[0], src_mask[0], tgt_pts[0], tgt_mask[0])
            rungs = [(cfg.overlap_config(), register_overlap_resampled),
                     (cfg.escalation_config().overlap_config(),
                      register_overlap_resampled)]
            if cfg.overlap_screen_rung:
                # Third rung (round 5): screen-seeded overlap solve — the
                # field rungs' selector fails under heavy crops (see
                # register_overlap_screen_resampled).
                rungs.append((cfg.overlap_config(),
                              register_overlap_screen_resampled))
            for ocfg, solver in rungs:
                q = ocfg.overlap_trim_fraction
                tf_old = float(trimmed_fitness(res.transform, *a, q))
                # Crop-signature gate (KSSICPConfig.overlap_gate_ratio):
                # skip the heavy solve when the incumbent's error has no
                # heavy tail (full-overlap density floor).
                if tf_old >= cfg.overlap_gate_ratio * float(res.fitness):
                    continue
                res_o = solver(*a, ocfg)
                tf_new = float(res_o.fitness)
                if tf_new < cfg.overlap_adopt_margin * tf_old:
                    aligned = apply_similarity(res_o.transform, a[0])
                    fit_std = masked_mean_nn_sqdist(
                        aligned[None], a[1][None], a[2][None], a[3][None])[0]
                    res = res_o._replace(fitness=fit_std)
    return res

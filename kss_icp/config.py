"""Typed configuration for the registration pipeline.

Carries exactly the reference's knobs with the reference's defaults
(reference: Main_KSS_ICP.cpp:80-81, KSS_ICP.hpp:57-66,99,156-159,
initRegistrationKSS.hpp:35,245-252), plus accelerator controls (padding,
candidate cap, chunk sizes) that have no reference analogue.
"""

from __future__ import annotations

import dataclasses


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class KSSICPConfig:
    """All pipeline knobs. Frozen + hashable so it can be a jit static arg."""

    # --- Rotation-grid coarse search (initRegistrationKSS.hpp) ---
    # Euler angles per axis sweep [0, angle_span) in `rotation_steps` steps.
    # The reference sweeps to 6.3 (≈2π + 0.017) — reproduced verbatim so grid
    # values match (initRegistrationKSS.hpp:245-252).
    rotation_steps: int = 8          # "accurate" param; 8 ⇒ 8^3 = 512 rotations
    angle_span: float = 6.3
    kernel_radius: int = 2           # local-minima cube radius (initRegistrationKSS.hpp:35)
    max_candidates: int = 32         # cap on multi-start local minima (reference: unbounded)
    # Field error metric: "ave" = mean 1-NN distance (the reference main
    # path, initRegistrationKSS.hpp:430-450); "max" = max squared 1-NN
    # distance (:406-428); "diff" = max − mean distance (:452-479). The alt
    # metrics are dead code in the reference main path but declared
    # capability surface.
    coarse_error_metric: str = "ave"

    # --- Resampling (KSS_ICP.hpp:57-66) ---
    # Working size = min(|S|,|T|)//2 clamped to max_resample_points.
    max_resample_points: int = 2000
    resample_pad: int = 2048         # static padded size of resampled clouds
    # Resampling algorithm: "fps" = global farthest-point sampling (strictly
    # more uniform; the default) | "aivs" = the reference's default
    # box-stratified sampler (ops/aivs.py — quota'd lockstep per-box FPS +
    # accurate cut), jit/vmap-friendly and packed in pick-round order so the
    # coarse_points/screen_points prefix-subsample contract still holds.
    resampler: str = "fps"
    aivs_boxes_per_axis: int = 0     # 0 = reference ladder from cloud size
    aivs_max_rounds: int = 128       # lockstep FPS rounds (max per-box quota)
    aivs_max_cuts: int = 256         # accurate-cut budget (round-up slack)

    # --- ICP refinement (KSS_ICP.hpp:156-159, Main_KSS_ICP.cpp:81) ---
    max_icp_iterations: int = 1000
    max_correspondence_distance: float = 1.0
    transformation_epsilon: float = 1e-10   # squared translation-delta threshold (PCL semantics)
    rotation_epsilon: float = 1e-10         # 1 - cos(theta_delta) threshold (PCL pairs it with the above)
    # MSE-delta convergence gate. PCL 1.8 icp.hpp wires
    # setEuclideanFitnessEpsilon to setRelativeMSE — a RELATIVE per-step
    # correspondence-MSE delta — so "relative" IS PCL parity (verified by
    # the CPU oracle, kss_icp/oracle.py). "absolute" implements the
    # stricter absolute-delta reading, which on unit-scale clouds fires
    # after ~3 iterations and freezes ICP far from the optimum (measured:
    # RMSE 0.063 vs 0.0001) — kept as a knob, not the default.
    euclidean_fitness_epsilon: float = 0.001
    fitness_epsilon_mode: str = "relative"  # "relative" | "absolute"
    multistart_fitness_gate: float = 0.0005   # skip multi-start if judge fitness <= gate (KSS_ICP.hpp:99)

    # --- Two-phase multi-start (no reference analogue) ---
    # The reference runs full ICP on EVERY local-minimum candidate serially
    # (KSS_ICP.hpp:100-118). Profiling shows that batched full-resolution
    # multi-start is 94% of pipeline time, driven by the slowest candidate.
    # "two_phase": screen all candidates with a short ICP on the first
    # `screen_points` source points (FPS emits points in pick order, so a
    # prefix IS a uniform subsample), then warm-start only the
    # `refine_candidates` best (candidate 0 always kept for the fitness
    # gate) at full resolution. "full" restores the reference protocol.
    multistart_mode: str = "two_phase"   # "two_phase" | "full"
    screen_iterations: int = 20
    screen_points: int = 512
    refine_candidates: int = 4
    # Two-tier refinement (0 = off): the vmapped refine while_loop costs
    # lanes x slowest-lane iterations (measured max 49 vs median ~6). With
    # N > 0, all refine lanes run a CAPPED N-iteration solve, the winner is
    # selected, and only that single lane converges fully (warm-started) —
    # the 49-iteration tail is paid by 1 lane instead of refine_candidates.
    refine_tier_iterations: int = 0
    # TARGET points the CAPPED refine tier matches against (0 = all). The
    # capped lanes only rank candidates and warm-start the winner — which
    # always re-converges against the FULL target — so their correspondence
    # matmuls may use a target FPS-prefix like the screen stage
    # (resolution-tiered refinement; no reference analogue).
    refine_tier_target_points: int = 0
    # Iteration cap for the final refine convergence (0 = max_icp_iterations,
    # the reference's 1000). A batched while_loop runs to the SLOWEST lane:
    # one non-converging adversarial pair drags the whole batch to 1000
    # full-resolution iterations (measured: 78-pair saturated batch 3.87 s
    # vs 0.40 s with well-behaved lanes). Golden pairs converge in <= 49
    # iterations; pairs that would need more end with poor fitness and are
    # re-solved by auto-escalation (whose config lifts this cap).
    refine_max_iterations: int = 0
    # Two-stage final converge (0 = off). A vmapped while_loop runs every
    # lane in lockstep to the SLOWEST lane, so with a batch of B pairs the
    # whole batch pays worst-lane iterations at full resolution (median
    # lane: ~6; worst: 48+). With N > 0, the host wrappers (register_pair /
    # register_many / bench.py) re-launch ONLY the lanes whose final
    # converge hit refine_max_iterations (RegistrationResult.refine_hit_cap)
    # in a small warm-started polish program capped at N iterations —
    # restarting ICP from the composed transform reproduces the same
    # iteration sequence (correspondences depend only on current
    # positions), so accuracy is preserved while the big batch's cap can
    # drop to ~8. No reference analogue (the reference solves serially,
    # Main_KSS_List.cpp:151-179, so it never pays a lockstep tail).
    # Stays an opt-in experimental knob, OFF in the default config: the
    # serving path finishes capped lanes through the hit-cap -> escalation
    # fold instead. Whether a polish launch costs less than the lockstep
    # tail it saves on the GPU is not measured. It is bit-equivalent on CPU
    # (tests/test_escalate.py) and is the right tool for single-pair hosts
    # without an escalation budget.
    refine_polish_iterations: int = 0
    # ICP error metric. "point_to_point" = reference/PCL parity (Kabsch on
    # matched pairs). "point_to_plane" (Chen & Medioni, NOT in the
    # reference) linearizes against target PCA-normal planes — an opt-in
    # improvement for smooth surfaces with density mismatch.
    icp_variant: str = "point_to_point"

    # --- Auto-escalation (robustness default; reference intent is
    # KSS_ICP.hpp:99-121 — run EVERY local minimum precisely so hard basins
    # survive). The 8^3 grid has intrinsic hard cases (2/30 adversarial
    # compound rotations miss the true basin even with the reference-full
    # protocol, BASELINE.md); pairs whose final ICP fitness exceeds
    # `escalate_threshold` (well-aligned unit-scale pairs land at
    # 2e-4..1.5e-3) are re-registered on the finer `escalate_rotation_steps`
    # grid and the better fitness wins. Measured: clears 30/30 stress pairs;
    # golden pairs never trigger, so steady-state throughput is unchanged.
    auto_escalate: bool = True
    # Fitness gate for the 16^3 re-solve. Measured populations (updated
    # round 5): correct golden/stress solves land at <= 1.50e-3 (golden
    # max: Horse 1.50e-3), wrong-basin symmetric impostors at >= 1.60e-3 —
    # the round-5 corpus growth surfaced rev/6, whose converged impostor
    # sits at 1.600e-3 (base solve) / 1.62e-3 (escalation-grade
    # full-converge table), BELOW the old
    # 1.8e-3 bar (same threshold-blindness class the r4 recalibration
    # fixed for rev/1 and box/2: the true basin ranks FIRST in the
    # escalation solve — fitness 5.68e-4, pose 0.019 — it just never ran).
    # 1.55e-3 sits mid-gap (+3.3% over Horse, -3.1% under rev/6); the gap
    # is thin, so the challenge board and the per-pair remesh poses are the
    # drift tripwires. Density-floor remesh pairs (1.9-2.6e-3) re-escalate
    # each run at zero marginal cost (they join the chunk that already
    # runs) and keep-better preserves their result.
    # KNOWN LIMIT (measured, round 5): the populations CROSS across
    # platforms — se/7's wrong-basin solve converges at 1.496e-3 on CPU
    # (below Horse's correct 1.50e-3) but 1.887e-3 on the accelerator the
    # engine was first built for, so no absolute value separates
    # everywhere. A density-normalized gate (fitness / self-NN floor) was
    # measured and REJECTED — it separates WORSE (wrong solves on bumpy
    # instances land at ratio 0.63, below most correct solves); the
    # base-pipeline pose tiebreak was also measured and does not recover
    # the CPU case (the true basin is not among the base refine
    # candidates). On the H100 the exact-f32 kernels put se/7 at 1.498e-3,
    # as on the CPU (chip_smoke.py, challenge phase); the rest of the GPU's
    # population is not measured (BASELINE.md, cross-platform table).
    escalate_threshold: float = 1.55e-3
    # The overlap tier triggers at the same bar (measured, round 4: the
    # part/box0 wrong-basin solve sits below 3e-3 and shipped wrong —
    # a higher overlap bar re-creates exactly the threshold blindness that
    # hid rev/1 and box/2 from escalation). Density-floor pairs between
    # the bar and 3e-3 do pay the overlap gate probe each run; the margin
    # rule keeps their results untouched, and the cost is bounded 8-lane
    # launches.
    overlap_threshold: float = 1.55e-3
    escalate_rotation_steps: int = 16
    escalate_max_candidates: int = 16
    # --- Escalation-pass fidelity (round 5; VERDICT r4 item 1) ---
    # The r4 escalation pass re-scanned the FULL 16^3 = 4096-rotation grid
    # at full 2048x2048 fidelity, the end-to-end serving bottleneck of that
    # round. The r4 failure analysis showed escalation failures were
    # THRESHOLD blindness, not ranking
    # fidelity: the true basin ranked FIRST in screen and full-converge
    # fitness wherever it was in the candidate list. So the fine field may
    # score on FPS prefixes exactly like the base pass (the field only
    # ranks; every candidate still gets full-resolution ICP refinement).
    # These knobs set the escalation tier's prefix sizes (0 = full
    # fidelity, the r4 behavior). Contract being beaten: the reference's
    # exhaustive grid, initRegistrationKSS.hpp:222-296. Defaults set by
    # the round-5 per-pair parity ladder (78-pair serving corpus, 14
    # flagged lanes): 512/512 keeps per-pair RMSE identical-or-better (two
    # lanes IMPROVE: the prefix field ranks a better basin for Horse/h1
    # 0.0189 -> 0.0104) at a fraction of the field's work; the
    # screen-target prefix (1024) was measured and REJECTED (Angel/h1
    # 0.0187 -> 0.0342), as were the escalation two-tier refine
    # (Armadillo/h1 0.0068 -> 0.0163) and the hit-only->finisher split
    # (five hit lanes regress ~2x: the 16^3 re-solve genuinely improves
    # capped lanes, confirming the r4 hit-fold design).
    escalate_coarse_points: int = 512
    escalate_coarse_target_points: int = 512
    escalate_screen_target_points: int = 0
    # Two-tier refine inside the escalation solve (0 = off = full converge
    # on all escalate refine candidates; N > 0 = capped N-iteration ranking
    # tier + single-lane full converge, same machinery as
    # refine_tier_iterations).
    escalate_refine_tier_iterations: int = 0
    # Escalation re-solve batch is padded (by repetition) to a multiple of
    # this, bounding the number of distinct XLA programs the second pass can
    # compile (shape-specialized jit; each distinct batch size is one more
    # compile of the whole pipeline).
    escalate_pad: int = 8

    # --- Overlap-robust mode (no reference analogue) ---
    # The reference's capability surface includes partially-overlapping
    # RGB-D scene scans (README.md:9, Examples/RGB3D.pdf, EXE/start_Cuda.bat
    # Room/block runs) but its Kendall pre-shape normalization estimates
    # centroid + scale from ALL points (initRegistrationKSS.hpp:144-220), so
    # asymmetric crops bias the coarse field into the wrong basin — a
    # limitation this mode removes with three trims:
    #   coarse field  -> "trim" error metric (best-q quantile of NN dists),
    #   ICP           -> per-iteration q-quantile correspondence gate +
    #                    trimmed fitness (icp_trim_fraction),
    #   pre-shape     -> re-estimated on the mutual-inlier masks of the
    #                    previous solve, iterated (register_overlap_resampled).
    # Reached either explicitly (overlap_mode=True / CLI --overlap) or
    # automatically: the escalation ladder runs the overlap tier for pairs
    # still fitness-flagged after the fine-grid pass (see
    # models/kss_icp.register_overlap_resampled and escalate.py).
    overlap_mode: bool = False
    # Fraction of points assumed mutually visible (the trim quantile). 0.7
    # keeps the gates meaningful down to ~60%-overlap scans while barely
    # perturbing full-overlap solves.
    overlap_trim_fraction: float = 0.7
    # Full re-solves in register_overlap_resampled: solve -> inlier masks ->
    # re-normalized solve, unrolled. 3 (two mask re-estimates) cleared the
    # 60%-overlap tier the 2-iteration variant could not (overlap_experiment
    # r4: se0 pose 1.24 -> 0.025 at 16^3 x3).
    overlap_iterations: int = 3
    # Per-stage trim knobs the overlap config derives from
    # overlap_trim_fraction (exposed so each can be tuned/ablated).
    icp_trim_fraction: float = 0.0
    coarse_trim_fraction: float = 0.7
    # Umeyama similarity ICP (estimate scale per Kabsch step). OFF in the
    # standard pipeline — the reference contract is rigid PCL ICP with the
    # pre-shape carrying scale — but ON in overlap mode, where the
    # crop-biased pre-shape scale is otherwise uncorrectable by rigid ICP.
    icp_estimate_scale: bool = False
    # Auto overlap tier: pairs whose fitness is still above
    # escalate_threshold AFTER the fine-grid escalation get one
    # register_overlap_resampled solve (at the escalation grid), adopted
    # only when its bidirectional trimmed fitness beats the incumbent's by
    # the adopt margin — measured separation (scripts/overlap_experiment):
    # genuine partial-overlap wins land at ratio 0.25-0.66, spurious
    # symmetric slides at 0.73-1.1. Full-overlap corpora never reach the
    # tier (their escalated fitness clears the threshold), so golden/stress
    # throughput and accuracy are untouched.
    overlap_escalate: bool = True
    overlap_adopt_margin: float = 0.7
    # --- Screen-seeded overlap rung (round 5; the third rung) ---
    # Under heavy crops the rotation-only trimmed field is the wrong
    # candidate selector (the biased pre-shape t/s can make the TRUE
    # rotation score worse than every field minimum — measured on
    # part/se1, scripts/se1_truth_seed_probe.py), while the trimmed
    # similarity ICP's attraction basin still contains nearby grid
    # vertices. The third rung screens EVERY 8^3 rotation with a short
    # trimmed ICP (each seed corrects its own t/s before being judged),
    # ranks by bidirectional trimmed fitness, and fully converges the top
    # few (models/kss_icp.register_overlap_screen_resampled). Adoption is
    # margin-gated like the other rungs — wrong screen solves have ~3x
    # worse bidirectional trimmed fitness than correct incumbents and
    # never adopt (measured over the full hard tier,
    # scripts/se1_screen_seed_probe.py).
    overlap_screen_rung: bool = True
    overlap_screen_steps: int = 8
    overlap_screen_iters: int = 8
    overlap_screen_topk: int = 3
    # Rotations per lax.map step. Memory bound: the bidirectional-trim
    # scoring materializes a (2048, 2048) block per in-flight rotation,
    # and a vmapped 8-lane rung multiplies that by the lane count —
    # 16 x 8 lanes x 16.8 MB ~= 2.2 GB peak.
    overlap_screen_batch: int = 16
    # Crop-signature pre-gate: the overlap rungs only launch for flagged
    # pairs whose (bidirectional trimmed fitness) / (standard fitness)
    # ratio is BELOW this — a heavy error tail, the signature of a crop or
    # a wrong basin. Full-overlap pairs stuck at their sampling-density
    # floor score >= 1.19 (uniform error: trimming buys little and the
    # reverse direction adds its own floor), partial incumbents 0.41-0.97
    # (measured r4, serving + partial corpora) — 1.05 sits mid-gap and
    # stops the perpetual floor pairs from paying two overlap solves every
    # serving pass.
    overlap_gate_ratio: float = 1.05

    # --- Winner-neighborhood precision polish (no reference analogue) ---
    # Narrow-basin instances can hide a better converge point INSIDE the
    # winning basin's grid cell: tube/1 ships at fitness 1.22e-3 / pose
    # 0.117 while restarts at ±{1/4, 1/2} grid-step Euler offsets around
    # the winner converge to 9.75e-4 / 0.051 (round-5 measurement) — a
    # basin even the 16^3 escalation grid's
    # candidates miss (its fitness sits below the escalation bar, so no
    # ladder tier can reach it). When non-empty, each fraction f adds 6
    # warm-started full re-converges (±f·step per Euler axis) after the
    # final converge, keep-better by fitness. OFF by default: the serving
    # configs value the ~6 extra full-res lanes/pair more than the
    # precision tail; enable via CLI --precise or in precision-critical
    # pipelines.
    neighborhood_fracs: tuple = ()

    # --- Symmetric-pose tie-break (no reference analogue) ---
    # On near-symmetric shapes several multi-start basins converge to
    # near-tied fitness (mean squared NN distance) while only one has the
    # right POSE: a slid symmetric pose mismatches the shape's
    # symmetry-breaking features locally, which barely moves the mean but
    # lifts the high quantile of NN distances. With margin m > 0, refine
    # candidates whose fitness is within (1+m) of the best are re-ranked by
    # the pose_tiebreak_quantile NN distance; 0 disables (the reference
    # contract: pure argmin fitness, KSS_ICP.hpp:100-118). Enabled in the
    # escalation tier by default (escalate_pose_tiebreak), where the 3
    # round-3 category failures lived.
    pose_tiebreak_margin: float = 0.0
    pose_tiebreak_quantile: float = 0.95
    escalate_pose_tiebreak: float = 0.12

    # --- Numerics / memory (no reference analogue) ---
    dtype: str = "float32"
    rotation_chunk: int = 64         # rotations scored per lax.map step
    # Source points used for rotation-field *scoring* (0 = all). FPS emits
    # points in pick order, so the first K resampled points are themselves a
    # uniform subsample; the field only ranks candidate angles (each gets
    # exact ICP refinement), so scoring on a prefix trades field fidelity
    # for a ~linear cut in coarse-search cost. No reference analogue.
    coarse_points: int = 0
    # TARGET points the rotation field scores against (0 = all). Same
    # prefix-subsample argument on the reference side of the NN: the mean-NN
    # error rises uniformly across rotations when the target thins, so the
    # RANKING the field exists for is preserved. No reference analogue.
    coarse_target_points: int = 0
    # TARGET points the SCREENING ICP matches against (0 = all) — the
    # screening solve only ranks candidates and warm-starts refinement, so
    # its correspondences may use a target prefix too.
    screen_target_points: int = 0
    nn_query_chunk: int = 4096       # query rows per NN chunk for big clouds

    @property
    def num_rotations(self) -> int:
        return self.rotation_steps ** 3

    def resample_count(self, n_source: int, n_target: int) -> int:
        """Working point count: min(|S|,|T|)//2 clamped (KSS_ICP.hpp:57-66)."""
        n = min(n_source, n_target) // 2
        return max(1, min(n, self.max_resample_points))

    def padded_size(self, n: int, multiple: int = 256) -> int:
        return _round_up(max(n, multiple), multiple)

    def overlap_config(self) -> "KSSICPConfig":
        """The overlap-robust solve config (register_overlap_resampled):
        trimmed coarse field + trimmed ICP at overlap_trim_fraction, every
        ranking-only shortcut disabled (robustness tier, same reasoning as
        escalation_config). The rotation grid stays at this config's
        resolution — callers wanting the fine grid compose
        escalation_config().overlap_config()."""
        return dataclasses.replace(
            self,
            overlap_mode=True,
            coarse_error_metric="trim",
            coarse_trim_fraction=self.overlap_trim_fraction,
            icp_trim_fraction=self.overlap_trim_fraction,
            icp_estimate_scale=True,
            coarse_points=0,
            coarse_target_points=0,
            screen_target_points=0,
            refine_tier_iterations=0,
            refine_tier_target_points=0,
            refine_max_iterations=0,
            refine_polish_iterations=0,
            auto_escalate=False,
            # On the plain path each lax.map step of the field materializes
            # a (chunk, P, T) distance block, and batched overlap lanes
            # multiply it — a smaller chunk bounds peak memory at a few
            # hundred MB per 8-lane launch.
            rotation_chunk=min(self.rotation_chunk, 16),
        )

    def escalation_config(self) -> "KSSICPConfig":
        """The finer-grid config used for the fitness-flagged second pass
        (auto_escalate). Ranking shortcuts are reset to the
        escalate_* fidelity knobs (default 0 = full fidelity — the r4
        behavior); the r4 failure analysis showed escalation failures were
        threshold blindness rather than ranking fidelity, so the round-5
        serving config lowers the fine field to prefix fidelity after a
        measured per-pair parity audit (see the escalate_coarse_points
        docstring)."""
        return dataclasses.replace(
            self,
            rotation_steps=self.escalate_rotation_steps,
            max_candidates=self.escalate_max_candidates,
            # 3 refine lanes measured per-pair identical to 4 on all 14
            # flagged serving lanes and ~0.1 s/pass cheaper (r5 probe v2);
            # 2 was measured and rejected (slower — the screen pays more
            # than the lane saves — and Bunnyw moves).
            refine_candidates=max(self.refine_candidates, 3),
            pose_tiebreak_margin=self.escalate_pose_tiebreak,
            coarse_points=self.escalate_coarse_points,
            coarse_target_points=self.escalate_coarse_target_points,
            screen_target_points=self.escalate_screen_target_points,
            refine_tier_iterations=self.escalate_refine_tier_iterations,
            refine_tier_target_points=0,
            # 64 bounds pathological while_loop tails at ZERO measured
            # accuracy cost (r4 probe: per-pair RMSE identical to uncapped
            # at caps 128/64; r5 probe: identical<5e-4 at 64 vs 128 across
            # all 14 flagged serving lanes, ~0.15 s/pass cheaper; cap 48
            # moves Horse/h0 — rejected). Hit-capped lanes flow to the
            # uncapped finisher / overlap tier.
            refine_max_iterations=64,
            refine_polish_iterations=0,
            auto_escalate=False,
        )


DEFAULT_CONFIG = KSSICPConfig()

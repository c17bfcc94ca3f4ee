"""Jitted point-to-point ICP with Kabsch/SVD updates.

Replaces pcl::IterativeClosestPoint as configured by the reference
(KSS_ICP.hpp:155-162: maxCorrDist=1, transformationEpsilon=1e-10,
euclideanFitnessEpsilon=0.001, maxIterations=iter) with a single
`lax.while_loop` whose body is: batched 1-NN correspondence (ops/nn),
distance-gated rejection, weighted Kabsch via 3x3 SVD with determinant
correction, and PCL-style convergence tests. `fitness` follows PCL
getFitnessScore: mean *squared* NN distance over all valid source points.

Because the whole solver is one jitted function of fixed-shape arrays it
vmaps over a candidate axis — the reference's serial multi-start loop
(KSS_ICP.hpp:100-118) becomes one batched solve.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from kss_icp.ops.nn import nearest_neighbor

_HIGHEST = jax.lax.Precision.HIGHEST


def _rotate(points: jnp.ndarray, rotation: jnp.ndarray) -> jnp.ndarray:
    """points @ rotation.T in f32: a default-precision product may run in
    TF32 on the GPU, ~5e-4 relative error in every moved coordinate."""
    return jnp.matmul(points, rotation.T, precision=_HIGHEST)


class ICPParams(NamedTuple):
    max_iterations: jnp.ndarray        # int32
    max_correspondence_distance: jnp.ndarray
    transformation_epsilon: jnp.ndarray   # squared translation-delta gate
    rotation_epsilon: jnp.ndarray         # 1 - cos(angle-delta) gate
    euclidean_fitness_epsilon: jnp.ndarray  # correspondence-MSE delta gate
    relative_mse: jnp.ndarray  # bool: True = relative delta (default), False = PCL absolute

    @classmethod
    def from_config(cls, cfg, dtype=jnp.float32) -> "ICPParams":
        return cls(
            max_iterations=jnp.asarray(cfg.max_icp_iterations, jnp.int32),
            max_correspondence_distance=jnp.asarray(
                cfg.max_correspondence_distance, dtype
            ),
            transformation_epsilon=jnp.asarray(cfg.transformation_epsilon, dtype),
            rotation_epsilon=jnp.asarray(cfg.rotation_epsilon, dtype),
            euclidean_fitness_epsilon=jnp.asarray(
                cfg.euclidean_fitness_epsilon, dtype
            ),
            relative_mse=jnp.asarray(cfg.fitness_epsilon_mode == "relative"),
        )


class ICPResult(NamedTuple):
    rotation: jnp.ndarray     # (3, 3) accumulated rigid rotation
    translation: jnp.ndarray  # (3,)
    fitness: jnp.ndarray      # mean squared NN distance over valid points
    iterations: jnp.ndarray   # int32
    converged: jnp.ndarray    # bool
    scale: jnp.ndarray = None  # (,) accumulated Umeyama scale (1.0 unless
    # estimate_scale — the overlap-mode similarity ICP)


def kabsch(
    source: jnp.ndarray,
    target: jnp.ndarray,
    weights: jnp.ndarray,
    axis_name: str | None = None,
    estimate_scale: bool = False,
):
    """Weighted rigid Kabsch: argmin_R,t sum w_i ||R s_i + t - t_i||^2.

    3x3 SVD with sign correction so R is a proper rotation. This replaces
    PCL's TransformationEstimationSVD.

    With `axis_name` set (inside shard_map over the point axis), all
    reductions psum across shards — the 3x3 cross-covariance is the
    Schur-style collective of SURVEY.md §5.8; the SVD itself is tiny and
    runs replicated. Returns (R (3,3), t (3,)), or (R, t, s) with
    estimate_scale=True — the Umeyama similarity solution
    argmin_{s,R,t} sum w ||s R x + t - y||^2 (s = trace(D S)/var_src).
    The scale path is the overlap-mode extension: an asymmetric crop biases
    the Kendall pre-shape scale (initRegistrationKSS.hpp:144-220 estimates
    it from ALL points) and rigid ICP can never correct it.
    """
    dtype = source.dtype

    def allsum(x):
        return jax.lax.psum(x, axis_name) if axis_name else x

    wsum = jnp.maximum(allsum(jnp.sum(weights)), jnp.finfo(dtype).tiny)
    cs = allsum(
        jnp.einsum("n,ni->i", weights, source, precision=jax.lax.Precision.HIGHEST)
    ) / wsum
    ct = allsum(
        jnp.einsum("n,ni->i", weights, target, precision=jax.lax.Precision.HIGHEST)
    ) / wsum
    s0 = source - cs
    t0 = target - ct
    h = allsum(
        jnp.einsum(
            "n,ni,nj->ij", weights, s0, t0, precision=jax.lax.Precision.HIGHEST
        )
    ) / wsum
    u, sv, vt = jnp.linalg.svd(h, full_matrices=True)
    det = jnp.linalg.det(jnp.matmul(vt.T, u.T, precision=_HIGHEST))
    d = jnp.array([1.0, 1.0, 0.0], dtype) + jnp.array([0.0, 0.0, 1.0], dtype) * det
    r = jnp.matmul(vt.T * d, u.T, precision=_HIGHEST)
    if not estimate_scale:
        return r, ct - jnp.matmul(r, cs, precision=_HIGHEST)
    var_s = allsum(
        jnp.einsum("n,ni,ni->", weights, s0, s0,
                   precision=jax.lax.Precision.HIGHEST)
    ) / wsum
    scale = jnp.sum(sv * d) / jnp.maximum(var_s, jnp.finfo(dtype).tiny)
    t = ct - scale * jnp.matmul(r, cs, precision=_HIGHEST)
    return r, t, scale


def _rodrigues(omega: jnp.ndarray) -> jnp.ndarray:
    """exp([w]x) for a small rotation vector (3,)."""
    dtype = omega.dtype
    theta = jnp.linalg.norm(omega)
    safe = jnp.maximum(theta, jnp.asarray(1e-12, dtype))
    k = omega / safe
    kx = jnp.array(
        [[0.0, -k[2], k[1]], [k[2], 0.0, -k[0]], [-k[1], k[0], 0.0]], dtype
    )
    r = (
        jnp.eye(3, dtype=dtype)
        + jnp.sin(theta) * kx
        + (1.0 - jnp.cos(theta)) * (kx @ kx)
    )
    return jnp.where(theta < 1e-12, jnp.eye(3, dtype=dtype), r)


def point_to_plane_step(
    source: jnp.ndarray,
    target: jnp.ndarray,
    target_normals: jnp.ndarray,
    weights: jnp.ndarray,
    axis_name: str | None = None,
):
    """Linearized point-to-plane update (Chen & Medioni): minimize
    sum w (n·(R p + t − q))² with R ≈ I + [w]x via the 6x6 normal equations.

    Not in the reference (PCL point-to-point only) — an opt-in improvement
    (KSSICPConfig.icp_variant="point_to_plane"): faster convergence on
    smooth surfaces with density mismatch. Normal sign cancels in the
    squared residual, so unoriented PCA normals suffice.
    Returns (R (3,3), t (3,)).
    """
    dtype = source.dtype

    def allsum(x):
        return jax.lax.psum(x, axis_name) if axis_name else x

    n = target_normals
    r = jnp.sum(n * (source - target), axis=-1)  # (N,) signed residuals
    a = jnp.concatenate([jnp.cross(source, n), n], axis=-1)  # (N, 6)
    w = weights[:, None]
    ata = allsum(
        jnp.einsum("ni,nj->ij", a * w, a, precision=jax.lax.Precision.HIGHEST)
    )
    atb = allsum(
        jnp.einsum("ni,n->i", a * w, -r, precision=jax.lax.Precision.HIGHEST)
    )
    # Levenberg damping keeps the 6x6 solve sane when correspondences are
    # degenerate (coplanar normals).
    x = jnp.linalg.solve(ata + 1e-6 * jnp.eye(6, dtype=dtype), atb)
    rot = _rodrigues(x[:3])
    return rot, x[3:]


class _ICPState(NamedTuple):
    rotation: jnp.ndarray
    translation: jnp.ndarray
    scale: jnp.ndarray
    prev_rotation: jnp.ndarray
    prev_translation: jnp.ndarray
    corr_mse: jnp.ndarray
    prev_corr_mse: jnp.ndarray
    iteration: jnp.ndarray
    converged: jnp.ndarray


@partial(jax.jit, static_argnames=("axis_name", "variant", "trim_fraction", "estimate_scale"))
def icp(
    source: jnp.ndarray,
    source_mask: jnp.ndarray,
    target: jnp.ndarray,
    target_mask: jnp.ndarray,
    params: ICPParams,
    init_rotation: jnp.ndarray | None = None,
    init_translation: jnp.ndarray | None = None,
    init_scale: jnp.ndarray | None = None,
    axis_name: str | None = None,
    variant: str = "point_to_point",
    target_normals: jnp.ndarray | None = None,
    trim_fraction: float = 0.0,
    estimate_scale: bool = False,
) -> ICPResult:
    """Run ICP from identity (or a warm-start transform); returns the rigid
    transform source -> target.

    Vmap over a leading axis of `source`/`source_mask` for batched
    multi-start (targets broadcast). `init_*` warm-starts the solve — used
    by the two-phase multi-start to continue a screening-resolution solve at
    full resolution. `axis_name` makes the solve SPMD over a sharded point
    axis (call inside shard_map with source rows split across devices and
    the target replicated): every reduction — Kabsch sums, correspondence
    MSE, fitness — psums over the axis, and the convergence predicates are
    computed from the psum'ed values so control flow stays uniform.

    Correspondence and fitness 1-NN is ops/nn.nearest_neighbor: on the GPU
    the exact-f32 kernel (ops/nn_triton.py) answers, with no per-iteration
    (P, T) distance tensor in device memory; elsewhere the plain path runs
    at HIGHEST precision.

    trim_fraction > 0 enables TRIMMED ICP (overlap mode, no reference
    analogue): each iteration keeps only correspondences within the
    q-quantile of valid NN distances (on top of the absolute
    max_correspondence_distance gate), so non-overlap source points never
    vote in the Kabsch update; the returned fitness is then the trimmed
    mean squared NN distance over the same quantile (the metric a partial
    pair can actually drive to zero).
    """
    if trim_fraction and axis_name is not None:
        # The per-iteration quantile gate and the trimmed fitness sort only
        # the LOCAL shard's distances — combining trimmed ICP with a sharded
        # point axis would silently compute per-shard quantiles (ADVICE r4).
        # A distributed quantile needs an all_gather of the distance vector;
        # unimplemented because overlap mode never shards points.
        raise ValueError(
            "trim_fraction > 0 is incompatible with a sharded point axis "
            "(per-shard quantiles are not global quantiles)")
    dtype = source.dtype
    big = jnp.asarray(jnp.finfo(dtype).max / 4, dtype)
    max_d2 = params.max_correspondence_distance.astype(dtype) ** 2

    def allsum(x):
        return jax.lax.psum(x, axis_name) if axis_name else x

    def cond(st: _ICPState):
        return jnp.logical_and(
            st.iteration < params.max_iterations, jnp.logical_not(st.converged)
        )

    def body(st: _ICPState) -> _ICPState:
        cur = st.scale * _rotate(source, st.rotation) + st.translation
        d2, idx = nearest_neighbor(cur, target, target_mask)
        keep = source_mask & (d2 <= max_d2)
        if trim_fraction:
            from kss_icp.ops.nn import masked_quantile_threshold

            keep = keep & (
                d2 <= masked_quantile_threshold(d2, source_mask, trim_fraction)
            )
        w = keep.astype(dtype)
        corr = target[idx]
        # Delta transform: current positions -> matched targets.
        ds = jnp.asarray(1.0, dtype)
        if variant == "point_to_plane":
            dr, dt = point_to_plane_step(
                cur, corr, target_normals[idx], w, axis_name
            )
        elif estimate_scale:
            dr, dt, ds = kabsch(cur, corr, w, axis_name, estimate_scale=True)
        else:
            dr, dt = kabsch(cur, corr, w, axis_name)
        # new(x) = ds·dr·(s·R·x + t) + dt
        new_r = jnp.matmul(dr, st.rotation, precision=_HIGHEST)
        new_t = ds * jnp.matmul(dr, st.translation, precision=_HIGHEST) + dt
        new_s = ds * st.scale

        wsum = jnp.maximum(allsum(jnp.sum(w)), 1.0)
        # Convergence MSE from the MATCHED pairs, recomputed elementwise in
        # exact f32 (O(P*3), no matmul). The relative-MSE convergence gate
        # compares small deltas, so it reads the elementwise distance, not
        # the plain path's expanded form ||a||^2 + ||b||^2 - 2a·b, which
        # carries cancellation error.
        diff = cur - corr
        d2_exact = jnp.sum(diff * diff, axis=-1)
        corr_mse = allsum(jnp.sum(d2_exact * w)) / wsum

        # PCL DefaultConvergenceCriteria analogue: small incremental motion
        # (translation^2 AND rotation) or small absolute MSE change.
        trans_delta2 = jnp.sum(dt * dt)
        cos_angle = (jnp.trace(dr) - 1.0) / 2.0
        transform_small = jnp.logical_and(
            trans_delta2 < params.transformation_epsilon,
            (1.0 - cos_angle) < params.rotation_epsilon,
        )
        if estimate_scale:
            transform_small = jnp.logical_and(
                transform_small,
                (ds - 1.0) ** 2 < params.transformation_epsilon,
            )
        mse_delta = jnp.abs(corr_mse - st.corr_mse)
        denom = jnp.maximum(corr_mse, jnp.finfo(dtype).tiny)
        mse_small = jnp.where(
            params.relative_mse, mse_delta / denom, mse_delta
        ) < params.euclidean_fitness_epsilon
        converged = jnp.logical_and(
            st.iteration > 0, jnp.logical_or(transform_small, mse_small)
        )
        return _ICPState(
            rotation=new_r,
            translation=new_t,
            scale=new_s,
            prev_rotation=st.rotation,
            prev_translation=st.translation,
            corr_mse=corr_mse,
            prev_corr_mse=st.corr_mse,
            iteration=st.iteration + 1,
            converged=converged,
        )

    eye = jnp.eye(3, dtype=dtype) if init_rotation is None else init_rotation
    zero = jnp.zeros((3,), dtype) if init_translation is None else init_translation
    one = jnp.asarray(1.0, dtype) if init_scale is None else init_scale
    init = _ICPState(
        rotation=eye,
        translation=zero,
        scale=one,
        prev_rotation=eye,
        prev_translation=zero,
        corr_mse=big,
        prev_corr_mse=big,
        iteration=jnp.asarray(0, jnp.int32),
        converged=jnp.asarray(False),
    )
    final = jax.lax.while_loop(cond, body, init)

    aligned = final.scale * _rotate(source, final.rotation) + final.translation
    d2, _ = nearest_neighbor(aligned, target, target_mask)
    if trim_fraction:
        from kss_icp.ops.nn import trimmed_masked_mean

        fitness = trimmed_masked_mean(d2, source_mask, trim_fraction)
    else:
        w = source_mask.astype(dtype)
        fitness = allsum(jnp.sum(d2 * w)) / jnp.maximum(allsum(jnp.sum(w)), 1.0)
    return ICPResult(
        rotation=final.rotation,
        translation=final.translation,
        fitness=fitness,
        iterations=final.iteration,
        converged=final.converged,
        scale=final.scale,
    )

"""Coarse alignment: exhaustive Euler rotation-grid search in pre-shape space.

Re-designs initRegistration_Rotation + initRegistration_kernel
(initRegistrationKSS.hpp:222-296,:481-522) for an accelerator:

  reference: triple nested loop; per rotation, rotate 2000 points on the CPU
             and run 2000 serial k-d-tree queries (~10^6 tree traversals).
  here:      all step^3 rotation matrices are built at once; rotation is one
             batched (C, P, 3) einsum; scoring is a batched masked 1-NN
             (ops/nn.masked_nn_error, the 1-NN kernel on the GPU),
             processed in chunks under lax.map so the (C, P, P) distance
             tensor never fully materializes.

Local-minima extraction (the multi-start candidate list) becomes a 3D
min-pool (`lax.reduce_window`, window (2r+1)^3, SAME padding with +inf —
identical to the reference's clamped-edge cube at grid borders).

Semantics preserved exactly: angle values i*span/steps with span=6.3
(the reference's near-2π quirk), X-then-Y-then-Z application order, mean
1-NN *distance* error, non-strict (<=) local-minimum test.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from kss_icp.core.transforms import euler_xyz_matrix
from kss_icp.ops.nn import masked_nn_error

_BIG = 1e30


class CoarseResult(NamedTuple):
    field: jnp.ndarray            # (steps, steps, steps) mean-NN-distance error
    best_angles: jnp.ndarray      # (3,) Euler angles of the global minimum
    candidate_angles: jnp.ndarray  # (K, 3) local-minimum angles, ascending error
    candidate_mask: jnp.ndarray   # (K,) validity (False once minima run out)
    candidate_errors: jnp.ndarray  # (K,) field values at the candidates


def grid_angles(steps: int, span: float, dtype=jnp.float32) -> jnp.ndarray:
    """Per-axis sweep values i*span/steps, i in [0, steps)
    (initRegistrationKSS.hpp:245-252)."""
    return jnp.arange(steps, dtype=dtype) * (span / steps)


def rotation_grid(steps: int, span: float, dtype=jnp.float32) -> jnp.ndarray:
    """All (steps^3, 3) Euler-angle triples in row-major (i, j, k) order —
    the same visit order as the reference's nested loops."""
    a = grid_angles(steps, span, dtype)
    ii, jj, kk = jnp.meshgrid(a, a, a, indexing="ij")
    return jnp.stack([ii.ravel(), jj.ravel(), kk.ravel()], axis=-1)


@partial(jax.jit, static_argnames=("steps", "chunk", "error_metric", "trim_fraction"))
def score_rotation_field(
    source: jnp.ndarray,
    source_mask: jnp.ndarray,
    target: jnp.ndarray,
    target_mask: jnp.ndarray,
    *,
    steps: int,
    span: float = 6.3,
    chunk: int = 64,
    error_metric: str = "ave",
    trim_fraction: float = 0.7,
) -> jnp.ndarray:
    """Alignment-error field over the full rotation grid.

    source must already be pre-shape aligned (middle_align applied).
    Returns (steps, steps, steps) with field[i, j, k] = the alignment error
    of Rz(k)·Ry(j)·Rx(i)·source to target. error_metric picks among the
    reference's three field flavors (ops/nn.masked_nn_error): "ave" (the
    main-path default, initRegistration_Error_Ave), "max"
    (initRegistration_Error), "diff" (initRegistration_Error_Diff).
    """
    angles = rotation_grid(steps, span, source.dtype)
    rots = euler_xyz_matrix(angles)  # (C_total, 3, 3)
    total = rots.shape[0]

    chunk = min(chunk, total)
    while total % chunk != 0:
        chunk -= 1

    def score_chunk(r_chunk):
        rotated = jnp.einsum("cij,pj->cpi", r_chunk, source,
                             precision=jax.lax.Precision.HIGHEST)
        return masked_nn_error(
            rotated, source_mask[None, :], target[None, :, :],
            target_mask[None, :], metric=error_metric,
            trim_fraction=trim_fraction,
        )

    scores = jax.lax.map(score_chunk, rots.reshape(total // chunk, chunk, 3, 3))
    return scores.reshape(steps, steps, steps)


def local_minima_mask(field: jnp.ndarray, radius: int) -> jnp.ndarray:
    """True where field[i,j,k] <= every value in the clamped (2r+1)^3 cube —
    the initRegistration_kernel test (initRegistrationKSS.hpp:481-522).
    SAME padding with +inf reproduces the reference's border clamping (the
    reference does NOT wrap the angle grid; neither do we)."""
    w = 2 * radius + 1
    pooled = jax.lax.reduce_window(
        field,
        jnp.array(_BIG, field.dtype),
        jax.lax.min,
        window_dimensions=(w, w, w),
        window_strides=(1, 1, 1),
        padding="SAME",
    )
    return field <= pooled


@partial(jax.jit, static_argnames=("steps", "radius", "max_candidates", "chunk", "error_metric", "trim_fraction"))
def coarse_align(
    source: jnp.ndarray,
    source_mask: jnp.ndarray,
    target: jnp.ndarray,
    target_mask: jnp.ndarray,
    *,
    steps: int,
    span: float = 6.3,
    radius: int = 2,
    max_candidates: int = 32,
    chunk: int = 64,
    error_metric: str = "ave",
    trim_fraction: float = 0.7,
) -> CoarseResult:
    """Score the grid, extract local minima, rank candidates by error.

    Candidate 0 is always the global minimum (it is trivially a local
    minimum), so it coincides with the reference's single best angle; the
    remaining candidates are the reference's `angleList` ranked by error and
    capped at max_candidates (the reference keeps all — at step=8 there are
    rarely more than ~30).
    """
    field = score_rotation_field(
        source, source_mask, target, target_mask, steps=steps, span=span,
        chunk=chunk, error_metric=error_metric, trim_fraction=trim_fraction,
    )
    is_min = local_minima_mask(field, radius)

    masked = jnp.where(is_min, field, _BIG).ravel()
    neg_vals, flat_idx = jax.lax.top_k(-masked, max_candidates)
    cand_errors = -neg_vals
    cand_mask = cand_errors < _BIG / 2

    unit = span / steps
    i = flat_idx // (steps * steps)
    j = (flat_idx // steps) % steps
    k = flat_idx % steps
    cand_angles = jnp.stack([i, j, k], axis=-1).astype(field.dtype) * unit

    best_flat = jnp.argmin(field)
    bi = best_flat // (steps * steps)
    bj = (best_flat // steps) % steps
    bk = best_flat % steps
    best_angles = jnp.stack([bi, bj, bk]).astype(field.dtype) * unit

    return CoarseResult(
        field=field,
        best_angles=best_angles,
        candidate_angles=cand_angles,
        candidate_mask=cand_mask,
        candidate_errors=cand_errors,
    )

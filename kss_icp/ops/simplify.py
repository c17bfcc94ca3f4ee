"""Cloud simplification — accelerator equivalents of the reference's CGAL calls
(Method_CGAL.hpp) and the octree downsampler (Method_Octree.hpp).

  - grid_simplify      <- CGAL grid_simplify_point_set (cell = radius/1.5,
                          Method_CGAL.hpp:57-86) and PCL octree voxel keep-
                          nearest-center (Method_Octree.hpp:20-108): both
                          map to ops.resample.voxel_downsample.
  - hierarchy_simplify <- CGAL hierarchy_simplify_point_set
                          (Method_CGAL.hpp:88-121): recursive cluster
                          bisection along the max-variance axis until each
                          cluster is <= max_cluster_size, keeping the point
                          nearest each cluster barycenter. Re-designed as a
                          static-depth sequence of data-parallel segment
                          reductions (one unrolled level per bit of cluster
                          id) — no recursion, no dynamic shapes.
  - wlop lives in ops/wlop.py.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

from kss_icp.ops.resample import voxel_downsample

_BIG = 1e30


def grid_simplify(
    points: jnp.ndarray, mask: jnp.ndarray, cell_size
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """One representative (nearest voxel center) per occupied voxel."""
    return voxel_downsample(points, mask, jnp.asarray(cell_size, points.dtype))


@partial(jax.jit, static_argnames=("max_cluster_size", "max_variation"))
def hierarchy_simplify(
    points: jnp.ndarray,
    mask: jnp.ndarray,
    max_cluster_size: int = 10,
    max_variation: float = 1.0 / 3.0,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Variance-split hierarchy clustering; keep the point nearest each
    cluster barycenter. Returns (points, keep_mask) of the input's padded
    shape.

    A cluster splits while its size exceeds `max_cluster_size` OR its
    surface variation λ0/(λ0+λ1+λ2) (smallest covariance eigenvalue over
    the trace) exceeds `max_variation` — CGAL hierarchy_simplify_point_set's
    two stop criteria (Method_CGAL.hpp:88-121, `size(paSize).
    maximum_variation(surVar)`). 1/3 is the eigenvalue-ratio maximum, so the
    default disables the variation stop (size-only, CGAL's default too).
    Static depth ceil(log2(P)): enough capacity for fully unbalanced splits
    (a cluster stops splitting the moment it satisfies both criteria, so
    extra levels are no-ops — the earlier P/max_cluster_size bound silently
    under-split skewed clouds).
    """
    p = points.shape[0]
    dtype = points.dtype
    depth = max(1, math.ceil(math.log2(max(2, p))))
    use_variation = max_variation < 1.0 / 3.0
    w = mask.astype(dtype)

    cluster = jnp.zeros((p,), jnp.int32)  # all valid points start together
    for level in range(depth):
        n_seg = 1 << level
        # Per-cluster mean and variance along each axis (masked).
        count = jax.ops.segment_sum(w, cluster, num_segments=n_seg)
        count_safe = jnp.maximum(count, 1.0)
        mean = (
            jax.ops.segment_sum(points * w[:, None], cluster, num_segments=n_seg)
            / count_safe[:, None]
        )
        centered = (points - mean[cluster]) * w[:, None]
        var = (
            jax.ops.segment_sum(
                centered * centered, cluster, num_segments=n_seg
            )
            / count_safe[:, None]
        )
        axis = jnp.argmax(var, axis=1)  # (n_seg,)
        split_axis = axis[cluster]  # (p,)
        coord = jnp.take_along_axis(points, split_axis[:, None], axis=1)[:, 0]
        threshold = jnp.take_along_axis(mean, axis[:, None], axis=1)[:, 0][cluster]
        # Split while above the size cap OR (surVar stop active) above the
        # surface-variation cap — a splittable cluster needs >= 2 points.
        needs_split_seg = count > max_cluster_size
        if use_variation:
            # Full 3x3 covariance eigenvalues per cluster.
            outer = jnp.einsum("pi,pj->pij", centered, centered)
            cov = (
                jax.ops.segment_sum(outer, cluster, num_segments=n_seg)
                / count_safe[:, None, None]
            )
            eig = jnp.linalg.eigvalsh(cov)  # ascending
            trace = jnp.maximum(jnp.sum(eig, axis=-1), jnp.finfo(dtype).tiny)
            variation = eig[:, 0] / trace
            needs_split_seg = needs_split_seg | (
                (variation > max_variation) & (count > 1)
            )
        needs_split = needs_split_seg[cluster]
        side = jnp.where(needs_split & (coord > threshold), 1, 0)
        cluster = cluster * 2 + side

    n_seg = 1 << depth
    count = jax.ops.segment_sum(w, cluster, num_segments=n_seg)
    mean = (
        jax.ops.segment_sum(points * w[:, None], cluster, num_segments=n_seg)
        / jnp.maximum(count, 1.0)[:, None]
    )
    d2 = jnp.sum((points - mean[cluster]) ** 2, axis=1)
    d2 = jnp.where(mask, d2, _BIG)
    best = jax.ops.segment_min(d2, cluster, num_segments=n_seg)
    # Nearest-to-barycenter point per cluster; break distance ties by index.
    is_best = mask & (d2 <= best[cluster])
    idx = jnp.arange(p, dtype=jnp.int32)
    first_best = jax.ops.segment_min(
        jnp.where(is_best, idx, p), cluster, num_segments=n_seg
    )
    keep = is_best & (idx == first_best[cluster])
    return points * keep[:, None].astype(dtype), keep


def octree_simplify(
    points: jnp.ndarray,
    mask: jnp.ndarray,
    target_points: int = 80000,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """PCL-octree-style voxel downsample with resolution chosen for a target
    count (Method_Octree.hpp:148-165 picks resolution from sampled kNN radii;
    here: bbox volume / target gives the cell edge directly)."""
    dtype = points.dtype
    big = jnp.where(mask[:, None], points, _BIG)
    small = jnp.where(mask[:, None], points, -_BIG)
    extent = jnp.max(small, axis=0) - jnp.min(big, axis=0)
    # Surface scaling: occupied voxels ~ (diag/cell)^2, so cell ~ diag/sqrt(N).
    diag = jnp.linalg.norm(extent)
    cell = diag / jnp.sqrt(jnp.asarray(float(target_points), dtype))
    return voxel_downsample(points, mask, cell)

"""Uniform resampling ops.

The reference's AIVS pipeline (Method_AIVS_SimPro.hpp: 8-color voxel
schedule + per-box local k-d-tree farthest-point sampling + pair-deletion
trim to exact N) exists to make *CPU* FPS tractable by localizing it. On an
accelerator the localization is unnecessary: global masked farthest-point sampling
is one `fori_loop` whose per-step work (distance update + argmax over all
points) is a wide vector op, it is exactly-N by construction (no
AccurateCut trim pass needed), and it vmaps over a batch of clouds. Its
uniformity is strictly better than AIVS's blockwise approximation.

`voxel_downsample` reproduces the BallRegion/Octree "keep the real point
nearest each occupied voxel center" reduction (ballRegionCompute.hpp:632-688
nearest-to-center tracking, Method_Octree.hpp:20-108) as a sort-based
segmented argmin — static shapes, jit-safe.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

_BIG = 1e30


@partial(jax.jit, static_argnames=("num_samples",))
def farthest_point_sampling(
    points: jnp.ndarray,
    mask: jnp.ndarray,
    num_samples: int,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Greedy farthest-point sampling over valid points.

    Returns (indices (num_samples,), sample_mask (num_samples,)).
    Deterministic: the first sample is the valid point farthest from the
    masked centroid. If fewer valid points than num_samples exist, the tail
    is masked out.
    """
    p = points.shape[0]
    dtype = points.dtype
    w = mask.astype(dtype)
    count = jnp.sum(w)
    centroid = jnp.sum(points * w[:, None], axis=0) / jnp.maximum(count, 1.0)
    d2c = jnp.sum((points - centroid) ** 2, axis=-1)
    first = jnp.argmax(jnp.where(mask, d2c, -1.0))

    # min_d2[i] = squared distance from point i to its nearest chosen sample.
    init_min_d2 = jnp.where(mask, jnp.full((p,), _BIG, dtype), -1.0)

    def body(s, state):
        min_d2, current, indices = state
        indices = indices.at[s].set(current)
        d2 = jnp.sum((points - points[current]) ** 2, axis=-1)
        min_d2 = jnp.minimum(min_d2, jnp.where(mask, d2, -1.0))
        nxt = jnp.argmax(min_d2).astype(jnp.int32)
        return min_d2, nxt, indices

    indices = jnp.zeros((num_samples,), dtype=jnp.int32)
    _, _, indices = jax.lax.fori_loop(
        0, num_samples, body, (init_min_d2, first.astype(jnp.int32), indices)
    )
    sample_mask = jnp.arange(num_samples) < jnp.minimum(count, num_samples)
    return indices, sample_mask


@partial(jax.jit, static_argnames=("num_samples",))
def fps_points(
    points: jnp.ndarray, mask: jnp.ndarray, num_samples: int
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """FPS returning gathered (num_samples, 3) points + mask."""
    idx, smask = farthest_point_sampling(points, mask, num_samples)
    return points[idx] * smask[:, None].astype(points.dtype), smask


@partial(jax.jit, static_argnames=())
def voxel_downsample(
    points: jnp.ndarray,
    mask: jnp.ndarray,
    cell_size: jnp.ndarray,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Keep, per occupied voxel, the real point nearest the voxel center.

    Returns (points, mask) of the same padded shape with survivors marked.
    Sort-based: points sorted by (voxel key, distance-to-center); the first
    element of each key run survives. No dynamic shapes, no scatter races —
    this is the accelerator answer to the reference's 8-color conflict-free box
    schedule (Method_AIVS_SimPro.hpp:587-643): sorting removes the conflicts
    the coloring existed to avoid.
    """
    dtype = points.dtype
    lo = jnp.min(jnp.where(mask[:, None], points, _BIG), axis=0)
    cell = jnp.maximum(cell_size, jnp.finfo(dtype).tiny)
    ijk = jnp.floor((points - lo) / cell).astype(jnp.int32)
    ijk = jnp.clip(ijk, 0, 2_000_000)

    center = lo + (ijk.astype(dtype) + 0.5) * cell
    d2c = jnp.sum((points - center) ** 2, axis=-1)

    # Three int32 key columns (no int64 — must run without jax_enable_x64);
    # padding rows get a sentinel beyond the clip range so they sort last.
    key = jnp.where(mask[:, None], ijk, 2_100_000)
    order = jnp.lexsort((d2c, key[:, 2], key[:, 1], key[:, 0]))
    k_sorted = key[order]
    is_first = jnp.concatenate(
        [jnp.ones((1,), bool),
         jnp.any(k_sorted[1:] != k_sorted[:-1], axis=-1)]
    )
    keep_sorted = is_first & mask[order]
    out_pts = points[order] * keep_sorted[:, None].astype(dtype)
    return out_pts, keep_sorted

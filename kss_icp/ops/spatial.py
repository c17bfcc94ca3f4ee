"""Voxel-grid spatial index — the accelerator re-design of the reference's
`BallRegion` (ballRegionCompute.hpp, classes BallRegion/Point_Index).

The reference's BallRegion is a mutable uniform voxel grid: per-box point
lists (`squareBoxes`), box centers and the real point nearest each center
(`squareBoxesCReal/Center`), a per-point kNN cache (`pointNeibor`), a global
support radius (max 12-NN distance), and 26-neighbor box queries feeding the
AIVS resampler's 8-color schedule. Pointer-y jagged lists are hostile to
XLA, so here the same state is dense, static-shape tensors:

  - box membership = one int id per point (sorted/segment ops instead of
    per-box vectors);
  - per-box reductions (count, center-nearest point) = segment_min/sum over
    box ids — no scatter races, which is what the reference's 8-coloring
    existed to prevent;
  - the kNN cache = one (P, k) top-k over a dense pairwise-distance matmul
    instead of P FLANN traversals;
  - neighbor-box queries = static index arithmetic on the (B, 27) stencil.

Everything jits and vmaps over a batch of clouds.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from kss_icp.ops.nn import knn

_BIG = 1e30


def estimate_box_scale(point_count: int) -> int:
    """Boxes-per-axis ladder (ballRegionCompute.hpp:1194-1214)."""
    if point_count < 10_000:
        return 10
    if point_count < 50_000:
        return 20
    if point_count < 100_000:
        return 30
    if point_count < 500_000:
        return 40
    if point_count < 1_000_000:
        return 50
    return int(round((point_count / 8.0) ** (1.0 / 3.0)))


class VoxelGrid(NamedTuple):
    """Dense BallRegion state. B = boxes_per_axis**3 total boxes.

    Mirrors: squareBoxes (via box_id + segment ops), squareBoxesCenter
    (centers), squareBoxesCReal (center_point), XYZNumber/minXYZ/unitSize
    (ballRegionCompute.hpp:28-42, 632-758).
    """

    box_id: jnp.ndarray       # (P,) int32 flat box index per point (-1 on padding)
    counts: jnp.ndarray       # (B,) int32 valid points per box
    centers: jnp.ndarray      # (B, 3) geometric box centers
    center_point: jnp.ndarray  # (B,) int32 index of valid point nearest center (P if empty)
    occupied: jnp.ndarray     # (B,) bool
    lo: jnp.ndarray           # (3,) grid origin (AABB min)
    unit: jnp.ndarray         # (3,) per-axis box edge length

    @property
    def num_boxes(self) -> int:
        return self.counts.shape[0]


@partial(jax.jit, static_argnames=("boxes_per_axis",))
def build_voxel_grid(
    points: jnp.ndarray,
    mask: jnp.ndarray,
    boxes_per_axis: int,
) -> VoxelGrid:
    """Scatter a padded cloud into a boxes_per_axis³ grid over its AABB
    (BallRegion_AchieveXYZ :690-758 + BallRegion_BoxInput :632-688)."""
    p = points.shape[0]
    dtype = points.dtype
    nb = boxes_per_axis
    b = nb ** 3

    lo = jnp.min(jnp.where(mask[:, None], points, _BIG), axis=0)
    hi = jnp.max(jnp.where(mask[:, None], points, -_BIG), axis=0)
    extent = jnp.maximum(hi - lo, jnp.finfo(dtype).eps)
    unit = extent / nb

    ijk = jnp.clip(jnp.floor((points - lo) / unit).astype(jnp.int32), 0, nb - 1)
    flat = (ijk[:, 0] * nb + ijk[:, 1]) * nb + ijk[:, 2]
    box_id = jnp.where(mask, flat, -1)

    seg = jnp.where(mask, flat, b)  # padding lands in a dump segment
    counts = jax.ops.segment_sum(
        mask.astype(jnp.int32), seg, num_segments=b + 1
    )[:b]

    axes = jnp.arange(nb, dtype=dtype)
    ci = lo[0] + (axes + 0.5) * unit[0]
    cj = lo[1] + (axes + 0.5) * unit[1]
    ck = lo[2] + (axes + 0.5) * unit[2]
    centers = jnp.stack(
        jnp.meshgrid(ci, cj, ck, indexing="ij"), axis=-1
    ).reshape(b, 3)

    # Nearest valid point to each box's center (squareBoxesCReal).
    my_center = lo + (ijk.astype(dtype) + 0.5) * unit
    d2c = jnp.sum((points - my_center) ** 2, axis=-1)
    d2c = jnp.where(mask, d2c, _BIG)
    best = jax.ops.segment_min(d2c, seg, num_segments=b + 1)[:b]
    idx = jnp.arange(p, dtype=jnp.int32)
    is_best = mask & (d2c <= best[jnp.clip(flat, 0, b - 1)])
    center_point = jax.ops.segment_min(
        jnp.where(is_best, idx, p), seg, num_segments=b + 1
    )[:b]
    # segment_min's identity for untouched segments is int32 max; empty boxes
    # report the sentinel P instead.
    center_point = jnp.minimum(center_point, p)

    return VoxelGrid(
        box_id=box_id,
        counts=counts,
        centers=centers,
        center_point=center_point,
        occupied=counts > 0,
        lo=lo,
        unit=unit,
    )


@partial(jax.jit, static_argnames=("k",))
def estimate_radius(
    points: jnp.ndarray, mask: jnp.ndarray, k: int = 12
) -> jnp.ndarray:
    """Global support radius = max over valid points of the k-NN distance
    (BallRegion_EstimateRadius_KDTree :477-530, pointNumEsti=12). One dense
    top-k instead of P tree queries; self-match excluded via k+1."""
    d2, _ = knn(points, points, mask, k + 1)
    kth = jnp.sqrt(d2[:, -1])
    return jnp.max(jnp.where(mask, kth, -1.0))


@partial(jax.jit, static_argnames=("k",))
def knn_cache(
    points: jnp.ndarray, mask: jnp.ndarray, k: int
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-point k nearest *other* points — the `pointNeibor` cache
    (ballRegionCompute.hpp:477-530). Returns (distances (P,k), indices (P,k))."""
    d2, idx = knn(points, points, mask, k + 1)
    return jnp.sqrt(d2[:, 1:]), idx[:, 1:]


def box_coloring(boxes_per_axis: int) -> jnp.ndarray:
    """(B,) parity color 0..7 per box — the AIVS conflict-free schedule
    (Method_AIVS_SimPro.hpp:587-643). Retained for host-side scatter
    scheduling; the jitted ops don't need it (segment ops are race-free)."""
    nb = boxes_per_axis
    r = jnp.arange(nb)
    i, j, k = jnp.meshgrid(r, r, r, indexing="ij")
    return ((i % 2) * 4 + (j % 2) * 2 + (k % 2)).reshape(-1).astype(jnp.int32)


def neighbor_box_ids(boxes_per_axis: int) -> jnp.ndarray:
    """(B, 27) flat ids of each box's 3³ neighborhood (self included),
    -1 where the stencil leaves the grid — BallRegion_ReturnNeiborBox
    (ballRegionCompute.hpp:852-1102) as one static stencil table."""
    nb = boxes_per_axis
    r = jnp.arange(nb)
    i, j, k = jnp.meshgrid(r, r, r, indexing="ij")
    ijk = jnp.stack([i, j, k], axis=-1).reshape(-1, 3)  # (B, 3)
    d = jnp.arange(-1, 2)
    di, dj, dk = jnp.meshgrid(d, d, d, indexing="ij")
    offsets = jnp.stack([di, dj, dk], axis=-1).reshape(-1, 3)  # (27, 3)
    nbr = ijk[:, None, :] + offsets[None, :, :]  # (B, 27, 3)
    valid = jnp.all((nbr >= 0) & (nbr < nb), axis=-1)
    flat = (nbr[..., 0] * nb + nbr[..., 1]) * nb + nbr[..., 2]
    return jnp.where(valid, flat, -1).astype(jnp.int32)


def points_in_neighborhood(
    grid: VoxelGrid, boxes_per_axis: int, box: int
) -> jnp.ndarray:
    """(P,) bool mask of points whose box lies in `box`'s 3³ neighborhood —
    the gather AIVS used to build per-box local trees
    (Method_AIVS_SimPro.hpp:257-270). Mask-based: no dynamic shapes."""
    nbrs = neighbor_box_ids(boxes_per_axis)[box]  # (27,)
    return jnp.any(
        (grid.box_id[:, None] == nbrs[None, :]) & (nbrs[None, :] >= 0), axis=-1
    )

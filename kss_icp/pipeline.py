"""Preprocessing facade — the reference's `pointPipeline` (pointPipeline.hpp).

The reference exposes three init paths:
  1. from file, with [-1,1]³ uniform normalization, a `.normal` sidecar
     cache, and a BallRegion build (pointPipeline.hpp:40-68);
  2. from in-memory points, with PCL normals (:70-86);
  3. `pointPipeline_init_point_withoutUniform` (:88-101) — the registration
     path: AABB border only + BallRegion without normals.

Here the same three entries return an immutable `PipelineState` of padded
device arrays: points+mask, optional oriented normals, the voxel grid
(ops/spatial.py = BallRegion), the global support radius, and the AABB
border indices. The `.normal` sidecar is kept (same count format, readable
by the reference) and is additionally backed by a content-hashed cache that
cannot go stale (SURVEY.md §5.4 — the reference keys on filename only).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional, Union

import numpy as np

from kss_icp.io.formats import (
    UniformInfo,
    border_indices,
    load_normals,
    load_points,
    save_normals,
    uniform_normalize,
)
from kss_icp.ops.spatial import (
    VoxelGrid,
    build_voxel_grid,
    estimate_box_scale,
    estimate_radius,
)
from kss_icp.utils.cache import ArrayCache, content_key

PathLike = Union[str, Path]


@dataclasses.dataclass
class PipelineState:
    """BallRegion-equivalent preprocessing product (padded, device-ready)."""

    points: np.ndarray            # (P, 3) padded
    mask: np.ndarray              # (P,) bool
    count: int                    # valid points
    grid: VoxelGrid
    boxes_per_axis: int
    radius: float                 # max 12-NN distance (BallRegion radius)
    border: np.ndarray            # [minX,minY,minZ,maxX,maxY,maxZ] indices
    normals: Optional[np.ndarray] = None   # (P, 3) oriented, or None
    uniform: Optional[UniformInfo] = None  # set when normalized to [-1,1]³


def _pad(points: np.ndarray, multiple: int = 256):
    pts = np.asarray(points, dtype=np.float32)
    n = pts.shape[0]
    p = ((n + multiple - 1) // multiple) * multiple
    padded = np.zeros((p, 3), np.float32)
    padded[:n] = pts
    mask = np.zeros((p,), bool)
    mask[:n] = True
    return padded, mask, n


def _build_state(
    points: np.ndarray,
    normals: Optional[np.ndarray],
    uniform: Optional[UniformInfo],
) -> PipelineState:
    import jax.numpy as jnp

    padded, mask, n = _pad(points)
    border = border_indices(np.asarray(points))
    nb = estimate_box_scale(n)
    pj, mj = jnp.asarray(padded), jnp.asarray(mask)
    grid = build_voxel_grid(pj, mj, nb)
    radius = float(estimate_radius(pj, mj))
    padded_normals = None
    if normals is not None:
        padded_normals = np.zeros_like(padded)
        padded_normals[:n] = np.asarray(normals, np.float32)[:n]
    return PipelineState(
        points=padded, mask=mask, count=n, grid=grid, boxes_per_axis=nb,
        radius=radius, border=border, normals=padded_normals, uniform=uniform,
    )


def _oriented_normals(points: np.ndarray, cache: Optional[ArrayCache]) -> np.ndarray:
    """Oriented normals for raw (N, 3) points, memoized by content hash."""
    import jax.numpy as jnp

    from kss_icp.ops.normals import estimate_oriented_normals

    pts = np.asarray(points, np.float32)
    if cache is not None:
        key = content_key(pts, op="oriented_normals", k=20)
        hit = cache.get(key)
        if hit is not None and "normals" in hit:
            return hit["normals"]
    padded, mask, n = _pad(pts)
    nrm = np.asarray(
        estimate_oriented_normals(jnp.asarray(padded), jnp.asarray(mask))
    )[:n]
    if cache is not None:
        cache.put(key, normals=nrm)
    return nrm


def pipeline_from_file(
    path: PathLike,
    denoise: bool = False,
    uniform: bool = True,
    use_normal_sidecar: bool = True,
    cache: Optional[ArrayCache] = None,
) -> PipelineState:
    """pointPipeline_init (pointPipeline.hpp:40-68): load, optionally
    normalize to [-1,1]³, estimate oriented normals with a `.normal` sidecar
    cache, build the spatial index. `denoise` mirrors the reference flag
    (it routes through an extra octree pass there only for huge scans;
    here the voxel grid handles any N, so it is accepted and ignored)."""
    del denoise
    path = Path(path)
    pts = load_points(path)
    info = None
    if uniform:
        pts, info = uniform_normalize(pts)

    normals = None
    sidecar = path.with_suffix(".normal")
    if use_normal_sidecar and sidecar.exists():
        cached = load_normals(sidecar)
        if cached.shape[0] == pts.shape[0]:
            normals = cached.astype(np.float32)
    if normals is None:
        normals = _oriented_normals(pts, cache)
        if use_normal_sidecar:
            try:
                save_normals(sidecar, normals)
            except OSError:
                pass  # read-only data dir: content cache still holds it
    return _build_state(pts, normals, info)


def pipeline_from_points(
    points: np.ndarray, cache: Optional[ArrayCache] = None
) -> PipelineState:
    """pointPipeline_init_point (:70-86): in-memory cloud, with normals."""
    pts = np.asarray(points, np.float64)
    return _build_state(pts, _oriented_normals(pts, cache), None)


def pipeline_from_points_without_uniform(points: np.ndarray) -> PipelineState:
    """pointPipeline_init_point_withoutUniform (:88-101) — the registration
    path: no normalization, no normals; border + spatial index only."""
    return _build_state(np.asarray(points, np.float64), None, None)

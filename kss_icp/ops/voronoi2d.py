"""2D Voronoi diagrams + centroidal relaxation — the reference's `VoronoiD`
(VD.hpp, class VoronoiD; not in the reference build — the CVT-remesh lineage).

VD.hpp wraps CGAL's Delaunay/Voronoi_diagram_2 to get, per site: the clipped
cell polygon inside a bounding box and its centroid (VoronoiD_Bounding :50,
VoronoiD_Centroid :101). Downstream only ever consumes cell areas/centroids
(for Lloyd/CVT relaxation). Exact half-edge geometry is sequential and
branch-heavy — the opposite of what an accelerator wants — so this design computes
the *measure-theoretic* cell directly: rasterize the bounding box, label
every pixel with its nearest site (one (pixels × sites) distance
product), and reduce areas/centroids with segment sums. Resolution is a
knob; error is O(h) in the pixel size and vanishes under Lloyd iteration
averaging. `lloyd_relax` is the CVT solver the reference lineage used this
diagram for."""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

_BIG = 1e30


class VoronoiCells(NamedTuple):
    areas: jnp.ndarray      # (S,) cell area inside the bbox
    centroids: jnp.ndarray  # (S, 2) cell centroid (site position if empty)
    labels: jnp.ndarray     # (res, res) int32 nearest-site raster


def _grid(bbox, resolution, dtype):
    x0, y0, x1, y1 = bbox
    xs = x0 + (jnp.arange(resolution, dtype=dtype) + 0.5) * (x1 - x0) / resolution
    ys = y0 + (jnp.arange(resolution, dtype=dtype) + 0.5) * (y1 - y0) / resolution
    gx, gy = jnp.meshgrid(xs, ys, indexing="ij")
    pix_area = ((x1 - x0) / resolution) * ((y1 - y0) / resolution)
    return jnp.stack([gx.ravel(), gy.ravel()], axis=-1), pix_area


@partial(jax.jit, static_argnames=("resolution",))
def voronoi_cells(
    sites: jnp.ndarray,
    site_mask: jnp.ndarray,
    bbox: Tuple[float, float, float, float],
    resolution: int = 256,
) -> VoronoiCells:
    """Bounded Voronoi cells of (S, 2) sites inside bbox = (x0, y0, x1, y1).

    Masked sites never win a pixel and report area 0 / centroid = site."""
    dtype = sites.dtype
    s = sites.shape[0]
    pix, pix_area = _grid(bbox, resolution, dtype)  # (G, 2)

    # Nearest site per pixel: ||p||² − 2 p·c + ||c||², argmin over sites.
    p2 = jnp.sum(pix * pix, axis=-1, keepdims=True)
    c2 = jnp.sum(sites * sites, axis=-1)
    pc = jnp.einsum("gi,si->gs", pix, sites, precision=jax.lax.Precision.HIGHEST)
    d2 = p2 - 2.0 * pc + c2[None, :]
    d2 = jnp.where(site_mask[None, :], d2, _BIG)
    labels = jnp.argmin(d2, axis=-1).astype(jnp.int32)  # (G,)

    ones = jnp.ones_like(labels, dtype=dtype)
    counts = jax.ops.segment_sum(ones, labels, num_segments=s)
    sums = jax.ops.segment_sum(pix, labels, num_segments=s)
    areas = counts * pix_area
    centroids = jnp.where(
        counts[:, None] > 0, sums / jnp.maximum(counts, 1.0)[:, None], sites
    )
    return VoronoiCells(
        areas=areas * site_mask.astype(dtype),
        centroids=jnp.where(site_mask[:, None], centroids, sites),
        labels=labels.reshape(resolution, resolution),
    )


@partial(jax.jit, static_argnames=("resolution", "iterations"))
def lloyd_relax(
    sites: jnp.ndarray,
    site_mask: jnp.ndarray,
    bbox: Tuple[float, float, float, float],
    resolution: int = 256,
    iterations: int = 10,
) -> jnp.ndarray:
    """Centroidal Voronoi tessellation by Lloyd iteration: move each site to
    its bounded cell's centroid. The CVT solve VD.hpp existed to support."""

    def step(_, pts):
        cells = voronoi_cells(pts, site_mask, bbox, resolution)
        return jnp.where(site_mask[:, None], cells.centroids, pts)

    return jax.lax.fori_loop(0, iterations, step, sites)

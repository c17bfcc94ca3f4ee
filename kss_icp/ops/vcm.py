"""Voronoi Covariance Measure (VCM) sharp-edge estimation — the reference's
`CGAL_VCM.hpp` (CGAL::vcm_estimate_edges / vcm_is_on_feature_edge; not in the
reference build).

The VCM of a point set (Mérigot, Ovsjanikov, Guibas 2010) assigns each point
the covariance of its Voronoi cell intersected with an offset ball of radius
R; after convolving over an r-neighborhood, the eigenstructure separates
smooth-surface points (one dominant eigenvalue along the normal) from sharp
edges (two significant eigenvalues). CGAL integrates cells with exact
tessellation; this design evaluates the same integral by Monte-Carlo:

  1. draw samples uniformly in the radius-R balls around the points (their
     union covers the offset domain);
  2. assign each sample to its nearest point — that sample lies in that
     point's Voronoi cell (one batched distance product);
  3. accumulate (sample − site)(sample − site)ᵀ per site with segment sums;
  4. convolve: sum the matrices of all points within r (dense radius mask);
  5. edge test: sorted eigenvalues e0 ≤ e1 ≤ e2, edge iff
     e1 / (e0 + e1 + e2) ≥ threshold (CGAL vcm_is_on_feature_edge).

Stochastic error decays as 1/√samples and is shared across all points in a
neighborhood by the convolution step.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

from kss_icp.ops.nn import pairwise_sqdist

_BIG = 1e30


def _ball_samples(key, points, radius, samples_per_point):
    """Uniform samples in the R-balls centered at each point: (P*S, 3)."""
    p = points.shape[0]
    dtype = points.dtype
    kd, kr = jax.random.split(key)
    d = jax.random.normal(kd, (p, samples_per_point, 3), dtype)
    d = d / jnp.maximum(jnp.linalg.norm(d, axis=-1, keepdims=True), 1e-12)
    u = jax.random.uniform(kr, (p, samples_per_point, 1), dtype)
    offs = d * (u ** (1.0 / 3.0)) * radius
    return (points[:, None, :] + offs).reshape(-1, 3)


@partial(jax.jit, static_argnames=("samples_per_point",))
def vcm(
    points: jnp.ndarray,
    mask: jnp.ndarray,
    offset_radius,
    convolve_radius,
    key: jax.Array,
    samples_per_point: int = 32,
) -> jnp.ndarray:
    """Convolved VCM matrices (P, 3, 3) for a padded cloud."""
    dtype = points.dtype
    p = points.shape[0]
    r_off = jnp.asarray(offset_radius, dtype)
    samples = _ball_samples(key, points, r_off, samples_per_point)  # (G, 3)
    # Samples seeded at padded points are assigned to real sites (their own
    # origin is masked out of the argmin), adding only far-field noise that
    # the masked output discards.
    d2 = pairwise_sqdist(samples, points)
    d2 = jnp.where(mask[None, :], d2, _BIG)
    owner = jnp.argmin(d2, axis=-1)  # (G,)
    # Keep only samples that fall inside the offset domain (dist ≤ R).
    in_domain = jnp.min(d2, axis=-1) <= r_off * r_off
    diff = samples - points[owner]
    outer = diff[:, :, None] * diff[:, None, :] * in_domain[:, None, None].astype(dtype)
    mats = jax.ops.segment_sum(
        outer.reshape(-1, 9), owner, num_segments=p
    )  # (P, 9)
    # Normalize to the Monte-Carlo measure (ball volume / samples drawn).
    vol = (4.0 / 3.0) * jnp.pi * r_off**3
    mats = mats * (vol / samples_per_point)

    # Convolution over the r-neighborhood (CGAL's vcm convolve step).
    d2p = pairwise_sqdist(points, points)
    near = (d2p <= convolve_radius * convolve_radius) & mask[None, :] & mask[:, None]
    conv = jnp.einsum(
        "ij,jk->ik", near.astype(dtype), mats, precision=jax.lax.Precision.HIGHEST
    )
    return conv.reshape(p, 3, 3)


@partial(jax.jit, static_argnames=("samples_per_point",))
def vcm_edges(
    points: jnp.ndarray,
    mask: jnp.ndarray,
    offset_radius,
    convolve_radius,
    key: jax.Array,
    threshold: float = 0.16,
    samples_per_point: int = 32,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Sharp-edge flags — CGAL_VCM_BorderOut (CGAL_VCM.hpp:25) equivalent.

    Returns (edge_mask (P,), ratio (P,)): ratio = e1/(e0+e1+e2) of the
    convolved VCM eigenvalues (ascending), edge iff ratio ≥ threshold
    (CGAL's default 0.16)."""
    mats = vcm(points, mask, offset_radius, convolve_radius, key, samples_per_point)
    evals = jnp.linalg.eigvalsh(mats)  # ascending (P, 3)
    total = jnp.maximum(jnp.sum(evals, axis=-1), jnp.finfo(points.dtype).tiny)
    ratio = evals[:, 1] / total
    return (ratio >= threshold) & mask, ratio * mask.astype(points.dtype)

"""Kendall pre-shape normalization (the "KSS" in KSS-ICP).

Mirrors initRegistration_MiddleAlign (initRegistrationKSS.hpp:144-220):
  - translate the source by (centroid_T - centroid_S),
  - scale about the *target* centroid by s = meanRadius_T / meanRadius_S,
where meanRadius is the mean distance-to-centroid (the Kendall pre-shape
size; a max-length variant is present but commented out in the reference).

Rather than mutating coordinates, `middle_align` returns the equivalent
Similarity:  x' = c_T + s·((x + (c_T − c_S)) − c_T) = s·x + (c_T − s·c_S).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from kss_icp.core.transforms import Similarity


def masked_centroid(points: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
    """Mean of valid points. points (..., N, 3), mask (..., N) -> (..., 3)."""
    w = mask.astype(points.dtype)
    total = jnp.einsum(
        "...n,...ni->...i", w, points, precision=jax.lax.Precision.HIGHEST
    )
    count = jnp.maximum(jnp.sum(w, axis=-1), 1.0)
    return total / count[..., None]


def masked_mean_radius(
    points: jnp.ndarray, mask: jnp.ndarray, centroid: jnp.ndarray
) -> jnp.ndarray:
    """Mean distance-to-centroid over valid points (Kendall pre-shape size)."""
    w = mask.astype(points.dtype)
    d = jnp.linalg.norm(points - centroid[..., None, :], axis=-1)
    count = jnp.maximum(jnp.sum(w, axis=-1), 1.0)
    return jnp.sum(d * w, axis=-1) / count


def masked_max_radius(
    points: jnp.ndarray, mask: jnp.ndarray, centroid: jnp.ndarray
) -> jnp.ndarray:
    """Max distance-to-centroid over valid points — the reference's
    commented-out alternative size measure (initRegistrationKSS.hpp:
    166-170, 206)."""
    d = jnp.linalg.norm(points - centroid[..., None, :], axis=-1)
    return jnp.max(jnp.where(mask, d, -1.0), axis=-1)


def middle_align(
    source_points: jnp.ndarray,
    source_mask: jnp.ndarray,
    target_points: jnp.ndarray,
    target_mask: jnp.ndarray,
    scale_mode: str = "mean_radius",
) -> Tuple[Similarity, jnp.ndarray, jnp.ndarray]:
    """Pre-shape alignment transform moving source onto the target frame.

    Returns (sim, target_centroid, scale) where sim: x -> s·x + (c_T − s·c_S).
    Matches initRegistrationKSS.hpp:144-220 exactly (R = I);
    scale_mode="max_radius" enables the reference's commented-out max-length
    size measure (more outlier-sensitive, kept for completeness).
    """
    radius_fn = (
        masked_mean_radius if scale_mode == "mean_radius" else masked_max_radius
    )
    c_s = masked_centroid(source_points, source_mask)
    c_t = masked_centroid(target_points, target_mask)
    r_s = radius_fn(source_points, source_mask, c_s)
    r_t = radius_fn(target_points, target_mask, c_t)
    scale = r_t / jnp.maximum(r_s, jnp.finfo(source_points.dtype).tiny)
    eye = jnp.broadcast_to(
        jnp.eye(3, dtype=source_points.dtype), scale.shape + (3, 3)
    )
    sim = Similarity(
        scale=scale,
        rotation=eye,
        translation=c_t - scale[..., None] * c_s,
    )
    return sim, c_t, scale

"""Resampling-quality metric — accelerator re-design of simMeasurement
(pointCloudMeasure.hpp:127-281).

Reference: for every original point, iteratively project it onto the MLS
surface of the simplified cloud (Gaussian weights exp(-(d/h)^2) with h =
simplified-cloud support radius, Newton steps x' = x - (n^T(a - x)) n, up to
10 iterations, OpenMP over points) and report the average/maximum
displacement plus the sampling rate.

Here the per-point loop becomes a batched (N x M) weight matmul per
projection step, vmap-free and fully fused; normals come from ops/normals.
"""

from __future__ import annotations

from functools import partial
from typing import Dict

import jax
import jax.numpy as jnp

from kss_icp.ops.nn import pairwise_sqdist
from kss_icp.ops.normals import estimate_normals


@partial(jax.jit, static_argnames=("iterations", "normal_k"))
def simplification_measure(
    original: jnp.ndarray,
    original_mask: jnp.ndarray,
    simplified: jnp.ndarray,
    simplified_mask: jnp.ndarray,
    radius: jnp.ndarray | None = None,
    iterations: int = 10,
    normal_k: int = 12,
) -> Dict[str, jnp.ndarray]:
    """Geometric error of `simplified` as a surface proxy for `original`.

    Returns {"avg_displacement", "max_displacement", "sampling_rate"}.
    """
    dtype = original.dtype
    eps = jnp.finfo(dtype).tiny
    w_o = original_mask.astype(dtype)
    w_s = simplified_mask.astype(dtype)

    if radius is None:
        # Reference semantics: h = the simplified cloud's BallRegion radius,
        # i.e. the max over points of the 12-NN distance
        # (ballRegionCompute.hpp:477-530, pointNumEsti=12).
        from kss_icp.ops.nn import knn

        k = min(13, simplified.shape[0])  # 12 neighbors + self
        d2k, _ = knn(simplified, simplified, simplified_mask, k)
        per_point = jnp.sqrt(jnp.max(d2k, axis=1))
        radius = jnp.max(jnp.where(simplified_mask, per_point, 0.0))
    inv_h2 = 1.0 / jnp.maximum(radius * radius, eps)

    normals = estimate_normals(simplified, simplified_mask, k=normal_k)

    def project_step(_, x):
        d2 = pairwise_sqdist(x, simplified)  # (N, M)
        w = jnp.exp(-d2 * inv_h2) * w_s[None, :]
        wsum = jnp.maximum(jnp.sum(w, axis=1, keepdims=True), eps)
        a = (w @ simplified) / wsum  # weighted anchor
        n = w @ normals
        n = n / jnp.maximum(jnp.linalg.norm(n, axis=1, keepdims=True), eps)
        # Move along the blended normal onto the local plane through a.
        step = jnp.sum(n * (a - x), axis=1, keepdims=True) * n
        return x + step

    projected = jax.lax.fori_loop(0, iterations, project_step, original)
    disp = jnp.linalg.norm(projected - original, axis=1)
    n_o = jnp.maximum(jnp.sum(w_o), 1.0)
    avg = jnp.sum(disp * w_o) / n_o
    mx = jnp.max(jnp.where(original_mask, disp, -1.0))
    rate = jnp.sum(w_s) / n_o
    return {"avg_displacement": avg, "max_displacement": mx, "sampling_rate": rate}

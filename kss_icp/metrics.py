"""Registration quality metrics — the PCR_QM contract.

Mirrors registrationMeasure.hpp:47-98: for every aligned source point, the
squared distance to its 1-NN in the target; MSE = mean of squares,
MAE = mean of distances, RMSE = sqrt(MSE). The reference runs ~|A| serial
k-d-tree queries; here it is one brute-force 1-NN (ops/nn.nearest_neighbor):
the exact-f32 kernel on the GPU and a masked pairwise product plus row-min
elsewhere (chunked over the query axis for large clouds).
"""

from __future__ import annotations

from functools import partial
from typing import Dict, Union

import jax
import jax.numpy as jnp
import numpy as np

from kss_icp.core.cloud import PointCloud
from kss_icp.ops.nn import nearest_neighbor


@partial(jax.jit, static_argnames=("chunk",))
def registration_measure_padded(
    aligned_points: jnp.ndarray,
    aligned_mask: jnp.ndarray,
    target_points: jnp.ndarray,
    target_mask: jnp.ndarray,
    chunk: int | None = 4096,
) -> Dict[str, jnp.ndarray]:
    d2, _ = nearest_neighbor(
        aligned_points, target_points, target_mask, chunk=chunk
    )
    w = aligned_mask.astype(d2.dtype)
    n = jnp.maximum(jnp.sum(w), 1.0)
    mse = jnp.sum(d2 * w) / n
    mae = jnp.sum(jnp.sqrt(d2) * w) / n
    return {"mse": mse, "rmse": jnp.sqrt(mse), "mae": mae}


def registration_measure(
    aligned: Union[PointCloud, np.ndarray],
    target: Union[PointCloud, np.ndarray],
    chunk: int | None = 4096,
) -> Dict[str, float]:
    """Host-facing MSE/RMSE/MAE (floats)."""
    if not isinstance(aligned, PointCloud):
        aligned = PointCloud.from_points(aligned)
    if not isinstance(target, PointCloud):
        target = PointCloud.from_points(target)
    out = registration_measure_padded(
        aligned.points, aligned.mask, target.points, target.mask, chunk=chunk,
    )
    return {k: float(v) for k, v in out.items()}

"""Padded, masked point clouds.

Accelerator-first design decision: every cloud is a fixed-shape (P, 3) array plus a
(P,) validity mask, so all downstream ops are static-shape and jit-friendly.
The reference (vvvwo/KSS-ICP) uses `vector<vector<double>>` with dynamic
sizes everywhere; here variable point counts become masks.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PointCloud:
    """A batch-friendly padded point cloud.

    points: (..., P, 3) float array; padded rows hold zeros.
    mask:   (..., P) bool; True for valid points.
    """

    points: jax.Array
    mask: jax.Array

    @property
    def padded_size(self) -> int:
        return self.points.shape[-2]

    @property
    def count(self) -> jax.Array:
        """Number of valid points (traced-safe)."""
        return jnp.sum(self.mask, axis=-1)

    @property
    def dtype(self):
        return self.points.dtype

    @classmethod
    def from_points(
        cls,
        points,
        pad_to: Optional[int] = None,
        multiple: int = 256,
        dtype=jnp.float32,
    ) -> "PointCloud":
        """Build a padded cloud from an (N, 3) host array."""
        pts = np.asarray(points, dtype=np.float64)
        if pts.ndim != 2 or pts.shape[1] != 3:
            raise ValueError(f"expected (N, 3) points, got {pts.shape}")
        n = pts.shape[0]
        p = pad_to if pad_to is not None else _round_up(max(n, 1), multiple)
        if p < n:
            raise ValueError(f"pad_to={p} < point count {n}")
        padded = np.zeros((p, 3), dtype=np.float64)
        padded[:n] = pts
        mask = np.zeros((p,), dtype=bool)
        mask[:n] = True
        return cls(points=jnp.asarray(padded, dtype=dtype), mask=jnp.asarray(mask))

    def to_numpy(self) -> np.ndarray:
        """Valid points only, as a host (N, 3) array. Not jit-safe."""
        pts = np.asarray(self.points)
        msk = np.asarray(self.mask)
        return pts[msk]

    def astype(self, dtype) -> "PointCloud":
        return PointCloud(points=self.points.astype(dtype), mask=self.mask)

    def repad(self, pad_to: int) -> "PointCloud":
        """Grow or shrink the static padding (host-side; not jit-safe)."""
        return PointCloud.from_points(self.to_numpy(), pad_to=pad_to, dtype=self.dtype)

"""Rotation-grid sharding: split one pair's step^3 rotation scores across
mesh devices, all_gather the field.

This is the intra-pair scaling axis (SURVEY.md §5.7): each device rotates
the (already pre-shape-aligned) source by its slice of the Euler grid and
scores mean-1-NN distance against a replicated target; the (steps^3,) field
is re-assembled with an all_gather over ICI. At reference scale one chip is
plenty — this exists for large grids (accurate >> 8) and the multi-chip
dryrun contract.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from kss_icp.core.transforms import euler_xyz_matrix
from kss_icp.models.coarse import rotation_grid
from kss_icp.ops.nn import masked_mean_nn_distance


@partial(jax.jit, static_argnames=("steps", "mesh", "rot_axis"))
def score_rotation_field_sharded(
    source: jnp.ndarray,
    source_mask: jnp.ndarray,
    target: jnp.ndarray,
    target_mask: jnp.ndarray,
    *,
    steps: int,
    span: float = 6.3,
    mesh: Mesh,
    rot_axis: str = "rot",
) -> jnp.ndarray:
    """(steps, steps, steps) error field, rotation axis sharded over `mesh`.

    Requires steps^3 % mesh.shape[rot_axis] == 0 (pad steps if not).
    """
    total = steps ** 3
    n_shards = mesh.shape[rot_axis]
    if total % n_shards != 0:
        raise ValueError(f"steps^3={total} not divisible by {n_shards} shards")

    angles = rotation_grid(steps, span, source.dtype)  # (total, 3)

    def shard_fn(angles_local, src, smask, tgt, tmask):
        rots = euler_xyz_matrix(angles_local)  # (total/n, 3, 3)
        rotated = jnp.einsum("cij,pj->cpi", rots, src, precision=jax.lax.Precision.HIGHEST)
        scores = masked_mean_nn_distance(
            rotated, smask[None, :], tgt[None, :, :], tmask[None, :]
        )
        return scores  # (total/n,) — out_specs P(rot_axis) re-concatenates

    in_specs = (P(rot_axis), P(), P(), P(), P())
    scores = jax.shard_map(
        shard_fn, mesh=mesh, in_specs=in_specs, out_specs=P(rot_axis)
    )(angles, source, source_mask, target, target_mask)
    return scores.reshape(steps, steps, steps)

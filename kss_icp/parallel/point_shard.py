"""Point-axis sharding: one pair's source cloud split across mesh devices.

The intra-pair scaling axis for N beyond one chip's comfort (SURVEY.md §5.7,
§5.8): each device holds a slice of the source rows and the full (small)
target; per-iteration 1-NN is local to the shard, and the ICP reductions —
the 3x3 Kabsch cross-covariance, correspondence MSE, fitness — psum over
the device interconnect. The transform comes out replicated on every device. This is the
"Schur-style reduction" collective pattern from BASELINE.md's north star;
models/icp.py implements it via its `axis_name` parameter, this module wraps
it in shard_map."""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from kss_icp.models.icp import ICPParams, ICPResult, icp
from kss_icp.ops.nn import nearest_neighbor


@partial(jax.jit, static_argnames=("mesh", "point_axis"))
def icp_point_sharded(
    source: jnp.ndarray,      # (P, 3), P divisible by mesh.shape[point_axis]
    source_mask: jnp.ndarray,  # (P,)
    target: jnp.ndarray,      # (T, 3) replicated
    target_mask: jnp.ndarray,  # (T,)
    params: ICPParams,
    *,
    mesh: Mesh,
    point_axis: str = "points",
) -> ICPResult:
    """ICP with the source point axis sharded over `mesh`; result replicated."""
    p = source.shape[0]
    n_shards = mesh.shape[point_axis]
    if p % n_shards != 0:
        raise ValueError(f"P={p} not divisible by {n_shards} shards")

    def body(src, smask, tgt, tmask, prm):
        return icp(src, smask, tgt, tmask, prm, axis_name=point_axis)

    return jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(point_axis), P(point_axis), P(), P(), P()),
        out_specs=P(),
        check_vma=False,
    )(source, source_mask, target, target_mask, params)


@partial(jax.jit, static_argnames=("mesh", "point_axis"))
def mean_nn_distance_sharded(
    query: jnp.ndarray,
    query_mask: jnp.ndarray,
    ref: jnp.ndarray,
    ref_mask: jnp.ndarray,
    *,
    mesh: Mesh,
    point_axis: str = "points",
) -> jnp.ndarray:
    """Mean 1-NN distance with the query axis sharded (the PCR_QM metric for
    full-resolution clouds across devices): local 1-NN per shard
    (ops/nn.nearest_neighbor, the kernel on the GPU), psum'ed weighted
    mean."""
    q = query.shape[0]
    n_shards = mesh.shape[point_axis]
    if q % n_shards != 0:
        raise ValueError(f"Q={q} not divisible by {n_shards} shards")

    def body(qc, qm, r, rm):
        d2, _ = nearest_neighbor(qc, r, rm)
        d = jnp.sqrt(d2)
        w = qm.astype(d.dtype)
        num = jax.lax.psum(jnp.sum(d * w), point_axis)
        den = jax.lax.psum(jnp.sum(w), point_axis)
        return num / jnp.maximum(den, 1.0)

    return jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(point_axis), P(point_axis), P(), P()),
        out_specs=P(),
        check_vma=False,
    )(query, query_mask, ref, ref_mask)

"""Exact-f32 1-nearest-neighbor on the GPU (Pallas, Triton route).

1-NN is the op the engine is built on: ICP correspondences, the overlap
screens and the PCR_QM metric are all 1-NN queries, where the reference
walks PCL FLANN k-d trees (registrationMeasure.hpp:47-98). The plain path
(ops/nn.nearest_neighbor) writes a (Q, R) distance block to device memory
per query chunk and reads it back for the min; at scan scale that is
~10^11 bytes of traffic against little arithmetic.

Here the grid runs over query tiles. Each program keeps its tile's queries
in registers and loops over reference tiles, holding a running (min,
argmin) per query and lane, so device-memory traffic is O(Q + R·Q/TQ) and
the loop body has no cross-lane reduction. Distances are
broadcast differences in f32 (K = 3 leaves no work for the tensor cores,
and TF32 would flip argmins). A masked reference row carries +BIG in its
fourth plane, so it loses every comparison without a separate mask
operand. Ties resolve to the first index, as `jnp.argmin` does.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

_BIG = 1e30

# The fastest of the tiles tried on an H100 at the ICP, field and scan
# shapes (PERF.md): 64 queries x 64 reference lanes per step, 4 warps.
TILE_Q = 64
TILE_R = 64
NUM_WARPS = 4


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _nn_kernel(qx_ref, qy_ref, qz_ref, rx_ref, ry_ref, rz_ref, rb_ref,
               d2_ref, idx_ref, *, tile_r: int, n_tiles: int):
    qx = qx_ref[...][:, None]
    qy = qy_ref[...][:, None]
    qz = qz_ref[...][:, None]
    shape = (qx.shape[0], tile_r)
    lane = jax.lax.broadcasted_iota(jnp.int32, shape, 1)

    # The running (min, argmin) is kept per (query, lane) element, so the
    # loop body is elementwise; the one cross-lane reduction runs after it.
    # Tiles are visited in increasing order and `<` is strict, so each lane
    # keeps its first minimum.
    def body(j, carry):
        best, arg = carry
        off = pl.multiple_of(j * tile_r, tile_r)
        cols = pl.ds(off, tile_r)
        dx = qx - rx_ref[cols][None, :]
        dy = qy - ry_ref[cols][None, :]
        dz = qz - rz_ref[cols][None, :]
        d = dx * dx + dy * dy + dz * dz + rb_ref[cols][None, :]
        better = d < best
        return jnp.where(better, d, best), jnp.where(better, lane + off, arg)

    init = (jnp.full(shape, jnp.inf, jnp.float32), lane)
    best, arg = jax.lax.fori_loop(0, n_tiles, body, init)
    row_min = jnp.min(best, axis=1)
    first = jnp.where(best == row_min[:, None], arg, jnp.iinfo(jnp.int32).max)
    d2_ref[...] = row_min
    idx_ref[...] = jnp.min(first, axis=1)


@functools.partial(jax.jit, static_argnames=("interpret",))
def nearest_neighbor_kernel(
    query: jnp.ndarray,
    ref: jnp.ndarray,
    ref_mask: jnp.ndarray,
    interpret: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """1-NN of (Q, 3) queries among valid (R, 3) reference points.

    Returns (sq_distances (Q,), indices (Q,)), the contract of
    ops.nn.nearest_neighbor; a fully masked reference gives +BIG. Batch
    with vmap (each batch axis becomes a grid axis). `interpret=True` runs
    the kernel in the Pallas interpreter (CPU tests)."""
    tile_q, tile_r = TILE_Q, TILE_R
    q_n, r_n = query.shape[0], ref.shape[0]
    qp = _round_up(max(q_n, tile_q), tile_q)
    rp = _round_up(max(r_n, tile_r), tile_r)
    q = jnp.pad(query.astype(jnp.float32), ((0, qp - q_n), (0, 0)))
    r = jnp.pad(ref.astype(jnp.float32), ((0, rp - r_n), (0, 0)))
    valid = jnp.pad(ref_mask, (0, rp - r_n))
    rb = jnp.where(valid, 0.0, _BIG).astype(jnp.float32)

    qs = pl.BlockSpec((tile_q,), lambda i: (i,))
    rs = pl.BlockSpec((rp,), lambda i: (0,))
    d2, idx = pl.pallas_call(
        functools.partial(_nn_kernel, tile_r=tile_r, n_tiles=rp // tile_r),
        grid=(qp // tile_q,),
        in_specs=[qs, qs, qs, rs, rs, rs, rs],
        out_specs=[qs, qs],
        out_shape=[jax.ShapeDtypeStruct((qp,), jnp.float32),
                   jax.ShapeDtypeStruct((qp,), jnp.int32)],
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=NUM_WARPS,
                                                num_stages=2),
        interpret=interpret,
        name="nearest_neighbor",
    )(q[:, 0], q[:, 1], q[:, 2], r[:, 0], r[:, 1], r[:, 2], rb)

    d2, idx = d2[:q_n], idx[:q_n]
    d2 = jnp.where(d2 >= _BIG / 2, _BIG, d2)
    return d2, jnp.clip(idx, 0, max(r_n - 1, 0))

"""Brute-force masked nearest-neighbor ops — the replacement for every k-d
tree in the reference.

The reference funnels all spatial queries through PCL FLANN k-d trees
(initRegistrationKSS.hpp:224-236 rotation scoring, registrationMeasure.hpp
metrics, ICP correspondence inside PCL). Tree traversal is a scalar,
branchy, pointer-chasing workload; at the reference's working sizes
(≤2000 points per cloud, ≤~10^5 full-res) dense brute force wins. The plain
path here is |Q|x|R| squared distances as one rank-3 product at HIGHEST
precision plus row reductions, fused by XLA. On the GPU, nearest_neighbor
runs the exact-f32 Pallas kernel (ops/nn_triton.py) instead; its plain path
stays callable as nearest_neighbor_plain, the reference it is checked
against.

All ops are mask-correct: invalid reference rows score +inf, invalid query
rows are excluded from reductions.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

from kss_icp.ops.dispatch import on_cuda

_BIG = 1e30
_HIGHEST = jax.lax.Precision.HIGHEST


def pairwise_sqdist(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Squared Euclidean distances between (..., Q, 3) and (..., R, 3).

    Uses ||a||^2 + ||b||^2 - 2 a·b so the inner term is one product.
    Clamped at zero (the expansion can go slightly negative in f32).

    The product runs at HIGHEST precision, and that is load-bearing: a
    reduced-precision product (TF32 on the GPU) perturbs a·b by ~5e-4 on
    unit-scale clouds, the size of the squared nearest-neighbor spacing,
    and its noise biases the row-min DOWN (min of noisy values).
    """
    a2 = jnp.sum(a * a, axis=-1)
    b2 = jnp.sum(b * b, axis=-1)
    ab = jnp.einsum("...qi,...ri->...qr", a, b, precision=_HIGHEST)
    d2 = a2[..., :, None] + b2[..., None, :] - 2.0 * ab
    return jnp.maximum(d2, 0.0)


def nearest_neighbor(
    query: jnp.ndarray,
    ref: jnp.ndarray,
    ref_mask: jnp.ndarray,
    *,
    chunk: int | None = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """1-NN of each query point among valid reference points.

    Returns (sq_distances (..., Q), indices (..., Q)). Invalid reference
    points never win (they score +inf). Where the program is compiled for
    CUDA the exact-f32 kernel (ops/nn_triton.py) answers; elsewhere
    nearest_neighbor_plain, whose `chunk` splits the query axis to bound
    the (Q, R) intermediate.
    """
    plain = partial(nearest_neighbor_plain, chunk=chunk)
    out = jax.eval_shape(plain, query, ref, ref_mask)

    def kernel(q, r, m):
        d2, idx = _nearest_neighbor_kernel(q, r, m)
        return d2.astype(out[0].dtype), idx.astype(out[1].dtype)

    return on_cuda(kernel, plain, query, ref, ref_mask)


def _nearest_neighbor_kernel(query, ref, ref_mask):
    """ops/nn_triton.nearest_neighbor_kernel over broadcast leading axes."""
    from kss_icp.ops.nn_triton import nearest_neighbor_kernel

    batch = jnp.broadcast_shapes(query.shape[:-2], ref.shape[:-2],
                                 ref_mask.shape[:-1])
    if not batch:
        return nearest_neighbor_kernel(query, ref, ref_mask)
    q = jnp.broadcast_to(query, batch + query.shape[-2:]).reshape(
        (-1,) + query.shape[-2:])
    if ref.ndim == 2 or ref.shape[:-2] == (1,) * (ref.ndim - 2):
        r, m, r_axis = ref.reshape(ref.shape[-2:]), ref_mask.reshape(-1), None
    else:
        r = jnp.broadcast_to(ref, batch + ref.shape[-2:]).reshape(
            (-1,) + ref.shape[-2:])
        m = jnp.broadcast_to(ref_mask, batch + ref_mask.shape[-1:]).reshape(
            (-1,) + ref_mask.shape[-1:])
        r_axis = 0
    d2, idx = jax.vmap(nearest_neighbor_kernel,
                       in_axes=(0, r_axis, r_axis))(q, r, m)
    shape = batch + query.shape[-2:-1]
    return d2.reshape(shape), idx.reshape(shape)


def nearest_neighbor_plain(
    query: jnp.ndarray,
    ref: jnp.ndarray,
    ref_mask: jnp.ndarray,
    *,
    chunk: int | None = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """The plain XLA 1-NN on every platform: the reference the GPU kernel
    is checked against. With `chunk`, the query axis is split so the
    matmul+min fuse per chunk and device memory never sees the full
    (Q, R) matrix."""
    if chunk is None or query.shape[-2] <= chunk:
        return _nn_once(query, ref, ref_mask)

    q = query.shape[-2]
    if q % chunk != 0:
        # Static-shape world: caller pads; fall back to one shot otherwise.
        return _nn_once(query, ref, ref_mask)

    qs = query.reshape(query.shape[:-2] + (q // chunk, chunk, 3))
    d2, idx = jax.lax.map(lambda qc: _nn_once(qc, ref, ref_mask),
                          jnp.moveaxis(qs, -3, 0))
    d2 = jnp.moveaxis(d2, 0, -2).reshape(query.shape[:-2] + (q,))
    idx = jnp.moveaxis(idx, 0, -2).reshape(query.shape[:-2] + (q,))
    return d2, idx


def _nn_once(query, ref, ref_mask):
    d2 = pairwise_sqdist(query, ref)
    d2 = jnp.where(ref_mask[..., None, :], d2, _BIG)
    return jnp.min(d2, axis=-1), jnp.argmin(d2, axis=-1)


def masked_mean_nn_distance(
    query: jnp.ndarray,
    query_mask: jnp.ndarray,
    ref: jnp.ndarray,
    ref_mask: jnp.ndarray,
) -> jnp.ndarray:
    """Mean 1-NN *distance* (not squared) over valid query points.

    This is the rotation-grid alignment error `initRegistration_Error_Ave`
    (initRegistrationKSS.hpp:430-450), on the plain path.
    """
    d2 = pairwise_sqdist(query, ref)
    d2 = jnp.where(ref_mask[..., None, :], d2, _BIG)
    d = jnp.sqrt(jnp.min(d2, axis=-1))
    w = query_mask.astype(d.dtype)
    return jnp.sum(d * w, axis=-1) / jnp.maximum(jnp.sum(w, axis=-1), 1.0)


def trimmed_masked_mean(
    values: jnp.ndarray,
    mask: jnp.ndarray,
    trim_fraction: float,
) -> jnp.ndarray:
    """Mean of the smallest ceil(q * n_valid) valid values along the last
    axis (invalid entries never participate). The robust-statistics core of
    the overlap mode: on partially-overlapping clouds the largest NN
    distances come from the non-overlap region and carry no alignment
    signal — trimming them makes the score measure only the overlap."""
    dtype = values.dtype
    vm = jnp.where(mask, values, _BIG)
    vs = jnp.sort(vm, axis=-1)                       # ascending, invalid last
    nvalid = jnp.sum(mask.astype(jnp.int32), axis=-1)
    k = jnp.clip(_trim_count(nvalid, trim_fraction),
                 1, jnp.maximum(nvalid, 1))
    csum = jnp.cumsum(vs, axis=-1)
    picked = jnp.take_along_axis(csum, (k - 1)[..., None], axis=-1)[..., 0]
    return picked / k.astype(dtype)


def _trim_count(nvalid: jnp.ndarray, q: float) -> jnp.ndarray:
    """ceil(q * nvalid) computed stably: an f32 product at an exact-integer
    value can round to either side (0.7 * 1000 -> 699.99994), so a plain
    cast-truncation drops one element versus the documented rank on some
    platforms/dtypes (ADVICE r4). The 1e-3 guard absorbs f32 rounding at any
    realistic nvalid (error ~ nvalid * 1.2e-7 < 1e-3 for nvalid < 8192)
    while leaving genuine fractional products on their ceil."""
    return jnp.ceil(q * nvalid.astype(jnp.float32) - 1e-3).astype(jnp.int32)


def masked_quantile_threshold(
    values: jnp.ndarray,
    mask: jnp.ndarray,
    q: float,
) -> jnp.ndarray:
    """The q-quantile of the VALID values along the last axis (the value at
    rank ceil(q * n_valid) of the ascending sort) — the per-iteration
    correspondence gate of the trimmed ICP and the inlier-mask cut of the
    overlap iterations."""
    vm = jnp.where(mask, values, _BIG)
    vs = jnp.sort(vm, axis=-1)
    nvalid = jnp.sum(mask.astype(jnp.int32), axis=-1)
    k = jnp.clip(_trim_count(nvalid, q), 1, jnp.maximum(nvalid, 1))
    return jnp.take_along_axis(vs, (k - 1)[..., None], axis=-1)[..., 0]


def masked_nn_error(
    query: jnp.ndarray,
    query_mask: jnp.ndarray,
    ref: jnp.ndarray,
    ref_mask: jnp.ndarray,
    metric: str = "ave",
    trim_fraction: float = 0.7,
) -> jnp.ndarray:
    """Rotation-grid alignment error in the reference's three flavors
    (initRegistrationKSS.hpp) plus the overlap-robust fourth:
      - "ave":  mean 1-NN distance        (initRegistration_Error_Ave :430-450)
      - "max":  max 1-NN SQUARED distance (initRegistration_Error :406-428 —
                the reference never takes the sqrt there, reproduced)
      - "diff": max 1-NN distance − mean  (initRegistration_Error_Diff :452-479)
      - "trim": mean of the best trim_fraction-quantile of 1-NN distances —
                no reference analogue; scores only the overlap region so
                partially-overlapping scans rank the TRUE basin first (the
                reference's identically-normalized pipeline shares the
                partial-scan failure this fixes; see challenge.partial_corpus)
    Every flavor is a function of the per-query 1-NN squared distance, taken
    from nearest_neighbor.
    """
    min_d2, _ = nearest_neighbor(query, ref, ref_mask)
    if metric == "ave":
        d = jnp.sqrt(min_d2)
        w = query_mask.astype(d.dtype)
        return jnp.sum(d * w, axis=-1) / jnp.maximum(jnp.sum(w, axis=-1), 1.0)
    if metric == "max":
        return jnp.max(jnp.where(query_mask, min_d2, -_BIG), axis=-1)
    if metric == "diff":
        d = jnp.sqrt(min_d2)
        w = query_mask.astype(d.dtype)
        mean = jnp.sum(d * w, axis=-1) / jnp.maximum(jnp.sum(w, axis=-1), 1.0)
        return jnp.max(jnp.where(query_mask, d, -_BIG), axis=-1) - mean
    if metric == "trim":
        d = jnp.sqrt(min_d2)
        qm = jnp.broadcast_to(query_mask, d.shape)
        return trimmed_masked_mean(d, qm, trim_fraction)
    raise ValueError(f"unknown error metric {metric!r}")


def masked_mean_nn_sqdist(
    query: jnp.ndarray,
    query_mask: jnp.ndarray,
    ref: jnp.ndarray,
    ref_mask: jnp.ndarray,
) -> jnp.ndarray:
    """Mean squared 1-NN distance — PCL's getFitnessScore contract, used for
    the ICP fitness probe (KSS_ICP.hpp:93,:104,:130)."""
    d2, _ = nearest_neighbor(query, ref, ref_mask)
    w = query_mask.astype(d2.dtype)
    return jnp.sum(d2 * w, axis=-1) / jnp.maximum(jnp.sum(w, axis=-1), 1.0)


# Dense (Q, R) matrices beyond this many elements auto-route to the
# streaming path: 2^25 f32 = 128 MB — comfortably device/host resident,
# while 10^5+-point scans (the reference's Room/block regime,
# Method_Octree.hpp:16) would need 40+ GB dense.
_DENSE_KNN_LIMIT = 1 << 25


@partial(jax.jit, static_argnames=("k", "query_chunk", "ref_chunk"))
def knn(
    query: jnp.ndarray,
    ref: jnp.ndarray,
    ref_mask: jnp.ndarray,
    k: int,
    query_chunk: int | None = None,
    ref_chunk: int | None = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """k-NN sq-distances and indices (ascending). Replaces the reference's
    12-NN radius estimation (ballRegionCompute.hpp:477-530) and 20-NN normal
    neighborhoods (normalCompute.hpp:324-336).

    Small problems use one dense masked matmul + top_k. When the (Q, R)
    matrix would exceed ~128 MB — the full-resolution-scan regime the
    reference handles with its octree (ballRegionCompute.hpp:477-530,
    Method_Octree.hpp:16) — the computation streams: query chunks x
    reference tiles with a running top-k merge, so peak memory is
    O(query_chunk * ref_chunk) regardless of cloud size. Explicit
    query_chunk/ref_chunk force the streaming path."""
    q, r = query.shape[-2], ref.shape[-2]
    if (
        query_chunk is None
        and ref_chunk is None
        and q * r <= _DENSE_KNN_LIMIT
    ):
        d2 = pairwise_sqdist(query, ref)
        d2 = jnp.where(ref_mask[..., None, :], d2, _BIG)
        neg_d2, idx = jax.lax.top_k(-d2, k)
        return -neg_d2, idx
    return knn_streaming(
        query, ref, ref_mask, k,
        query_chunk=query_chunk or 2048,
        ref_chunk=ref_chunk or 16384,
    )


@partial(jax.jit, static_argnames=("k", "query_chunk", "ref_chunk"))
def knn_streaming(
    query: jnp.ndarray,
    ref: jnp.ndarray,
    ref_mask: jnp.ndarray,
    k: int,
    query_chunk: int = 2048,
    ref_chunk: int = 16384,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Streaming k-NN: identical results to the dense path, O(qc * rc) peak
    memory. lax.map over query chunks; inside, lax.scan over reference tiles
    keeps a running (qc, k) best set merged by top_k over the concatenated
    candidates (the k>1 generalization of the running-min 1-NN kernel,
    ops/nn_triton.py). Single-cloud layout (Q, 3)/(R, 3) — vmap for batches.
    """
    if query.ndim != 2:
        raise ValueError("knn_streaming expects unbatched (Q, 3) queries; vmap it")
    q, r = query.shape[0], ref.shape[0]
    dtype = query.dtype

    qc = min(query_chunk, q)
    rc = min(ref_chunk, r)
    k_eff = min(k, r)

    # Pad both axes to chunk multiples (padding never wins: masked to +inf).
    q_pad = (-q) % qc
    r_pad = (-r) % rc
    qp = jnp.pad(query, ((0, q_pad), (0, 0)))
    rp = jnp.pad(ref, ((0, r_pad), (0, 0)))
    rm = jnp.pad(ref_mask, (0, r_pad))

    n_tiles = (r + r_pad) // rc
    tiles_pts = rp.reshape(n_tiles, rc, 3)
    tiles_mask = rm.reshape(n_tiles, rc)
    tile_off = jnp.arange(n_tiles, dtype=jnp.int32) * rc

    kk = min(k_eff, rc)

    def per_query_chunk(qblock):
        def tile_step(carry, tile):
            best_d2, best_idx = carry
            pts, msk, off = tile
            d2 = pairwise_sqdist(qblock, pts)
            d2 = jnp.where(msk[None, :], d2, _BIG)
            nd2, nidx = jax.lax.top_k(-d2, kk)
            cat_d2 = jnp.concatenate([best_d2, -nd2], axis=-1)
            cat_ix = jnp.concatenate(
                [best_idx, (nidx + off).astype(jnp.int32)], axis=-1
            )
            md2, sel = jax.lax.top_k(-cat_d2, k_eff)
            mix = jnp.take_along_axis(cat_ix, sel, axis=-1)
            return (-md2, mix), None

        init = (
            jnp.full((qblock.shape[0], k_eff), _BIG, dtype),
            jnp.zeros((qblock.shape[0], k_eff), jnp.int32),
        )
        (d2, idx), _ = jax.lax.scan(
            tile_step, init, (tiles_pts, tiles_mask, tile_off)
        )
        return d2, idx

    qblocks = qp.reshape((q + q_pad) // qc, qc, 3)
    d2, idx = jax.lax.map(per_query_chunk, qblocks)
    d2 = d2.reshape(-1, k_eff)[:q]
    idx = idx.reshape(-1, k_eff)[:q]
    if k_eff < k:  # degenerate tiny-reference case: pad out to k columns
        d2 = jnp.pad(d2, ((0, 0), (0, k - k_eff)), constant_values=_BIG)
        idx = jnp.pad(idx, ((0, 0), (0, k - k_eff)))
    return d2, idx

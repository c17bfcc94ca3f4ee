"""Farthest-point sampling as one GPU program per cloud (Pallas, Triton route).

The plain FPS (ops/resample.farthest_point_sampling) is a `fori_loop` of
~2000 dependent steps; XLA on the GPU launches each step's distance update
and argmax as separate kernels, so the stage is bound by launch latency,
not arithmetic. Here each cloud gets one program (`grid=(B,)`) and the whole
sample loop runs inside it: the coordinate planes and the running
min-distance stay in registers, each step is one fused distance update plus
an in-block argmax (first-index tie-break, as `jnp.argmax`), and the chosen
index is written straight to the output row.

Pick semantics are those of the plain path: the seed is the valid point
farthest from the masked centroid (computed outside the kernel with the
plain path's own expression), invalid points score -1 and never win, and
the running min starts at +BIG. Index sequences agree with the plain path
except where floating-point contraction breaks an exact distance tie.

Replaces the same reference machinery as ops/resample.py: AIVS per-box FPS
+ exact-N trim (Method_AIVS_SimPro.hpp:222-376,:848-957).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

_BIG = 1e30

# On-chip budget: the three coordinate planes and the running min of one
# cloud live in the registers of one block. 8192 points at 16 warps is 64
# f32 registers a thread; wider clouds take the plain path (fps_fits).
MAX_POINTS = 8192


def _next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def fps_fits(num_points: int) -> bool:
    """Shape rule for the kernel: the padded cloud must fit on-chip."""
    return num_points <= MAX_POINTS


def _num_warps(padded_points: int) -> int:
    return min(max(padded_points // 512, 4), 16)


def _fps_kernel(x_ref, y_ref, z_ref, seed_ref, idx_ref, *, num_samples: int):
    x = x_ref[...]
    y = y_ref[...]
    z = z_ref[...]
    seed = seed_ref[...]
    # Valid points start at +BIG, invalid (and padding) at -1: d2 >= 0, so
    # min(score, d2) keeps every invalid point at -1 for the whole loop.
    score0 = jnp.where(seed < 0.0, -1.0, _BIG).astype(x.dtype)
    first = jax.lax.argmax(seed, 0, jnp.int32)

    def body(s, carry):
        score, cur = carry
        idx_ref[s] = cur
        dx = x - x_ref[cur]
        dy = y - y_ref[cur]
        dz = z - z_ref[cur]
        score = jnp.minimum(score, dx * dx + dy * dy + dz * dz)
        return score, jax.lax.argmax(score, 0, jnp.int32)

    jax.lax.fori_loop(0, num_samples, body, (score0, first))


@functools.partial(jax.jit, static_argnames=("num_samples", "interpret"))
def fps_batch(
    points: jnp.ndarray,
    mask: jnp.ndarray,
    num_samples: int,
    interpret: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Batched FPS: (B, P, 3) points + (B, P) mask -> (B, S) indices +
    (B, S) sample mask, the per-row contract of
    ops/resample.farthest_point_sampling. P must satisfy fps_fits."""
    b_n, p_n = mask.shape
    if not fps_fits(p_n):
        raise ValueError(f"{p_n} points exceed the kernel's {MAX_POINTS}")
    pp = _next_pow2(max(p_n, 128))
    sp = _next_pow2(max(num_samples, 16))
    pts = points.astype(jnp.float32)
    w = mask.astype(jnp.float32)
    # Seed score with the plain path's expression, so both pick the same
    # first point: squared distance to the masked centroid, -1 if invalid.
    centroid = jnp.sum(pts * w[..., None], axis=1) / jnp.maximum(
        jnp.sum(w, axis=1), 1.0)[:, None]
    d2c = jnp.sum((pts - centroid[:, None, :]) ** 2, axis=-1)
    seed = jnp.where(mask, d2c, -1.0)

    def plane(a, fill):
        return jnp.pad(a, ((0, 0), (0, pp - p_n)), constant_values=fill)

    row = pl.BlockSpec((None, pp), lambda i: (i, 0))
    idx = pl.pallas_call(
        functools.partial(_fps_kernel, num_samples=num_samples),
        grid=(b_n,),
        in_specs=[row, row, row, row],
        out_specs=pl.BlockSpec((None, sp), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((b_n, sp), jnp.int32),
        backend="triton",
        compiler_params=pltriton.CompilerParams(
            num_warps=_num_warps(pp), num_stages=1),
        interpret=interpret,
        name="fps_batch",
    )(plane(pts[..., 0], 0.0), plane(pts[..., 1], 0.0),
      plane(pts[..., 2], 0.0), plane(seed, -1.0))

    idx = jnp.clip(idx[:, :num_samples], 0, p_n - 1)
    count = jnp.sum(mask, axis=1)
    smask = jnp.arange(num_samples)[None, :] < jnp.minimum(
        count, num_samples)[:, None]
    return idx, smask

"""Similarity transforms (scale · rotation + translation) as small pytrees.

The reference mutates coordinate arrays in place for every stage
(initRegistrationKSS.hpp:75-109 translate/scale/rotate loops,
KSS_ICP.hpp:222-230 4x4 application). Here each stage *returns a transform*;
stages compose algebraically and one fused apply touches the full-resolution
cloud exactly once — far cheaper in device-memory bandwidth and trivially
batchable.

Convention: x' = scale * (R @ x) + t.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class Similarity(NamedTuple):
    """x -> scale * R @ x + t. Fields broadcast over leading batch dims."""

    scale: jnp.ndarray  # (...,)
    rotation: jnp.ndarray  # (..., 3, 3)
    translation: jnp.ndarray  # (..., 3)

    @classmethod
    def identity(cls, dtype=jnp.float32, batch_shape=()) -> "Similarity":
        return cls(
            scale=jnp.ones(batch_shape, dtype=dtype),
            rotation=jnp.broadcast_to(jnp.eye(3, dtype=dtype), batch_shape + (3, 3)),
            translation=jnp.zeros(batch_shape + (3,), dtype=dtype),
        )

    @classmethod
    def from_rigid(cls, rotation, translation) -> "Similarity":
        return cls(
            scale=jnp.ones(rotation.shape[:-2], dtype=rotation.dtype),
            rotation=rotation,
            translation=translation,
        )


def apply_similarity(sim: Similarity, points: jnp.ndarray) -> jnp.ndarray:
    """Apply x' = s·R·x + t to (..., N, 3) points."""
    rotated = jnp.einsum(
        "...ij,...nj->...ni", sim.rotation, points,
        precision=jax.lax.Precision.HIGHEST,
    )
    return sim.scale[..., None, None] * rotated + sim.translation[..., None, :]


def compose(outer: Similarity, inner: Similarity) -> Similarity:
    """Transform equal to applying `inner` first, then `outer`.

    outer(inner(x)) = s_o·R_o·(s_i·R_i·x + t_i) + t_o
                    = (s_o·s_i)·(R_o·R_i)·x + (s_o·R_o·t_i + t_o)
    """
    rot = jnp.einsum(
        "...ij,...jk->...ik", outer.rotation, inner.rotation,
        precision=jax.lax.Precision.HIGHEST,
    )
    trans = (
        outer.scale[..., None]
        * jnp.einsum(
            "...ij,...j->...i", outer.rotation, inner.translation,
            precision=jax.lax.Precision.HIGHEST,
        )
        + outer.translation
    )
    return Similarity(scale=outer.scale * inner.scale, rotation=rot, translation=trans)


def rot_x(angle) -> jnp.ndarray:
    """Rotation about +x; matches initRegistrationKSS.hpp:367-377 (cord=1):
    y' = y·cos − z·sin, z' = y·sin + z·cos."""
    angle = jnp.asarray(angle)
    c, s = jnp.cos(angle), jnp.sin(angle)
    z = jnp.zeros_like(c)
    o = jnp.ones_like(c)
    return jnp.stack(
        [
            jnp.stack([o, z, z], axis=-1),
            jnp.stack([z, c, -s], axis=-1),
            jnp.stack([z, s, c], axis=-1),
        ],
        axis=-2,
    )


def rot_y(angle) -> jnp.ndarray:
    """Rotation about +y; matches initRegistrationKSS.hpp:378-388 (cord=2):
    x' = z·sin + x·cos, z' = z·cos − x·sin."""
    angle = jnp.asarray(angle)
    c, s = jnp.cos(angle), jnp.sin(angle)
    z = jnp.zeros_like(c)
    o = jnp.ones_like(c)
    return jnp.stack(
        [
            jnp.stack([c, z, s], axis=-1),
            jnp.stack([z, o, z], axis=-1),
            jnp.stack([-s, z, c], axis=-1),
        ],
        axis=-2,
    )


def rot_z(angle) -> jnp.ndarray:
    """Rotation about +z; matches initRegistrationKSS.hpp:389-400 (cord=3):
    x' = x·cos − y·sin, y' = x·sin + y·cos."""
    angle = jnp.asarray(angle)
    c, s = jnp.cos(angle), jnp.sin(angle)
    z = jnp.zeros_like(c)
    o = jnp.ones_like(c)
    return jnp.stack(
        [
            jnp.stack([c, -s, z], axis=-1),
            jnp.stack([s, c, z], axis=-1),
            jnp.stack([z, z, o], axis=-1),
        ],
        axis=-2,
    )


def euler_xyz_matrix(angles) -> jnp.ndarray:
    """R = Rz(c) · Ry(b) · Rx(a) for angles (..., 3) = (a, b, c).

    The reference applies X first, then Y, then Z
    (initRegistrationKSS.hpp:86-88), i.e. column-vector R = Rz·Ry·Rx.
    """
    angles = jnp.asarray(angles)
    rx = rot_x(angles[..., 0])
    ry = rot_y(angles[..., 1])
    rz = rot_z(angles[..., 2])
    return jnp.einsum(
        "...ij,...jk,...kl->...il", rz, ry, rx,
        precision=jax.lax.Precision.HIGHEST,
    )

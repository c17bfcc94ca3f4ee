"""Device-mesh helpers.

The reference's entire parallelism story is shared-memory OpenMP
(SURVEY.md §2.3); there is nothing to port. The device scaling axes are:
  - "pairs": batch of registrations (embarrassingly parallel — the
    ModelNet40/SHREC sweep axis), and
  - "rot":   the rotation grid within one pair (512 independent scores).
Collectives (NVLink between the cards of a host): psum for sharded
reductions, all_gather for the candidate field.
"""

from __future__ import annotations

from typing import Sequence

import jax
import numpy as np
from jax.sharding import Mesh


def distributed_init(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Initialize multi-host JAX (jax.distributed) — SURVEY.md §5.8.

    With no arguments, JAX auto-detects a cluster environment where one
    exists; where none does (a single host), pass coordinator_address
    ("localhost:<port>"), num_processes and process_id. Single-process
    setups no-op. Safe to call twice."""
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError as e:
        if "already" not in str(e).lower():
            raise


def make_mesh(axis_names: Sequence[str] = ("pairs",), shape: Sequence[int] | None = None) -> Mesh:
    """Build a Mesh over all available devices.

    With shape=None, all devices go to the first axis. Axis sizes must
    multiply to the device count.
    """
    devices = np.asarray(jax.devices())
    if shape is None:
        shape = (len(devices),) + (1,) * (len(axis_names) - 1)
    if int(np.prod(shape)) != len(devices):
        raise ValueError(f"mesh shape {shape} != device count {len(devices)}")
    return Mesh(devices.reshape(shape), axis_names=tuple(axis_names))

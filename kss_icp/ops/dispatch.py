"""Where the hand-written GPU kernels run.

Every call site that has a Pallas kernel (ops/resample_triton.py,
ops/nn_triton.py) goes through on_cuda: the kernel where the program is
compiled for CUDA, the plain XLA path on every other platform. The choice is
made at lowering time, so one traced program compiles to the kernel on the
GPU and to the plain path on the CPU. Each kernel measured faster end to end
on an H100 at every call site it serves (PERF.md, Findings).
"""

from __future__ import annotations

from typing import Callable

import jax


def on_cuda(kernel: Callable, plain: Callable, *args):
    """kernel(*args) where the program is lowered for CUDA, plain(*args)
    everywhere else. Both must return the same shapes and dtypes."""
    return jax.lax.platform_dependent(*args, cuda=kernel, default=plain)

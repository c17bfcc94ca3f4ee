"""Per-stage timing + structured metrics.

The reference's observability is clock() deltas printed to stdout
(initRegistrationKSS.hpp:66-70, Method_AIVS_SimPro.hpp:95,151-152,
Main_KSS_List.cpp:151-153). Here: a context-manager timer emitting JSON
lines, plus jax.profiler trace annotations for device timeline capture.
"""

from __future__ import annotations

import contextlib
import json
import sys
import time
from typing import Dict, Optional


class StageTimer:
    """Collects named stage durations; optionally emits JSON lines."""

    def __init__(self, emit: bool = False, stream=sys.stderr):
        self.stages: Dict[str, float] = {}
        self.emit = emit
        self.stream = stream

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.stages[name] = self.stages.get(name, 0.0) + dt
            if self.emit:
                print(
                    json.dumps({"stage": name, "seconds": round(dt, 6)}),
                    file=self.stream,
                    flush=True,
                )

    def summary(self) -> Dict[str, float]:
        return dict(self.stages)


@contextlib.contextmanager
def trace_annotation(name: str):
    """jax.profiler.TraceAnnotation around the body, or no annotation where
    the profiler cannot make one. Only entering the annotation is guarded:
    an exception raised by the body propagates unchanged."""
    stack = contextlib.ExitStack()
    try:
        import jax.profiler

        stack.enter_context(jax.profiler.TraceAnnotation(name))
    except (ImportError, RuntimeError):
        pass
    with stack:
        yield

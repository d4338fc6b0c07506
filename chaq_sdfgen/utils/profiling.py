"""Timing / tracing utilities (SURVEY.md §5: the reference's only
instrumentation is the OpenCL --time flag reading CL event profiling,
opencl/main.cpp:333-356; this module is the JAX equivalent)."""

from __future__ import annotations

import contextlib
import logging
import time
from typing import Callable, Optional

import jax

log = logging.getLogger("chaq_sdfgen")


@contextlib.contextmanager
def kernel_timer(label: str = "Kernel", emit: Optional[Callable[[str], None]] = None):
    """Wall-clock a device computation (the body must block on its result).

    Prints ``Kernel timing: N sec`` like the reference's event callback
    (opencl/main.cpp:352-355)."""
    emit = emit or (lambda s: print(s))
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    emit(f"{label} timing: {dt:.3f} sec")


def time_compiled(fn: Callable, *args, iters: int = 5, warmup: int = 1) -> float:
    """Best-of-N wall time of a jitted function, blocking on outputs."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


@contextlib.contextmanager
def device_trace(path: str):
    """jax.profiler trace context — the replacement for the
    reference's CL_QUEUE_PROFILING_ENABLE queue property."""
    jax.profiler.start_trace(path)
    try:
        yield
    finally:
        jax.profiler.stop_trace()

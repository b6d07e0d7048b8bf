"""Profiler integration: a ``torch.profiler`` trace of a code block,
written to a directory, and host wall timing with the reference's
``(PERF)`` line (the port's counterpart of
``ldpcgputegra_tpu/utils/profiling.py``)."""

from __future__ import annotations

import contextlib
import os
import time

import torch

__all__ = ["trace", "timed", "TRACE_DIR"]

# under the checkout, git-ignored (bench_results/)
TRACE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "bench_results", "traces")


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Trace the host and, where there is one, the CUDA device around a
    code block; yields the directory the trace is written to when the
    block ends (``<host>_<pid>.<time>.pt.trace.json``: open it in
    Perfetto or ``chrome://tracing``, or with TensorBoard's profiler
    plugin).  The default directory is ``bench_results/traces/<time>``
    in the checkout."""
    log_dir = log_dir or os.path.join(TRACE_DIR, time.strftime("%Y%m%d-%H%M%S"))
    os.makedirs(log_dir, exist_ok=True)
    act = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        act.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=act,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir),
    ):
        yield log_dir


@contextlib.contextmanager
def timed(label: str):
    """Host-side wall timing with the reference's (PERF) line convention.
    Work queued on a CUDA device is not waited for: synchronise inside the
    block to time it."""
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    print(f"(PERF) {label}: {dt * 1e3:.3f} ms")

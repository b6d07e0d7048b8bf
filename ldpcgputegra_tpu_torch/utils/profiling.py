"""Profiler integration: the program's spans, and a ``torch.profiler``
trace of a code block written to a directory (the port's counterpart of
``ldpcgputegra_tpu/utils/profiling.py``).

A span marks host work that the profiler cannot name by itself: pure
Python (a wrapper's variant pick, the sweep's accounting) or a request's
boundary (a decode call, a group of the sweep).  It costs next to nothing
unless a profiler runs: ``span()`` then returns one shared object that
records nothing.  While a profiler runs (checked at every span), a span
enters ``torch.profiler.record_function("ldpc." + name)``, so that it lies
in the profiler's trace as a ``user_annotation`` on the calling thread, on
the kernels' clock, and keeps a ``Span`` record in memory, read back by
``spans()``.  The record holds only what ran while a profiler ran.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time

import torch
from torch.autograd import profiler as _autograd_profiler

__all__ = ["span", "spans", "Span", "trace", "TRACE_DIR", "LIMIT"]

# under the checkout, git-ignored (bench_results/)
TRACE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "bench_results", "traces")

LIMIT = 1 << 18  # records kept, the latest
_records: collections.deque = collections.deque(maxlen=LIMIT)
_ids = itertools.count()
_local = threading.local()


def _open_spans() -> list:
    """This thread's open spans, innermost last."""
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class Span:
    """One span's record: ``name`` (``ldpc.<name>``), ``start`` and ``end``
    on ``time.perf_counter``, the span it ran inside (``parent``, None at
    the top), ``request`` (what the spans of one call or one group share:
    given, else the parent's, else a new integer) and ``count`` (the
    frames, batches or generators it handled; None where nothing is
    counted).  A caller that reads the clock at an edge itself passes that
    reading as ``start``, or sets it as ``end`` once the block has ended
    (the record is this object), so that the record and the caller's own
    arithmetic share one reading; on the shared object of ``span()`` with
    no profiler running, setting ``end`` does nothing."""

    __slots__ = ("name", "start", "end", "parent", "request", "count", "_rf")

    def __init__(self, name: str, request=None, count=None, start=None,
                 end=None, parent=None):
        self.name, self.request, self.count = name, request, count
        self.start, self.end, self.parent = start, end, parent
        self._rf = None

    def __enter__(self) -> "Span":
        stack = _open_spans()
        self.parent = stack[-1] if stack else None
        if self.request is None:
            self.request = (next(_ids) if self.parent is None
                            else self.parent.request)
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        if self.start is None:
            self.start = time.perf_counter()
        stack.append(self)
        return self

    def __exit__(self, *exc) -> bool:
        if self.end is None:
            self.end = time.perf_counter()
        _open_spans().pop()
        self._rf.__exit__(*exc)
        self._rf = None
        _records.append(self)
        return False


class _Off:
    """What ``span()`` returns with no profiler running: it records
    nothing, and what a block sets on it (``end``, ``count``) is
    dropped."""

    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def __setattr__(self, name, value) -> None:
        pass


_OFF = _Off()


def span(name: str, request=None, count=None, start=None):
    """A span of the program named ``"ldpc." + name``, used as ``with
    span(...) as sp:``; see ``Span`` for ``request``, ``count`` and
    ``start``.  With no profiler running it is one shared object that
    records nothing."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return Span("ldpc." + name, request, count, start)


def spans() -> list:
    """The spans that ended while a profiler ran, in the order they ended
    (the latest ``LIMIT``)."""
    return list(_records)


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Trace the host and, where there is one, the CUDA device around a
    code block; yields the directory the trace is written to when the
    block ends (``<host>_<pid>.<time>.pt.trace.json``: open it in
    Perfetto or ``chrome://tracing``, or with TensorBoard's profiler
    plugin).  The program's spans lie on it beside the operators and
    kernels, as ``ldpc.*`` annotations.  The default directory is
    ``bench_results/traces/<time>`` in the checkout."""
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

"""The measured window: its clock, the benchmark's span around it and, in a
traced run, the profiler.

A kind calls ``open()`` once set-up is over and ``close()`` once the
window's last work has come back; ``setup_s`` runs from the process's
start to ``open()``.  ``span(name)`` marks a call into the program on the
profiler's timeline (``bench_port.decode_call``, ``bench_port.block``);
the same spans run, at the cost of a few microseconds, when nothing
traces, so a traced window does the same host work as an untraced one.
"""

from __future__ import annotations

import os
import time

import torch


def process_start() -> float:
    """``time.perf_counter()``'s reading at this process's start."""
    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    age = uptime - ticks / os.sysconf("SC_CLK_TCK")
    return time.perf_counter() - max(age, 0.0)


class Window:
    def __init__(self, trace: bool, name: str = "bench_port.window"):
        self.trace = trace
        self.name = name
        self.prof = None
        self._span = None
        self.t_open = self.t_close = None

    def arm(self) -> None:
        """In a traced run, start the profiler now, ahead of a window that
        opens inside the program (its start takes seconds)."""
        if self.trace and self.prof is None:
            act = torch.profiler.ProfilerActivity
            self.prof = torch.profiler.profile(activities=[act.CPU, act.CUDA])
            self.prof.start()

    def open(self) -> None:
        self.arm()
        self._span = torch.profiler.record_function(self.name)
        self._span.__enter__()
        self.t_open = time.perf_counter()

    def close(self, t_close: float | None = None) -> None:
        """Close at ``t_close`` (default now): the window's work has all
        come back by then."""
        self.t_close = time.perf_counter() if t_close is None else t_close
        self._span.__exit__(None, None, None)
        if self.prof is not None:
            self.prof.stop()

    @property
    def seconds(self) -> float:
        return self.t_close - self.t_open
"""What a traced window's profiler timeline says: the device's busy time,
each kernel's time and count, and where the device sat idle.

The timeline is the profiler's Chrome trace, read back from a file under
the run's temporary directory.  The window is the benchmark's own span
(``Window.name``), from its start for ``Window.seconds``.  Device work is
every kernel, copy and fill; busy time is the length of their union.
An idle gap is named by the innermost ``bench_port.*`` span (the window's
own where no call's span covers it) and the
innermost other host event (an operator or a runtime call; "python" where
there is none) at its middle: what the host was doing while the device
waited.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
TOP = 10


@dataclasses.dataclass
class Timeline:
    window_s: float
    busy_s: float
    kernels: dict  # name -> [seconds, count], device work inside the window
    gaps: list  # [(label, seconds)], every idle gap inside the window

    def kernel(self, part: str) -> tuple[float, int]:
        """Seconds and count of the kernels whose name holds ``part``."""
        s = n = 0
        for name, (sec, cnt) in self.kernels.items():
            if part in name:
                s += sec
                n += cnt
        return s, n

    def breakdown(self) -> dict:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1][0])[:TOP]
        by_label = collections.Counter()
        for label, sec in self.gaps:
            by_label[label] += sec
        return {"device_ops": [[n[:100], v[0]] for n, v in ops],
                "idle_gaps": [[k, v] for k, v in by_label.most_common(TOP)]}


def read(prof, window) -> Timeline:
    """The timeline of ``window`` (a closed ``Window``) from ``prof``."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        os.remove(path)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    return timeline(events, window.name, window.seconds)


def timeline(events: list, span: str, seconds: float) -> Timeline:
    """The ``Timeline`` of the ``span`` window of ``seconds`` in a list of
    Chrome trace events (times in microseconds)."""
    spans = [e for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation" and e.get("name") == span]
    if not spans:
        raise RuntimeError(f"the trace has no {span!r} span")
    w = spans[0]
    lo, hi, tid = float(w["ts"]), float(w["ts"]) + 1e6 * seconds, w.get("tid")
    dev = []
    kernels: dict = {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        dev.append((a, b))
        k = kernels.setdefault(e["name"], [0.0, 0])
        k[0] += (b - a) * 1e-6
        k[1] += 1
    dev.sort()
    busy = 0.0
    holes = []
    cur = lo
    for a, b in dev:
        if a > cur:
            holes.append((cur, a))
        if b > cur:
            busy += b - max(a, cur)
            cur = b
    if cur < hi:
        holes.append((cur, hi))
    host = sorted(((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
                    e["name"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") in HOST_CATS
                   and e.get("tid") == tid),
                  key=lambda t: t[0])
    ours = [h for h in host if h[2].startswith("bench_port.")]
    theirs = [h for h in host if not h[2].startswith("bench_port.")]
    ours_t = [h[0] for h in ours]
    theirs_t = [h[0] for h in theirs]
    gaps = []
    for a, b in holes:
        mid = 0.5 * (a + b)
        label = (f"{_innermost(ours, ours_t, mid) or span}:"
                 f"{_innermost(theirs, theirs_t, mid) or 'python'}")
        gaps.append((label, (b - a) * 1e-6))
    return Timeline((hi - lo) * 1e-6, busy * 1e-6, kernels, gaps)


def _innermost(events: list, starts: list, t: float, look: int = 256):
    """The name of the latest-starting of ``events`` (sorted by start,
    ``starts`` their starts) that covers ``t``; None where none of the
    ``look`` before ``t`` does."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(-1, i - 1 - look), -1):
        if events[j][1] >= t:
            return events[j][2]
    return None

"""``refill_ms_per_group``: the sweep's host time from a fetch's return to
the next group's replay, in ms: for each ``ldpc.sweep.fetch`` span, from
its end to the end of the first ``ldpc.scan.prepare`` span after it
(the reseeding that the replay follows), where that prepare ends before
the next fetch starts; the mean over the fetches that have one.  The
fetch drains the stream, so in this stretch the device has nothing
queued.  The spans are the program's
(``ldpcgputegra_tpu_torch/utils/profiling.py``).  The sweep kind starts
the profiler before ``run_sweep``: the graph's capture and the first
groups' reseeding come before any fetch and are left out, so the groups
read are those after the first fetch, which opens the window.  None
where the program records no such spans."""

import bisect

from ldpcgputegra_tpu_torch.utils import profiling

FETCH = "ldpc.sweep.fetch"
PREPARE = "ldpc.scan.prepare"


def value(records) -> float | None:
    """The mean refill in ``records``, in ms."""
    fetches = sorted((r.start, r.end) for r in records if r.name == FETCH)
    prepared = sorted(r.end for r in records if r.name == PREPARE)
    gaps = []
    for i, (_, end) in enumerate(fetches):
        j = bisect.bisect_right(prepared, end)
        nxt = fetches[i + 1][0] if i + 1 < len(fetches) else float("inf")
        if j < len(prepared) and prepared[j] < nxt:
            gaps.append(prepared[j] - end)
    return 1e3 * sum(gaps) / len(gaps) if gaps else None


def read(ctx):
    spans = getattr(profiling, "spans", None)
    return value(spans()) if spans is not None else None

"""``wrapper_host_ms``: the decoder wrapper's host time a decode call, in
ms: the mean duration of the top-level ``ldpc.decode`` spans, which the
kernel wrappers record while a profiler runs
(``ldpcgputegra_tpu_torch/utils/profiling.py``).  The block kind starts
the profiler at the window's open and stops it at the close, so those
spans are the window's calls; a decode inside another of the program's
spans (a graph's capture in the sweep) is not a caller's call.  None
where the program records no such span."""

from ldpcgputegra_tpu_torch.utils import profiling

NAME = "ldpc.decode"


def value(records) -> float | None:
    """The mean ``NAME`` span at the top of ``records``, in ms."""
    dur = [r.end - r.start for r in records
           if r.name == NAME and r.parent is None]
    return 1e3 * sum(dur) / len(dur) if dur else None


def read(ctx):
    spans = getattr(profiling, "spans", None)
    return value(spans()) if spans is not None else None

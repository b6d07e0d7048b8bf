"""``twophase_k1_roofline``: the share of its roofline that the QC kernel
(``layered_minsum``) reaches over all its calls in the two-phase sweep's
traced window: the mean least time of a call by the data sheet
(``yardstick.decode_bound_s``) over its mean device time a call.  Each
call's work is its own batch and iterations: phase 1, batch x k1; phase
2, tail x iters; a repair, a phase 1 and a phase 2 of its unconverged
frames x iters.  The calls are counted from the window's
``twophase.stats`` (``layer["twophase"]``), whose batches and repairs set
the mix; the time from the profiler's timeline.  None where the run has
no such counts or K1 did not run."""

from bench_port.yardstick import decode_bound_s, int32_rate

KERNEL = "layered_minsum"


def bound_and_calls(layer: dict, rate: float):
    """The summed least time of the window's K1 calls and their count."""
    tp, b = layer["twophase"], layer["batch"]
    n1 = tp["batches"] + tp["repairs"]

    def bound(frames, iters):
        return decode_bound_s(layer["edge_updates"], iters, frames,
                              layer["n"], rate)

    total = n1 * bound(b, layer["k1"]) + tp["batches"] * bound(
        layer["tail"], layer["iters"])
    if tp["repairs"]:
        total += tp["repairs"] * bound(
            tp["repaired_frames"] / tp["repairs"], layer["iters"])
    return total, n1 + tp["batches"] + tp["repairs"]


def read(ctx):
    tl, layer = ctx.timeline, ctx.layer
    if tl is None or ctx.hw.get("clock_hz") is None or (
            not layer.get("twophase", {}).get("batches")):
        return None
    sec, n = tl.kernel(KERNEL)
    if n == 0 or sec <= 0:
        return None
    total, calls = bound_and_calls(
        layer, int32_rate(ctx.hw["sms"], ctx.hw["clock_hz"]))
    return 100.0 * (total / calls) / (sec / n)

"""What the per-layer readers share.  A reader's ``read(ctx)`` returns its
metric, or None where the run has nothing for it to read.  ``ctx.timeline``
is the traced window's ``trace.Timeline``, ``ctx.layer`` what the kind
counted (batch, n, edge updates, iterations a frame, host spans) and
``ctx.hw`` the card (``sms``, ``clock_hz``: its maximum SM clock)."""

from __future__ import annotations

from .yardstick import decode_bound_s, int32_rate

DECODE_KERNELS = "_minsum"  # layered_minsum, streamed_minsum, gather_minsum


def roofline(ctx, kernel: str):
    """The kernel's share of its roofline, %: a call's least time by the
    data sheet over its mean device time a call."""
    tl, layer = ctx.timeline, ctx.layer
    if tl is None or ctx.hw.get("clock_hz") is None or (
            "iters_per_frame" not in layer):
        return None
    sec, n = tl.kernel(kernel)
    if n == 0:
        return None
    bound = decode_bound_s(layer["edge_updates"], layer["iters_per_frame"],
                           layer["batch"], layer["n"],
                           int32_rate(ctx.hw["sms"], ctx.hw["clock_hz"]))
    return 100.0 * bound / (sec / n)


def idle_share(ctx):
    """The device's idle share of the traced window, %."""
    tl = ctx.timeline
    if tl is None or tl.window_s <= 0:
        return None
    return 100.0 * (1.0 - tl.busy_s / tl.window_s)


def non_decode_share(ctx):
    """Device time outside the decode kernels over all device time, %."""
    tl = ctx.timeline
    if tl is None:
        return None
    total = sum(sec for sec, _ in tl.kernels.values())
    decode, n = tl.kernel(DECODE_KERNELS)
    if total <= 0 or n == 0:
        return None
    return 100.0 * (total - decode) / total

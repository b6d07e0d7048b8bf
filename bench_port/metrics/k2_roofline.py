"""``k2_roofline``, and ``k2_roofline.block`` (the same reading in the cell
that moves ``block_p95_ms``): the share of its roofline that
``streamed_minsum`` reaches in the traced window (``readers.roofline``)."""

from bench_port.readers import roofline


def read(ctx):
    return roofline(ctx, "streamed_minsum")

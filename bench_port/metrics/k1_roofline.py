"""``k1_roofline``: the share of its roofline that ``layered_minsum`` reaches in the
traced window (``readers.roofline``)."""

from bench_port.readers import roofline


def read(ctx):
    return roofline(ctx, "layered_minsum")

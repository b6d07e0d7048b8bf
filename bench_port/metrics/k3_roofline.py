"""``k3_roofline``: the share of its roofline that ``gather_minsum`` (the
port's gather kernel, which stands in for the TPU's K3-K5) reaches in the
traced window (``readers.roofline``)."""

from bench_port.readers import roofline


def read(ctx):
    return roofline(ctx, "gather_minsum")

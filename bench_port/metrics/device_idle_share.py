"""``device_idle_share``, and ``device_idle_share.decode`` and
``device_idle_share.block`` (the same reading in cells that move another
end-to-end metric): the share of the traced window in which no kernel,
copy or fill ran on the device (``readers.idle_share``)."""

from bench_port.readers import idle_share


def read(ctx):
    return idle_share(ctx)

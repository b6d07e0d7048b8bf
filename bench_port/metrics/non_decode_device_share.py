"""``non_decode_device_share``: the device time of the channel, the
quantizer, the count and every other operation that is not a decode
kernel, over all device time in the traced window."""

from bench_port.readers import non_decode_share


def read(ctx):
    return non_decode_share(ctx)

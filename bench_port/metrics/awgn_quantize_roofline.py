"""``awgn_quantize_roofline``: the share of its roofline that the coded
form of the channel's kernel (``awgn_quantize_coded_kernel``) reaches in
the traced window: its bytes, batch x n x 6 (the noise read as float32,
the coded bits read, the int8 LLRs written, each once), at the data
sheet's 3.35 TB/s, over its mean device time a call.  None where that
kernel did not run: the all-zero codeword's form, which the fake-encoder
cells run, is not read here.  ``bytes_roofline`` is shared with
``count_errors_roofline``."""

from bench_port.yardstick import HBM_BYTES_PER_S


def bytes_roofline(ctx, kernel: str, cols: str, bytes_per_element: int):
    """``kernel``'s share of its roofline, %: batch x ``ctx.layer[cols]``
    x ``bytes_per_element`` bytes at the data sheet's rate over its mean
    device time a call; None where it did not run."""
    tl, layer = ctx.timeline, ctx.layer
    if tl is None or "batch" not in layer or cols not in layer:
        return None
    sec, calls = tl.kernel(kernel)
    if calls == 0 or sec <= 0:
        return None
    nbytes = layer["batch"] * layer[cols] * bytes_per_element
    return 100.0 * nbytes / HBM_BYTES_PER_S / (sec / calls)


def read(ctx):
    return bytes_roofline(ctx, "awgn_quantize_coded_kernel", "n", 6)

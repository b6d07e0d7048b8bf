"""``count_errors_roofline``: the share of its roofline that the count
against the bits sent (``count_errors_ref_kernel``) reaches in the traced
window: its bytes, batch x the counted columns x 2 (the decoded bits and
the bits sent, each read once; the columns are k where the info bits are
counted), at the data sheet's 3.35 TB/s, over its mean device time a
call.  None where that kernel did not run: the count against the
all-zero codeword, which the fake-encoder cells run, is not read here."""

from bench_port.metrics.awgn_quantize_roofline import bytes_roofline


def read(ctx):
    return bytes_roofline(ctx, "count_errors_ref_kernel", "counted_cols", 2)

"""Benchmark harness (CUDA-event timing, coded-throughput accounting), the
roofline and the probes of the card's ceilings.

The entry points ``bench.suite`` (the benchmark suite) and
``bench.profile_1944`` (the odd-Z profile with the roll probe) are run as
``python -m``; they are not imported here, so that running them does not
load them twice.
"""

from .harness import measure_call, throughput_report
from .roofline import (
    HwSpec,
    hw_spec,
    kernel_model,
    roofline_report,
    table_spec,
)
from .vpu_probe import measure_alu_rate, measure_hbm_bw

__all__ = ["measure_call", "throughput_report", "HwSpec", "hw_spec",
           "table_spec", "kernel_model", "roofline_report",
           "measure_alu_rate", "measure_hbm_bw"]

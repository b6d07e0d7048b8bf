"""Benchmark harness (CUDA-event timing, coded-throughput accounting)."""

from .harness import measure_call, throughput_report

__all__ = ["measure_call", "throughput_report"]

"""Device timing on the card with CUDA events.

``measure_call`` records a CUDA event before and after k back-to-back
calls on the current stream, for two values of k, and returns the slope:
the per-call device time with the fixed cost of a timed window (the
event records, the launch of the first call) cancelled out.  It replaces
the JAX package's salted slope harness, whose relay hazards do not exist
on a local card, and plays the role of the reference's CUDA-event timer
(``code/gpu_fixed/timer/CTimer.cu:31-60``).

It times the card only: inputs that are not CUDA tensors raise.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

__all__ = ["measure_call", "throughput_report"]


def measure_call(
    fn: Callable,
    inputs: Sequence[torch.Tensor],
    k_small: int = 4,
    k_large: int = 20,
    repeats: int = 3,
) -> float:
    """Seconds per ``fn(input)`` call on the card, by CUDA events.

    ``inputs`` are CUDA tensors, cycled through.  Each count k is timed
    ``repeats`` times and the fastest kept.
    """
    if not inputs or any(
        not isinstance(x, torch.Tensor) or x.device.type != "cuda"
        for x in inputs
    ):
        raise RuntimeError("measure_call times the card: inputs must be "
                           "CUDA tensors")
    dev = inputs[0].device
    with torch.cuda.device(dev):
        for x in inputs:  # warm-up: builds, allocator pools
            fn(x)
        torch.cuda.synchronize(dev)

        def run(k: int) -> float:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for i in range(k):
                fn(inputs[i % len(inputs)])
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3

        t_small = min(run(k_small) for _ in range(repeats))
        t_large = min(run(k_large) for _ in range(repeats))
    return max((t_large - t_small) / (k_large - k_small), 1e-9)


def throughput_report(
    seconds_per_call: float, frames: int, n: int
) -> dict:
    """Coded-throughput numbers in the reference's accounting
    (coded bits / time, ``code/gpu_fixed/main.cpp:311-315``)."""
    coded_bits = frames * n
    return {
        "ms_per_call": seconds_per_call * 1e3,
        "frames_per_s": frames / seconds_per_call,
        "coded_mbps": coded_bits / seconds_per_call / 1e6,
        "coded_gbps": coded_bits / seconds_per_call / 1e9,
    }

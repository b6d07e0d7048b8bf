"""Device timing on the card with CUDA events.

``measure_call`` records a CUDA event before and after k back-to-back
calls on the current stream, for two values of k, and returns the slope:
the per-call device time with the fixed cost of a timed window (the
event records, the launch of the first call) cancelled out.  It replaces
the JAX package's salted slope harness, whose relay hazards do not exist
on a local card, and plays the role of the reference's CUDA-event timer
(``code/gpu_fixed/timer/CTimer.cu:31-60``).

``measure_host_call`` times a path that the host drives (it reads a
value from the card between launches, as the two-phase decoder does) by
the host clock, with the card synchronised at each end of a window, over
disjoint slices of its inputs.

Both time the card only: inputs that are not CUDA tensors raise.
"""

from __future__ import annotations

import time
from typing import Callable, Sequence

import torch

__all__ = ["measure_call", "measure_host_call", "device_time_by_kernel",
           "throughput_report"]


def _cuda_inputs(inputs, who: str) -> torch.device:
    if not inputs or any(
        not isinstance(x, torch.Tensor) or x.device.type != "cuda"
        for x in inputs
    ):
        raise RuntimeError(f"{who} times the card: inputs must be CUDA "
                           "tensors")
    return inputs[0].device


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
    dev = _cuda_inputs(inputs, "measure_call")
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


def measure_host_call(
    fn: Callable,
    inputs: Sequence[torch.Tensor],
    k_small: int = 3,
    k_large: int = 12,
    warm: int = 2,
    repeats: int = 1,
) -> float:
    """Seconds per ``fn(input)`` call of a host-driven path, by the host
    clock: the slope between a window of ``k_small`` calls and one of
    ``k_large``, each from a synchronised card to a synchronised card.

    The warm-up, the small and the large window take disjoint slices of
    ``inputs`` (``warm + k_small + k_large`` CUDA tensors); ``repeats``
    times each window again on the same slice and keeps the fastest.
    """
    dev = _cuda_inputs(inputs, "measure_host_call")
    need = warm + k_small + k_large
    if len(inputs) < need:
        raise ValueError(f"need {need} distinct inputs, got {len(inputs)}")

    def run(k: int, ofs: int) -> float:
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for i in range(k):
            fn(inputs[ofs + i])
        torch.cuda.synchronize(dev)
        return time.perf_counter() - t0

    with torch.cuda.device(dev):
        run(warm, 0)
        t_small = min(run(k_small, warm) for _ in range(repeats))
        t_large = min(run(k_large, warm + k_small) for _ in range(repeats))
    return max((t_large - t_small) / (k_large - k_small), 1e-9)


def device_time_by_kernel(prof) -> dict[str, float]:
    """Microseconds of device time by kernel name (kernels, copies, sets)
    in a finished ``torch.profiler.profile``."""
    dev_us: dict[str, float] = {}
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            t = getattr(evt, "self_device_time_total", None)
            if t is None:
                t = evt.self_cuda_time_total
            dev_us[evt.key] = dev_us.get(evt.key, 0.0) + t
    return dev_us


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

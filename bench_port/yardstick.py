"""The benchmark's frozen arithmetic: seeds, the channel's sigma, the
data sheet's rates and a decode's operations and bytes.

Each is a copy, kept here so that a change to the program cannot move
the yardstick: ``batch_seed`` is ``ldpcgputegra_tpu_torch/sim/sweep.py``'s
formula (the sweep's batch k of point p draws its noise from a generator
seeded with it), ``sigma_for_snr`` is ``channel/awgn.py``'s, and the
roofline is ``bench/roofline.py``'s with the data sheet's rates: 21
integer operations a min-sum edge update (``kernels/_lib.py``'s
``OPS_PER_EDGE``), SMs x 64 int32 lanes x the maximum SM clock, and
3.35 TB/s of device memory; the bytes are the LLRs read and the bits
written once.
"""

from __future__ import annotations

import math

import numpy as np

OPS_PER_EDGE = 21
INT32_LANES_PER_SM = 64
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet


def batch_seed(seed: int, point: int, batch: int) -> int:
    """The generator seed of batch ``batch`` of SNR point ``point``."""
    return int(np.random.SeedSequence((seed, point, batch)).generate_state(
        1, np.uint64)[0] >> 1)


def sample_rng(seed: int, stream: int) -> np.random.Generator:
    """A NumPy generator for the benchmark's own draws (which answers are
    checked), apart from every input's noise."""
    return np.random.default_rng(np.random.SeedSequence((seed, 0x5EED, stream)))


def sigma_for_snr(ebn0_db: float, rate: float) -> float:
    """Noise sigma per real dimension of BPSK at Eb/N0 ``ebn0_db``."""
    return math.sqrt(10.0 ** (-0.1 * (ebn0_db + 10.0 * math.log10(rate))) / 2.0)


def int32_rate(sms: int, max_clock_hz: float) -> float:
    """The data sheet's int32 operations a second."""
    return sms * INT32_LANES_PER_SM * max_clock_hz


def decode_bound_s(edge_updates: int, iters_per_frame: float, batch: int,
                   n: int, alu_rate: float,
                   hbm_rate: float = HBM_BYTES_PER_S) -> float:
    """The least time one decode call of ``batch`` frames could take: its
    operations over the int32 rate or its bytes over the memory rate,
    whichever is longer."""
    ops = edge_updates * iters_per_frame * batch * OPS_PER_EDGE
    return max(ops / alu_rate, 2.0 * batch * n / hbm_rate)

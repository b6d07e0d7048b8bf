"""BPSK over AWGN, quantized to int8 LLRs: the all-zero codeword sent as
-1, noise ``sigma * randn`` from the generator given, then ``y * factor``
clamped to +-sat and truncated toward zero.  Every product is float32 as
in the program, so one seed gives the same LLRs on both sides."""

from __future__ import annotations

import torch

from ..yardstick import sigma_for_snr


def zero_llrs(gen: torch.Generator, batch: int, n: int, k: int,
              ebn0_db: float, factor: int, bits_llr: int,
              device) -> torch.Tensor:
    """``[batch, n]`` int8 LLRs of the all-zero codeword at ``ebn0_db``,
    drawn from ``gen`` (a generator on ``device``, first use)."""
    sigma = torch.tensor(sigma_for_snr(ebn0_db, k / n), dtype=torch.float32,
                         device=device)
    f = torch.tensor(float(factor), dtype=torch.float32, device=device)
    sat = float((1 << (bits_llr - 1)) - 1)
    noise = sigma * torch.randn((batch, n), generator=gen, device=device)
    y = torch.full((batch, n), -1.0, dtype=torch.float32, device=device) + noise
    return (y * f).clamp(-sat, sat).to(torch.int8)


def seeded(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)

"""Info-bit generation (reference C6, ``CBitGenerator.cpp:23-39``), on a
``torch.Generator`` (the port's counterpart of
``ldpcgputegra_tpu/channel/bitgen.py``, which draws from a NumPy
generator: the two streams differ, so the contract is statistical)."""

from __future__ import annotations

import torch

__all__ = ["generate_info_bits"]


def generate_info_bits(gen: torch.Generator, batch: int, k: int,
                       random_bits: bool = True) -> torch.Tensor:
    """[batch, K] int8 info bits on the generator's device: uniform random
    (``-random``) or all zero."""
    if random_bits:
        return torch.randint(0, 2, (batch, k), generator=gen,
                             device=gen.device, dtype=torch.int8)
    return torch.zeros((batch, k), dtype=torch.int8, device=gen.device)

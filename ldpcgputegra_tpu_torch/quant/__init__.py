"""Fixed-point LLR quantization (the port's counterpart of
``ldpcgputegra_tpu/quant/__init__.py``).

Float channel LLRs are scaled by ``FACTEUR_BETA`` (default 8), truncated
toward zero (a C int cast) and clamped to the LLR saturation range
(default ±31 for 6-bit LLRs), yielding int8
(``code/x86/CFixPointConversion/CFastFixConversion.cpp:54-67``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["QuantSpec", "quantize_llr", "optimal_llr_factor",
           "dequantize_llr", "llr_histogram", "print_llr_histogram"]


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """LLR fixed-point format.

    ``factor``: scale applied before truncation (FACTEUR_BETA).
    ``bits_llr``: quantizer bit width; saturation = 2**(bits_llr-1) - 1.
    """

    factor: int = 8
    bits_llr: int = 6

    @property
    def sat(self) -> int:
        return (1 << (self.bits_llr - 1)) - 1


def quantize_llr(x: torch.Tensor, spec: QuantSpec = QuantSpec(),
                 factor=None) -> torch.Tensor:
    """float32 LLRs -> int8, truncate toward zero, then saturate.

    The clamp comes first: a float -> int8 cast truncates toward zero but
    is undefined out of range.  ``factor`` overrides ``spec.factor``; a
    0-d float32 tensor gives the same values as the float it holds.
    """
    f = spec.factor if factor is None else factor
    if not isinstance(f, torch.Tensor):
        f = float(f)
    sat = float(spec.sat)
    return (x * f).clamp(-sat, sat).to(torch.int8)


def optimal_llr_factor(sigma: float, spec: QuantSpec = QuantSpec()) -> float:
    """Adaptive quantizer scale (the reference's -ollr idea): scale so that
    |y| <= 1 + k*sigma maps onto the full quantizer range, with k the
    Gaussian quantile covering all but 2^(1-bits) of the noise mass."""
    from statistics import NormalDist

    tail = 2.0 ** (1 - spec.bits_llr)
    k = NormalDist().inv_cdf(1.0 - tail / 2.0)
    return spec.sat / (1.0 + k * sigma)


def dequantize_llr(q: torch.Tensor, spec: QuantSpec = QuantSpec()) -> torch.Tensor:
    """int8 fixed-point LLRs -> float32 (inverse scale; lossy)."""
    return q.to(torch.float32) / float(spec.factor)


def llr_histogram(q, spec: QuantSpec = QuantSpec()) -> dict[int, float]:
    """Occupancy histogram of quantized LLRs, in percent (the reference's
    ``-histo`` dump, ``CFastFixConversion.cpp:31-47``)."""
    if isinstance(q, torch.Tensor):
        q = q.cpu().numpy()
    q = np.asarray(q).ravel()
    vals, counts = np.unique(q, return_counts=True)
    return {int(v): 100.0 * c / q.size for v, c in zip(vals, counts)}


def print_llr_histogram(q, spec: QuantSpec = QuantSpec()) -> None:
    h = llr_histogram(q, spec)
    print("(HISTO) START")
    for v in range(-spec.sat - 1, spec.sat + 2):
        if v in h:
            print(f"(HISTO) {v:4d}\t{h[v]:f}")
    print("(HISTO) STOP")

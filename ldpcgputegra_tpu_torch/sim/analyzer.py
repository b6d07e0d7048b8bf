"""BER/FER error accounting (reference M1, CErrorAnalyzer), in PyTorch.

Counting happens on the decoded tensor's device (errors vs the transmitted
bits, or vs the all-zero codeword like the GPU analyzer,
``code/gpu_fixed/ber_analyzer/CErrorAnalyzer.cpp:142-149``); only two
scalars per batch cross back to the host, and the sweep fetches them in
windows.  The adaptive frame-error limit reproduces
``CErrorAnalyzer::fe_limit`` exactly (``CErrorAnalyzer.cpp:96-117``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..kernels import channel as channel_kernels

__all__ = ["count_errors", "count_errors_async", "ErrorAnalyzer"]


def count_errors_async(decoded: torch.Tensor, reference=None,
                       info_only: bool = False, k: Optional[int] = None):
    """Device-side (BE, FE) int64 scalars for a decoded batch [B, N], not
    fetched, so callers can keep batches in flight.

    ``reference=None`` is the all-zero-codeword convention (any nonzero
    decoded bit is an error); else a decoded bit is an error where it
    differs from the reference's.  On a CUDA tensor one kernel
    (``kernels/channel.py::count_errors``, which takes 2-D uint8, int8 or
    bool frames, and a reference of their type, shape and device, and
    raises on any other) counts; every CPU tensor takes the PyTorch
    operations.  Both give the same counts.
    """
    if decoded.device.type == "cuda":
        cols = decoded.shape[-1]
        if info_only and k is not None:
            cols = min(k, cols)
        be, fe = channel_kernels.count_errors(decoded, cols, reference)
        return be, fe
    err = decoded != 0 if reference is None else decoded != reference
    if info_only and k is not None:
        err = err[:, :k]
    be_per_frame = err.sum(dim=1)
    return be_per_frame.sum(), (be_per_frame != 0).sum()


def count_errors(decoded: torch.Tensor, reference=None,
                 info_only: bool = False, k: Optional[int] = None):
    """Like ``count_errors_async``, fetched to host ints."""
    be, fe = count_errors_async(decoded, reference, info_only, k)
    return int(be), int(fe)


@dataclasses.dataclass
class ErrorAnalyzer:
    """Host-side accumulator with the reference's adaptive FE stopping."""

    n: int  # coded bits per frame (nb_data)
    k: int  # info bits per frame (nb_vars in x86 naming)
    max_fe: int = 100
    auto_fe: bool = True
    # bits counted per frame: k for --info-ber, n otherwise
    counted_bits: Optional[int] = None

    def __post_init__(self) -> None:
        if self.counted_bits is None:
            self.counted_bits = self.n

    frames: int = 0
    bit_errors: int = 0
    frame_errors: int = 0

    def reset(self) -> None:
        self.frames = 0
        self.bit_errors = 0
        self.frame_errors = 0

    def add_batch(self, decoded, reference=None) -> tuple[int, int]:
        """Count a decoded batch and accumulate; returns (be, fe)."""
        be, fe = count_errors(decoded, reference)
        self.add_counts(decoded.shape[0], be, fe)
        return be, fe

    def add_counts(self, frames: int, be: int, fe: int) -> None:
        self.frames += frames
        self.bit_errors += be
        self.frame_errors += fe

    def accumulate(self, other: "ErrorAnalyzer") -> None:
        self.add_counts(other.frames, other.bit_errors, other.frame_errors)

    @property
    def ber(self) -> float:
        if not self.frames:
            return 0.0
        return self.bit_errors / (self.frames * self.counted_bits)

    @property
    def fer(self) -> float:
        return self.frame_errors / self.frames if self.frames else 0.0

    def fe_limit(self) -> int:
        if not self.auto_fe:
            return self.max_fe
        ber = self.ber
        if ber < 1.0e-9:
            return self.max_fe // 16
        if ber < 1.0e-8:
            return self.max_fe // 8
        if ber < 1.0e-7:
            return self.max_fe // 4
        if ber < 1.0e-6:
            return self.max_fe // 2
        return self.max_fe

    def fe_limit_achieved(self) -> bool:
        return self.frame_errors >= self.fe_limit()

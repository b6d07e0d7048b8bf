"""AWGN channel with BPSK/QPSK mapping, in PyTorch (the port's counterpart
of ``ldpcgputegra_tpu/channel/awgn.py``).

* sigma from Eb/N0 or Es/N0 and the code rate:
  ``sigma = sqrt(10^(-(EbN0_dB + 10*log10(R))/10) / 2)``, with
  ``EbN0 = EsN0 - 10*log10(2R)`` in Es/N0 mode
  (``CChanel_AWGN_SIMD.cu:63-73``);
* BPSK maps bit 1 -> +1, bit 0 -> -1; QPSK uses ±1/sqrt(2) per dimension;
* optional normalization ``2/sigma^2``, flat Rayleigh fading, noiseless
  mode, and LLR sign-flip fault injection;
* the quantized path is ``quant.quantize_llr`` on the float values.

Randomness comes from an explicit ``torch.Generator`` on the output's
device.  It cannot reproduce the JAX package's threefry stream: the
contract is statistical.

sigma, the quantizer's factor and the normalisation 2/sigma^2 are held as
0-d float32 tensors on the channel's device, filled by ``configure``, so
that a CUDA graph captured over ``generate*`` serves every SNR point, as
one JAX executable takes sigma and the factor as traced scalars
(``sim/sweep.py``).  A float32 tensor operand gives the same products as
the Python float it holds, so the values do not depend on that.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ..decoder import default_device
from ..quant import QuantSpec, optimal_llr_factor, quantize_llr

__all__ = ["ChannelSpec", "sigma_for_snr", "AwgnChannel"]

_INV_SQRT2 = 1.0 / math.sqrt(2.0)


def sigma_for_snr(
    snr_db: float, rate: float, es_n0: bool = False, qpsk: bool = False
) -> float:
    """Noise sigma per real dimension from SNR in dB (``CChanel::configure``;
    Es/N0 mode assumes 2 bits per symbol, like the reference)."""
    eb_n0 = snr_db - 10.0 * math.log10(2.0 * rate) if es_n0 else snr_db
    interm = -0.1 * (eb_n0 + 10.0 * math.log10(rate))
    return math.sqrt((10.0 ** interm) / 2.0)


@dataclasses.dataclass(frozen=True)
class ChannelSpec:
    """Static channel configuration; same fields as the JAX package's."""

    qpsk: bool = False
    es_n0: bool = False
    normalize: bool = False  # -norm-channel: scale output by 2/sigma^2
    fading: str = "none"  # none | rayleigh
    opt_llr: bool = False  # -ollr: adapt quantizer scale to sigma
    no_channel: bool = False  # -no-channel: noiseless (perfect LLRs)
    inject_flip_p: float = 0.0  # probability of flipping an LLR's sign
    quant: QuantSpec = QuantSpec()


def _generate_float(gen: torch.Generator, tx_bits: torch.Tensor,
                    sigma: torch.Tensor, norm: torch.Tensor,
                    spec: ChannelSpec) -> torch.Tensor:
    """Received values for coded bits; ``sigma`` and ``norm`` (2/sigma^2,
    read only with ``spec.normalize``) are 0-d float32 tensors."""
    amp = _INV_SQRT2 if spec.qpsk else 1.0
    symbols = torch.where(tx_bits != 0, amp, -amp).to(torch.float32)
    if spec.no_channel:
        return symbols
    noise = sigma * torch.randn(symbols.shape, generator=gen,
                                device=symbols.device)
    if spec.fading == "rayleigh":
        g = torch.randn((2, *symbols.shape), generator=gen,
                        device=symbols.device)
        h = torch.sqrt((g[0] * g[0] + g[1] * g[1]) * 0.5)  # E[h^2] = 1
        # matched filter (perfect CSI): y = h*(h*x + n) keeps the LLR sign
        y = h * (h * symbols + noise)
    elif spec.fading == "none":
        y = symbols + noise
    else:
        raise ValueError(f"unknown fading {spec.fading!r}")
    if spec.normalize:
        y = y * norm
    return y


def _quantize(gen, y, factor, spec: ChannelSpec) -> torch.Tensor:
    q = quantize_llr(y, spec.quant, factor)
    if spec.inject_flip_p > 0.0:
        flip = torch.rand(q.shape, generator=gen, device=q.device) \
            < spec.inject_flip_p
        q = torch.where(flip, -q, q)
    return q


class AwgnChannel:
    """AWGN channel over a [batch, N] frame block.

    ``configure(snr_db)`` fixes sigma, then ``generate*`` produce received
    LLR frames on ``device`` (default: ``decoder.default_device()``, the
    card, raising without one) from the generator they are given.
    """

    def __init__(self, n: int, k: int, spec: ChannelSpec = ChannelSpec(),
                 device=None):
        self.n = n
        self.k = k
        self.spec = spec
        self.rate = k / n
        self.device = (torch.device(device) if device is not None
                       else default_device())
        self.sigma: Optional[float] = None
        self.factor: Optional[float] = None
        # sigma, factor, 2/sigma^2 as float32 on the device (see above)
        self._scalars = torch.zeros(3, dtype=torch.float32, device=self.device)

    def configure(self, snr_db: float) -> float:
        self.sigma = sigma_for_snr(
            snr_db, self.rate, self.spec.es_n0, self.spec.qpsk
        )
        self.factor = (optimal_llr_factor(self.sigma, self.spec.quant)
                       if self.spec.opt_llr else float(self.spec.quant.factor))
        for t, v in zip(self._scalars, (self.sigma, self.factor,
                                        2.0 / (self.sigma * self.sigma))):
            t.fill_(v)  # a launch on the stream, no host wait
        return self.sigma

    def _check(self) -> None:
        if self.sigma is None:
            raise RuntimeError("call configure(snr_db) first")

    def generator(self, seed: int) -> torch.Generator:
        """A generator on this channel's device, seeded with ``seed``."""
        return torch.Generator(device=self.device).manual_seed(seed)

    def generate_float(self, gen: torch.Generator,
                       tx_bits: torch.Tensor) -> torch.Tensor:
        """Float received values for explicit coded bits [B, N]."""
        self._check()
        return _generate_float(gen, tx_bits.to(self.device), self._scalars[0],
                               self._scalars[2], self.spec)

    def generate_int8(self, gen: torch.Generator,
                      tx_bits: torch.Tensor) -> torch.Tensor:
        """Quantized int8 LLRs for explicit coded bits [B, N]."""
        return _quantize(gen, self.generate_float(gen, tx_bits),
                         self._scalars[1], self.spec)

    def generate_zero_int8(self, gen: torch.Generator, batch: int) -> torch.Tensor:
        """Quantized int8 LLRs for the all-zero codeword (the GPU channel's
        only mode: ``CChanel_AWGN_SIMD.cu:22`` hard-codes tx = -1)."""
        zeros = torch.zeros((batch, self.n), dtype=torch.int8,
                            device=self.device)
        return self.generate_int8(gen, zeros)

"""Coded frames for the reference: the info bits a batch's generator
draws, the DVB-S2 encoder, and BPSK over AWGN on the coded bits, quantized
to int8 LLRs.

* The info bits: ``[batch, k]`` int8 of 0 and 1 from
  ``torch.randint(0, 2, ...)`` on the batch's generator, before its noise.
* The encoder, from ETSI EN 302 307 V1.2.1, 5.3.2: the parity bits
  p_0 .. p_{n-k-1} start at 0; info bit i_m (m = 0 .. k-1) adds into
  p_a for each address a = (x + (m mod 360) q) mod (n - k), x over the
  addresses of row floor(m / 360) of the code's parity address table
  (Annex B or C), q = (n - k) / 360; then p_i = p_i xor p_{i-1} for
  i = 1 .. n-k-1, and the codeword is the info bits then the parity bits.
  Here the additions are one product over GF(2): the info bits times the
  0/1 matrix of (info bit, address) pairs, in float64 (exact: its sums
  stay far below 2^53, and TF32 never applies to float64), taken mod 2;
  the chain of xors is a running sum taken mod 2.  The table is read from
  the configuration's ``encoder_file`` as data (``rows``: the table's
  rows, ``M``: 360, ``Q``: q).
* The channel: bit 1 sent as +1 and bit 0 as -1 in float32, plus
  ``sigma * randn`` from the generator given, then ``y * factor`` clamped
  to +-sat and truncated toward zero, every product float32 as in
  ``channel.zero_llrs``.

It imports nothing of ``ldpcgputegra_tpu_torch``, ``ldpcgputegra_tpu`` or
jax.
"""

from __future__ import annotations

import functools
import json
import os

import torch

from ..yardstick import sigma_for_snr


def info_bits(gen: torch.Generator, batch: int, k: int, device) -> torch.Tensor:
    """``[batch, k]`` int8 info bits, the generator's first draw."""
    return torch.randint(0, 2, (batch, k), generator=gen, dtype=torch.int8,
                         device=device)


@functools.lru_cache(maxsize=None)
def _table(path: str) -> tuple:
    with open(path) as f:
        doc = json.load(f)
    return (int(doc["N"]), int(doc["K"]), int(doc["M"]), int(doc["Q"]),
            tuple(tuple(int(x) for x in row) for row in doc["rows"]))


def parity_matrix(path: str, device) -> torch.Tensor:
    """``[k, n - k]`` float64: entry (m, a) the times info bit m adds into
    parity address a, from the parity address table at ``path``."""
    n, k, m360, q, rows = _table(path)
    if len(rows) * m360 != k or q * m360 != n - k:
        raise ValueError(f"{path}: the table does not cover k = {k} info "
                         f"bits of an (n, k) = ({n}, {k}) code")
    a = torch.zeros((k, n - k), dtype=torch.float64, device=device)
    for g, row in enumerate(rows):
        x = torch.tensor(row, dtype=torch.int64, device=device)
        m = torch.arange(m360, dtype=torch.int64, device=device)
        addr = (x[None, :] + m[:, None] * q) % (n - k)  # [360, len(row)]
        bit = (g * m360 + m)[:, None].expand_as(addr)
        a.index_put_((bit.reshape(-1), addr.reshape(-1)),
                     torch.ones(addr.numel(), dtype=torch.float64,
                                device=device), accumulate=True)
    return a


def encode(path: str, info: torch.Tensor) -> torch.Tensor:
    """Codewords ``[batch, n]`` int8 of ``info`` ``[batch, k]`` int8 by the
    parity address table at ``path``."""
    sums = info.to(torch.float64) @ parity_matrix(path, info.device)
    acc = sums.to(torch.int64) & 1
    parity = acc.cumsum(1) & 1
    return torch.cat([info, parity.to(torch.int8)], dim=1)


def coded_llrs(gen: torch.Generator, codewords: torch.Tensor, k: int,
               ebn0_db: float, factor: int, bits_llr: int) -> torch.Tensor:
    """``[batch, n]`` int8 LLRs of ``codewords`` at ``ebn0_db``, the noise
    drawn from ``gen`` (a generator on the codewords' device)."""
    batch, n = codewords.shape
    dev = codewords.device
    sigma = torch.tensor(sigma_for_snr(ebn0_db, k / n), dtype=torch.float32,
                         device=dev)
    f = torch.tensor(float(factor), dtype=torch.float32, device=dev)
    sat = float((1 << (bits_llr - 1)) - 1)
    noise = sigma * torch.randn((batch, n), generator=gen, device=dev)
    sent = torch.where(codewords != 0, 1.0, -1.0).to(torch.float32)
    y = sent + noise
    return (y * f).clamp(-sat, sat).to(torch.int8)


def coded_frames(gen: torch.Generator, config: dict, root: str, batch: int,
                 ebn0_db: float, bits_llr: int | None = None) -> tuple:
    """(codewords, LLRs) of one batch from ``gen`` (first use): the info
    bits, their encoding by the configuration's ``encoder_file``, the
    channel on the codewords; ``bits_llr`` overrides the LLR width."""
    cw = encode(os.path.join(root, config["encoder_file"]),
                info_bits(gen, batch, config["k"], gen.device))
    return cw, coded_llrs(gen, cw, config["k"], ebn0_db,
                          config["quant_factor"],
                          bits_llr or config["bits_llr"])

"""Encoders (the port's counterpart of
``ldpcgputegra_tpu/channel/encoder.py``; reference components C5/C6 and
beyond): info bits [B, K] -> codeword bits [B, N], int8 tensors on the
info bits' device.

* ``FakeEncoder`` — the all-zero codeword (``CFakeEncoder.cpp:17-30``);
* ``QCAccumulateEncoder`` — the DVB-S2-style QC accumulator of a runtime
  table (``GenericEncoder.cpp:38-78``);
* ``StaircaseEncoder`` — the same accumulator form read off any H with
  dual-diagonal parity (every DVB-S2-family code), in the base column
  order (the decoders permute a staircase code's QC view at entry and
  exit);
* ``GF2Encoder`` — any code, by one-time GF(2) Gauss-Jordan elimination.

The tables are built once in NumPy, as in the JAX package, and copied to a
device at its first encode there.  Encoding runs on that device: the
accumulate and staircase forms share one parity table, each row's info
bits in CSR form (``kernels/encoder.py::parity_table``), and one call,
``kernels/encoder.py::accumulate_encode`` (on the card one kernel, on the
CPU an ``index_add_`` of info bits into parity sums, then a running XOR as
a cumulative sum taken mod 2); GF(2) is ``u @ S^T mod 2`` as a float64
matrix product, exact (its sums stay far below 2^53; TF32 would round
them).  The JAX package encodes with NumPy on the host (or its native C++
where built, with the same outputs); the results are equal bit for bit on
the same info bits.

An encode queues its operations with no host synchronisation and no
shape that depends on the data, so a CUDA graph captures it once the
tables are on the card (the sweep's eager warm-up batch copies them and
loads the kernel's library).  ``Encoder.encode`` runs in the span
``ldpc.encode`` (count: the frames) and adds one to ``encodes[kind]``;
the table encoder's parity table is built at set-up in the span
``ldpc.encoder.build`` (count: the table's pairs).
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from ..codes.code import LdpcCode
from ..codes.registry import DATA_DIR
from ..kernels.encoder import accumulate_encode, parity_table
from ..utils.profiling import span

__all__ = [
    "Encoder",
    "FakeEncoder",
    "QCAccumulateEncoder",
    "StaircaseEncoder",
    "GF2Encoder",
    "make_encoder",
    "encodes",
]

# Batches encoded in this process, by encoder kind: ``Encoder.encode`` adds
# one a call, and nowhere else.
encodes = {"fake": 0, "table": 0, "staircase": 0, "gf2": 0}


class Encoder:
    """Batched encoder interface: info bits [B, K] -> codeword bits [B, N],
    int8 on the info bits' device."""

    n: int
    k: int
    kind: str  # the key of ``encodes`` (``make_encoder``'s kind)

    def __init__(self) -> None:
        self._tables: dict[torch.device, tuple] = {}

    def _on(self, device: torch.device, *arrays: np.ndarray) -> tuple:
        """``arrays`` as tensors on ``device``, copied once a device."""
        if device not in self._tables:
            self._tables[device] = tuple(torch.as_tensor(a, device=device)
                                         for a in arrays)
        return self._tables[device]

    def _check(self, info_bits: torch.Tensor) -> None:
        if not isinstance(info_bits, torch.Tensor):
            raise TypeError("info_bits must be a torch tensor")
        if info_bits.dim() != 2 or info_bits.shape[1] != self.k:
            raise ValueError(f"info_bits must be [B, {self.k}], got "
                             f"{tuple(info_bits.shape)}")

    def encode(self, info_bits: torch.Tensor) -> torch.Tensor:
        """Codeword bits [B, N] int8 for ``info_bits`` [B, K]."""
        with span("encode", count=len(info_bits)):
            out = self._encode(info_bits)
        encodes[self.kind] += 1
        return out

    def _encode(self, info_bits: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


class FakeEncoder(Encoder):
    """All-zero codeword (CFakeEncoder): ignores info bits."""

    kind = "fake"

    def __init__(self, n: int, k: int):
        super().__init__()
        self.n, self.k = n, k

    def _encode(self, info_bits: torch.Tensor) -> torch.Tensor:
        return torch.zeros((info_bits.shape[0], self.n), dtype=torch.int8,
                           device=info_bits.device)


class _AccumulateEncoder(Encoder):
    """The accumulate form: parity p_j = p_{j-1} ^ XOR(info bits of row j),
    from the parity table ``(_row_ptr, _cols)`` that a subclass builds
    (``kernels/encoder.py::parity_table``)."""

    _row_ptr: np.ndarray
    _cols: np.ndarray

    def _encode(self, info_bits: torch.Tensor) -> torch.Tensor:
        self._check(info_bits)
        row_ptr, cols = self._on(info_bits.device, self._row_ptr, self._cols)
        return accumulate_encode(info_bits.to(torch.int8).contiguous(),
                                 row_ptr, cols, self.n)


class QCAccumulateEncoder(_AccumulateEncoder):
    """DVB-S2-style QC accumulator from a runtime table.

    Table semantics follow ``GenericEncoder::encode``: info bits are walked
    in groups of ``m`` (=360); group ``g`` uses table line ``g`` whose
    positions scatter as ``(pos + (x % m) * q) % (n - k)``; a final running
    XOR turns accumulated parities into the staircase parity chain.
    """

    kind = "table"

    def __init__(self, n: int, k: int, q: int, m: int, lines: list[list[int]]):
        super().__init__()
        self.n, self.k, self.q, self.m = n, k, q, m
        self.lines = [np.asarray(l, dtype=np.int64) for l in lines]
        if len(self.lines) * m != k:
            raise ValueError("table does not cover K info bits")
        # per info bit x, its parity positions, then grouped by parity row
        with span("encoder.build") as sp:
            pos_list, bit_list = [], []
            nmk = n - k
            for g, line in enumerate(self.lines):
                for x_in_g in range(m):
                    x = g * m + x_in_g
                    p = (line + (x % m) * q) % nmk
                    pos_list.append(p)
                    bit_list.append(np.full(p.size, x, dtype=np.int64))
            self._row_ptr, self._cols = parity_table(
                np.concatenate(pos_list), np.concatenate(bit_list), nmk, k)
            sp.count = self._cols.size

    @staticmethod
    def from_json(path: str) -> "QCAccumulateEncoder":
        with open(path) as f:
            doc = json.load(f)
        return QCAccumulateEncoder(
            doc["N"], doc["K"], doc["Q"], doc["M"], doc["rows"]
        )


def _check_rows_in_parity_order(code: LdpcCode) -> Optional[list]:
    """Recover original staircase row order from parity-column membership.

    In a dual-diagonal (staircase) code, original check row ``i`` contains
    parity VNs {K+i-1, K+i} (row 0: just {K}).  Degree-class sorting loses
    row order; this maps each check back, returning for each original row
    the index arrays of its *info* VNs, or None if the code isn't staircase.
    """
    K, M = code.K, code.n_checks
    rows_info: list[Optional[np.ndarray]] = [None] * M
    for ci in code.class_idx:
        for c in range(ci.shape[0]):
            vns = ci[c]
            par = np.sort(vns[vns >= K]) - K
            info = vns[vns < K]
            if par.size == 1 and par[0] == 0:
                row = 0
            elif par.size == 2 and par[1] == par[0] + 1:
                row = int(par[1])
            else:
                return None
            if rows_info[row] is not None:
                return None
            rows_info[row] = info
    if any(r is None for r in rows_info):
        return None
    return rows_info


class StaircaseEncoder(_AccumulateEncoder):
    """Encoder derived from H itself for dual-diagonal parity codes.

    Parity ``p_i`` satisfies ``p_i = p_{i-1} ^ XOR(info VNs of row i)``, a
    cumulative XOR of per-row info sums, exactly what ``GenericEncoder``'s
    final running XOR computes (``GenericEncoder.cpp:74-77``).
    """

    kind = "staircase"

    def __init__(self, code: LdpcCode):
        super().__init__()
        rows_info = _check_rows_in_parity_order(code)
        if rows_info is None:
            raise ValueError(f"{code.name}: parity part is not staircase")
        self.n, self.k = code.N, code.K
        lens = np.asarray([r.size for r in rows_info])
        self._row_ptr, self._cols = parity_table(
            np.repeat(np.arange(len(rows_info)), lens),
            np.concatenate(rows_info), len(rows_info), self.k)


class GF2Encoder(Encoder):
    """Generic encoder by one-time GF(2) Gauss-Jordan with column pivoting.

    Reduces H so that a chosen set of M pivot columns forms the identity;
    the remaining K columns carry the info bits and the pivots solve as
    ``c_pivot = S @ c_info``.  Pivots prefer high column indices, so for
    codes whose last-M block is invertible the mapping is the classic
    systematic [info | parity] split; otherwise info bits land at the
    computed ``info_cols``.  Intended for small and medium codes (M up to a
    few thousand); staircase codes should use `StaircaseEncoder`.
    """

    kind = "gf2"

    def __init__(self, code: LdpcCode, max_m: int = 4096):
        super().__init__()
        M, N, K = code.n_checks, code.N, code.K
        if M > max_m:
            raise ValueError(
                f"{code.name}: M={M} too large for dense GF2 elimination"
            )
        H = np.zeros((M, N), dtype=bool)
        c0 = 0
        for ci in code.class_idx:
            for c in range(ci.shape[0]):
                H[c0 + c, ci[c]] = True
            c0 += ci.shape[0]
        pivot_of_row: list[int] = []
        pivot_rows: list[int] = []
        is_pivot = np.zeros(N, dtype=bool)
        for r in range(M):
            cand = np.nonzero(H[r] & ~is_pivot)[0]
            if cand.size == 0:
                # a linearly dependent check (rank-deficient H, e.g. the
                # 2048x384 matrix): satisfied by construction
                if H[r].any():
                    raise AssertionError("inconsistent elimination state")
                continue
            p = int(cand[-1])  # prefer high indices (systematic when possible)
            is_pivot[p] = True
            pivot_of_row.append(p)
            pivot_rows.append(r)
            rows = H[:, p].copy()
            rows[r] = False
            H[rows] ^= H[r]
        self.n, self.k = N, K
        free_cols = np.nonzero(~is_pivot)[0]
        # rank deficiency leaves more than K free columns; the info bits
        # ride the first K and the surplus is pinned to zero
        self.info_cols = free_cols[:K]
        self.zero_cols = free_cols[K:]
        self.pivot_cols = np.asarray(pivot_of_row)
        self._S = H[np.asarray(pivot_rows)][:, self.info_cols]

    def _encode(self, info_bits: torch.Tensor) -> torch.Tensor:
        self._check(info_bits)
        dev = info_bits.device
        s_t, info_cols, pivot_cols = self._on(
            dev, self._S.T.astype(np.float64), self.info_cols,
            self.pivot_cols)
        u = info_bits.to(torch.int8)
        piv = (u.to(torch.float64) @ s_t).to(torch.int64) & 1
        out = torch.zeros((u.shape[0], self.n), dtype=torch.int8, device=dev)
        out[:, info_cols] = u
        out[:, pivot_cols] = piv.to(torch.int8)
        return out  # zero_cols stay 0


def make_encoder(code: LdpcCode, kind: str = "auto") -> Encoder:
    """Factory (EncoderLibrary equivalent): fake | table | staircase | gf2 |
    auto.

    ``auto`` picks: the registry's accumulate table
    (``codes/data/encoder_<N>x<K>.json``) if present, else staircase if H
    is dual-diagonal, else dense GF(2), else fake.
    """
    if kind == "fake":
        return FakeEncoder(code.N, code.K)
    table = os.path.join(DATA_DIR, f"encoder_{code.N}x{code.K}.json")
    if kind == "table" or (kind == "auto" and os.path.exists(table)):
        return QCAccumulateEncoder.from_json(table)
    if kind in ("staircase", "auto"):
        try:
            return StaircaseEncoder(code)
        except ValueError:
            if kind == "staircase":
                raise
    if kind in ("gf2", "auto"):
        try:
            return GF2Encoder(code)
        except ValueError:
            if kind == "gf2":
                raise
    if kind == "auto":
        return FakeEncoder(code.N, code.K)
    raise ValueError(f"unknown encoder kind {kind!r}")

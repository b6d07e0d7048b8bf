"""The accumulate encoders' arithmetic (the table and staircase encoders of
``channel/encoder.py``) in one kernel of ``csrc/encoder.cu``:
``accumulate_encode``, info bits [B, K] to codewords [B, N], from the
encoder's parity table in CSR form (``parity_table``).

It replaces no TPU kernel: the JAX package encodes with NumPy on the host
(``REPLACES`` is None).  The wrapper runs its plain PyTorch version on a
CPU tensor and launches the kernel, or raises, on a CUDA tensor, on
PyTorch's current stream with no host synchronisation (a CUDA graph
captures it); ``launches["accumulate_encode"]`` counts the launches.  The
library is compiled at first use (``kernels/_lib.py``); importing this
module needs neither nvcc nor CUDA.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from . import _lib

__all__ = ["accumulate_encode", "accumulate_plain", "parity_table",
           "launches", "build", "SOURCE", "REPLACES"]

SOURCE = os.path.join(_lib.CSRC, "encoder.cu")
REPLACES = None  # the JAX package encodes with NumPy on the host

# Kernel launches in this process: the wrapper adds one where it launches
# the kernel, and nowhere else.
launches = {"accumulate_encode": 0}

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# the library's C functions: (argtypes, restype)
_FUNCTIONS = {
    "accumulate_encode_launch": ([_P, _P, _P, _P, _I, _LL, _I, _I, _I, _P], _I),
    "encoder_error_string": ([_I], ctypes.c_char_p),
}


def build() -> dict:
    """Compile the library if this source has not been built yet;
    ``{"path", "seconds", "log"}`` (see ``_lib.build_library``)."""
    return _lib.build_library(SOURCE, _lib.BUILD_DIR)


def parity_table(rows: np.ndarray, cols: np.ndarray, m: int,
                 k: int) -> tuple[np.ndarray, np.ndarray]:
    """The pairs (parity row ``rows[e]``, info bit ``cols[e]``) of an
    accumulate encoder of ``m`` parity and ``k`` info bits, grouped by
    parity row: ``(row_ptr, cols)``, row j's info bits
    ``cols[row_ptr[j]:row_ptr[j + 1]]`` in the pairs' order.  ``row_ptr``
    is int32 [m + 1], ``cols`` int16 where k < 32768, else int32."""
    rows, cols = np.asarray(rows), np.asarray(cols)
    if rows.ndim != 1 or rows.shape != cols.shape:
        raise ValueError("rows and cols must be 1-D and of one length")
    if rows.size and (rows.min() < 0 or rows.max() >= m or cols.min() < 0
                      or cols.max() >= k):
        raise ValueError(f"a pair outside the {m} rows and {k} info bits")
    row_ptr = np.zeros(m + 1, np.int32)
    np.cumsum(np.bincount(rows, minlength=m), out=row_ptr[1:])
    order = np.argsort(rows, kind="stable")
    return row_ptr, cols[order].astype(np.int16 if k < 32768 else np.int32)


def accumulate_plain(u: torch.Tensor, row_ptr: torch.Tensor,
                     cols: torch.Tensor, n: int) -> torch.Tensor:
    """The accumulate form in PyTorch: parity sum j += ``u[:, c]`` for
    every info bit c of row j (an ``index_add_`` of the gathered bits into
    int32 sums), then the staircase chain p_j ^= p_{j-1} (a running sum
    taken mod 2); returns the codeword [B, n] int8, ``u`` then the
    parity."""
    m = row_ptr.numel() - 1
    rows = torch.repeat_interleave(
        torch.arange(m, device=u.device), row_ptr.diff(),
        output_size=cols.numel())
    s = torch.zeros((u.shape[0], m), dtype=torch.int32, device=u.device)
    s.index_add_(1, rows, u[:, cols.long()].to(torch.int32))
    par = (s.cumsum(1) & 1).to(torch.int8)
    return torch.cat([u, par], dim=1)


def accumulate_encode(u: torch.Tensor, row_ptr: torch.Tensor,
                      cols: torch.Tensor, n: int) -> torch.Tensor:
    """The codewords [B, n] int8 of the info bits ``u`` (int8 [B, K],
    contiguous; a bit is the low bit of its byte, and the systematic part
    copies the bytes) under the parity table (``row_ptr`` int32 [n - K +
    1], ``cols`` int16 or int32, on ``u``'s device: ``parity_table``).
    On the card the kernel, whose C entry refuses (``RuntimeError``) info
    bytes and a table that do not fit a CTA's shared memory."""
    if not isinstance(u, torch.Tensor) or u.dtype != torch.int8:
        raise TypeError("u must be an int8 torch tensor")
    if u.dim() != 2 or not 0 < u.shape[1] < n:
        raise ValueError(f"u must be [B, K < {n}], got {tuple(u.shape)}")
    if not u.is_contiguous():
        raise ValueError("u must be contiguous")
    if u.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {u.device}")
    k = u.shape[1]
    for t, name, types in ((row_ptr, "row_ptr", (torch.int32,)),
                           (cols, "cols", (torch.int16, torch.int32))):
        if (not isinstance(t, torch.Tensor) or t.dtype not in types
                or t.dim() != 1 or not t.is_contiguous()
                or t.device != u.device):
            raise TypeError(f"{name} must be a contiguous 1-D tensor of "
                            f"{' or '.join(map(str, types))} on u's device")
    if row_ptr.numel() != n - k + 1:
        raise ValueError(f"row_ptr must hold {n - k + 1} offsets, got "
                         f"{row_ptr.numel()}")
    if u.device.type == "cpu":
        return accumulate_plain(u, row_ptr, cols, n)
    out = torch.empty((u.shape[0], n), dtype=torch.int8, device=u.device)
    if not u.shape[0]:
        return out
    lib = _lib.load(SOURCE, _FUNCTIONS)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        err = lib.accumulate_encode_launch(
            u.data_ptr(), out.data_ptr(), row_ptr.data_ptr(),
            cols.data_ptr(), cols.element_size(), u.shape[0], k, n,
            cols.numel(), stream)
    if err != 0:
        msg = lib.encoder_error_string(err).decode()
        raise RuntimeError(f"accumulate_encode launch failed: {msg} ({err})")
    launches["accumulate_encode"] += 1
    return out

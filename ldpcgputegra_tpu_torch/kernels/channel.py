"""The passes around the decoder in a simulation batch, each one kernel of
``csrc/channel_count.cu``: ``awgn_quantize`` (the AWGN channel and the LLR
quantizer of the all-zero codeword, from the caller's standard normal
draws) and ``count_errors`` (the bit and frame errors of decoded frames
against the all-zero codeword).

They replace no TPU kernel: the JAX package left this chain to XLA's
fusion (``REPLACES`` is None).  ``channel/awgn.py::AwgnChannel.
generate_zero_int8`` and ``sim/analyzer.py::count_errors_async`` take them
on a CUDA device where the plain chain computes the same bytes (see there).

Each wrapper runs its plain PyTorch version on a CPU tensor and launches
its kernel, or raises, on a CUDA tensor, on PyTorch's current stream with
no host synchronisation (a CUDA graph captures it); ``launches`` counts the
kernel launches by name.  The library is compiled at first use
(``kernels/_lib.py``); importing this module needs neither nvcc nor CUDA.
"""

from __future__ import annotations

import ctypes
import os

import torch

from . import _lib

__all__ = ["awgn_quantize", "awgn_quantize_plain", "count_errors",
           "count_errors_plain", "launches", "build", "SOURCE", "REPLACES"]

SOURCE = os.path.join(_lib.CSRC, "channel_count.cu")
REPLACES = None  # the JAX package's channel and count are plain jax.numpy

# Kernel launches in this process, by kernel name: a wrapper adds one where
# it launches its kernel, and nowhere else.
launches = {"awgn_quantize": 0, "count_errors": 0}

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# the library's C functions: (argtypes, restype)
_FUNCTIONS = {
    "awgn_quantize_launch": ([_P, _P, _LL, _P, _F, _F, _P], _I),
    "count_errors_launch": ([_P, _LL, _LL, _LL, _P, _P], _I),
    "channel_count_error_string": ([_I], ctypes.c_char_p),
}

def build() -> dict:
    """Compile the library if this source has not been built yet;
    ``{"path", "seconds", "log"}`` (see ``_lib.build_library``)."""
    return _lib.build_library(SOURCE, _lib.BUILD_DIR)


def _launch(name: str, dev: torch.device, *args) -> None:
    lib = _lib.load(SOURCE, _FUNCTIONS)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, f"{name}_launch")(*args, stream)
    if err != 0:
        msg = lib.channel_count_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: {msg} ({err})")
    launches[name] += 1


def _check_device(t: torch.Tensor) -> None:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {t.device}")


def _byte_rows(decoded: torch.Tensor) -> tuple[torch.Tensor, int]:
    """``decoded`` (2-D, one byte an element) as uint8 rows of unit column
    stride, and the bytes from one row's start to the next's: a view where
    its rows lie apart in memory (``decoded[:, :k]``), else a contiguous
    copy."""
    if decoded.dtype != torch.uint8:
        decoded = decoded.view(torch.uint8)
    rows, cols = decoded.shape
    if ((cols > 1 and decoded.stride(1) != 1)
            or (rows > 1 and decoded.stride(0) < cols)):
        decoded = decoded.contiguous()
    return decoded, decoded.stride(0) if rows > 1 else cols


# ---------------------------------------------------------------- plain --

def awgn_quantize_plain(noise: torch.Tensor, amp: float,
                        scalars: torch.Tensor, sat: int) -> torch.Tensor:
    """The channel and quantizer in PyTorch, as ``channel/awgn.py``'s
    chain computes them for the all-zero codeword: the symbol -amp in
    float32, plus ``sigma * noise``, times ``factor``, clamped to ±sat,
    truncated toward zero to int8 (sigma and factor: ``scalars[0]``,
    ``scalars[1]``)."""
    symbols = torch.full_like(noise, -amp)
    y = symbols + scalars[0] * noise
    return (y * scalars[1]).clamp(-float(sat), float(sat)).to(torch.int8)


def count_errors_plain(decoded: torch.Tensor, cols: int) -> torch.Tensor:
    """(BE, FE) in PyTorch, int64 ``[2]``: the nonzero bytes of each row's
    first ``cols`` columns, summed, and the rows with any."""
    per_frame = (decoded[:, :cols] != 0).sum(dim=1)
    return torch.stack([per_frame.sum(), (per_frame != 0).sum()])


# -------------------------------------------------------------- kernels --

def awgn_quantize(noise: torch.Tensor, amp: float, scalars: torch.Tensor,
                  sat: int) -> torch.Tensor:
    """int8 LLRs of the all-zero codeword, the shape of ``noise`` (float32
    standard normal draws), through the channel of noise scale
    ``scalars[0]`` and amplitude ``amp`` and the quantizer of scale
    ``scalars[1]`` and saturation ``sat``: ``scalars`` is a float32 tensor
    on the noise's device, read by the kernel when it runs.  On the card
    ``noise`` must start on a 16-byte boundary."""
    if not isinstance(noise, torch.Tensor) or noise.dtype != torch.float32:
        raise TypeError("noise must be a float32 torch tensor")
    if (not isinstance(scalars, torch.Tensor)
            or scalars.dtype != torch.float32 or scalars.numel() < 2
            or scalars.device != noise.device
            or not scalars.is_contiguous()):
        raise TypeError("scalars must be a contiguous float32 tensor with "
                        "sigma and the factor, on the noise's device")
    _check_device(noise)
    if noise.device.type == "cpu":
        return awgn_quantize_plain(noise, amp, scalars, sat)
    if not noise.is_contiguous():
        raise ValueError("noise must be contiguous")
    if noise.data_ptr() % 16:
        raise ValueError("noise must start on a 16-byte boundary")
    llr = torch.empty(noise.shape, dtype=torch.int8, device=noise.device)
    if noise.numel():
        _launch("awgn_quantize", noise.device, noise.data_ptr(),
                llr.data_ptr(), noise.numel(),
                scalars.data_ptr(), amp, float(sat))
    return llr


def count_errors(decoded: torch.Tensor, cols: int) -> torch.Tensor:
    """(BE, FE) of decoded frames ``[B, N]`` (uint8, int8 or bool, one
    byte a bit) against the all-zero codeword, over each frame's first
    ``cols`` columns: int64 ``[2]``, on the frames' device, not fetched.
    On the card the kernel reads rows that lie apart in memory where they
    are (a view such as ``decoded[:, :k]``) and any other layout from a
    contiguous copy."""
    if (not isinstance(decoded, torch.Tensor)
            or decoded.dtype not in (torch.uint8, torch.int8, torch.bool)):
        raise TypeError("decoded must be a uint8, int8 or bool torch tensor")
    if decoded.dim() != 2 or not 0 <= cols <= decoded.shape[1]:
        raise ValueError(f"decoded must be [B, N >= {cols}], got "
                         f"{tuple(decoded.shape)}")
    _check_device(decoded)
    if decoded.device.type == "cpu":
        return count_errors_plain(decoded, cols)
    out = torch.empty(2, dtype=torch.int64, device=decoded.device)
    if decoded.shape[0] == 0:
        return out.zero_()
    rows, stride = _byte_rows(decoded)
    _launch("count_errors", decoded.device, rows.data_ptr(), rows.shape[0],
            stride, cols, out.data_ptr())
    return out

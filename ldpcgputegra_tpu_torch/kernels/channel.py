"""The passes around the decoder in a simulation batch, each one kernel of
``csrc/channel_count.cu``: ``awgn_quantize`` (the AWGN channel and the LLR
quantizer, from the caller's standard normal draws, of the all-zero
codeword or, given them, of coded bits) and ``count_errors`` (the bit and
frame errors of decoded frames against the all-zero codeword or, given
them, against the frames sent).

They replace no TPU kernel: the JAX package left this chain to XLA's
fusion (``REPLACES`` is None).  ``channel/awgn.py::AwgnChannel.
generate_zero_int8`` and ``generate_int8`` and ``sim/analyzer.py::
count_errors_async`` take them on a CUDA device where the plain chain
computes the same bytes (see there).

Each wrapper runs its plain PyTorch version on a CPU tensor and launches
its kernel, or raises, on a CUDA tensor, on PyTorch's current stream with
no host synchronisation (a CUDA graph captures it); ``launches`` counts the
kernel launches by form: ``awgn_quantize`` and ``count_errors`` the
all-zero forms, ``awgn_quantize_coded`` and ``count_errors_ref`` those of
coded bits and of a reference.  The library is compiled at first use
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

# Kernel launches in this process, by form (see above): a wrapper adds one
# where it launches its kernel, and nowhere else.
launches = {"awgn_quantize": 0, "count_errors": 0, "awgn_quantize_coded": 0,
            "count_errors_ref": 0}

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# the library's C functions: (argtypes, restype)
_FUNCTIONS = {
    "awgn_quantize_launch": ([_P, _P, _LL, _P, _F, _F, _P], _I),
    "awgn_quantize_coded_launch": ([_P, _P, _P, _LL, _P, _F, _F, _P], _I),
    "count_errors_launch": ([_P, _LL, _LL, _LL, _P, _P], _I),
    "count_errors_ref_launch": ([_P, _P, _LL, _LL, _LL, _LL, _P, _P], _I),
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


def _byte_row_pair(decoded: torch.Tensor, reference: torch.Tensor,
                   cols: int) -> tuple:
    """``_byte_rows`` of the frames and of the reference, each row of the
    reference at the same offset from a 16-byte boundary as the frame's
    row; where they are not, fresh contiguous copies of the first ``cols``
    columns of both (each starts on a boundary and has the same stride).
    ``(rows, stride, ref_rows, ref_stride)``."""
    rows, stride = _byte_rows(decoded)
    ref, ref_stride = _byte_rows(reference)
    if ((rows.data_ptr() - ref.data_ptr()) % 16
            or (rows.shape[0] > 1 and (stride - ref_stride) % 16)):
        rows = rows[:, :cols].clone(memory_format=torch.contiguous_format)
        ref = ref[:, :cols].clone(memory_format=torch.contiguous_format)
        stride = ref_stride = cols
    return rows, stride, ref, ref_stride


def _one_byte_bits(bits: torch.Tensor, shape) -> torch.Tensor:
    """Coded bits as a contiguous uint8 tensor of ``shape`` (nonzero for a
    1) that starts on a 16-byte boundary: a view where they are one, else
    a copy."""
    if tuple(bits.shape) != tuple(shape):
        raise ValueError(f"bits must have the noise's shape {tuple(shape)}, "
                         f"got {tuple(bits.shape)}")
    if bits.dtype not in (torch.uint8, torch.int8, torch.bool):
        bits = bits != 0
    if not bits.is_contiguous() or bits.data_ptr() % 16:
        bits = bits.clone(memory_format=torch.contiguous_format)
    return bits.view(torch.uint8)


# ---------------------------------------------------------------- plain --

def awgn_quantize_plain(noise: torch.Tensor, amp: float,
                        scalars: torch.Tensor, sat: int,
                        bits: torch.Tensor | None = None) -> torch.Tensor:
    """The channel and quantizer in PyTorch, as ``channel/awgn.py``'s
    chain computes them: the symbol in float32 (-amp for the all-zero
    codeword; with ``bits``, +amp where a bit is nonzero), plus
    ``sigma * noise``, times ``factor``, clamped to ±sat, truncated toward
    zero to int8 (sigma and factor: ``scalars[0]``, ``scalars[1]``)."""
    if bits is None:
        symbols = torch.full_like(noise, -amp)
    else:
        symbols = torch.where(bits != 0, amp, -amp).to(torch.float32)
    y = symbols + scalars[0] * noise
    return (y * scalars[1]).clamp(-float(sat), float(sat)).to(torch.int8)


def count_errors_plain(decoded: torch.Tensor, cols: int,
                       reference: torch.Tensor | None = None) -> torch.Tensor:
    """(BE, FE) in PyTorch, int64 ``[2]``: the bytes of each row's first
    ``cols`` columns that are nonzero (with ``reference``: that differ from
    the reference's), summed, and the rows with any."""
    d = decoded[:, :cols]
    err = d != 0 if reference is None else d != reference[:, :cols]
    per_frame = err.sum(dim=1)
    return torch.stack([per_frame.sum(), (per_frame != 0).sum()])


# -------------------------------------------------------------- kernels --

def awgn_quantize(noise: torch.Tensor, amp: float, scalars: torch.Tensor,
                  sat: int, bits: torch.Tensor | None = None) -> torch.Tensor:
    """int8 LLRs, the shape of ``noise`` (float32 standard normal draws),
    of the all-zero codeword or, given ``bits`` (the coded bits, the
    noise's shape, nonzero for a 1), of those bits, through the channel of
    noise scale ``scalars[0]`` and amplitude ``amp`` and the quantizer of
    scale ``scalars[1]`` and saturation ``sat``: ``scalars`` is a float32
    tensor on the noise's device, read by the kernel when it runs.  On the
    card ``noise`` must start on a 16-byte boundary; ``bits`` of another
    type than one byte, or in another layout, are copied first."""
    if not isinstance(noise, torch.Tensor) or noise.dtype != torch.float32:
        raise TypeError("noise must be a float32 torch tensor")
    if (not isinstance(scalars, torch.Tensor)
            or scalars.dtype != torch.float32 or scalars.numel() < 2
            or scalars.device != noise.device
            or not scalars.is_contiguous()):
        raise TypeError("scalars must be a contiguous float32 tensor with "
                        "sigma and the factor, on the noise's device")
    if bits is not None and (not isinstance(bits, torch.Tensor)
                             or bits.device != noise.device):
        raise TypeError("bits must be a torch tensor on the noise's device")
    _check_device(noise)
    if noise.device.type == "cpu":
        return awgn_quantize_plain(noise, amp, scalars, sat, bits)
    if not noise.is_contiguous():
        raise ValueError("noise must be contiguous")
    if noise.data_ptr() % 16:
        raise ValueError("noise must start on a 16-byte boundary")
    if bits is not None:
        bits = _one_byte_bits(bits, noise.shape)
    llr = torch.empty(noise.shape, dtype=torch.int8, device=noise.device)
    if not noise.numel():
        return llr
    if bits is None:
        _launch("awgn_quantize", noise.device, noise.data_ptr(),
                llr.data_ptr(), noise.numel(), scalars.data_ptr(), amp,
                float(sat))
    else:
        _launch("awgn_quantize_coded", noise.device, noise.data_ptr(),
                bits.data_ptr(), llr.data_ptr(), noise.numel(),
                scalars.data_ptr(), amp, float(sat))
    return llr


def count_errors(decoded: torch.Tensor, cols: int,
                 reference: torch.Tensor | None = None) -> torch.Tensor:
    """(BE, FE) of decoded frames ``[B, N]`` (uint8, int8 or bool, one
    byte a bit) against the all-zero codeword or, given it, against
    ``reference`` (the frames sent: the same shape and type), over each
    frame's first ``cols`` columns: int64 ``[2]``, on the frames' device,
    not fetched.  On the card the kernel reads rows that lie apart in
    memory where they are (a view such as ``decoded[:, :k]``) and any
    other layout from a contiguous copy."""
    if (not isinstance(decoded, torch.Tensor)
            or decoded.dtype not in (torch.uint8, torch.int8, torch.bool)):
        raise TypeError("decoded must be a uint8, int8 or bool torch tensor")
    if decoded.dim() != 2 or not 0 <= cols <= decoded.shape[1]:
        raise ValueError(f"decoded must be [B, N >= {cols}], got "
                         f"{tuple(decoded.shape)}")
    if reference is not None and (
            not isinstance(reference, torch.Tensor)
            or reference.dtype != decoded.dtype
            or reference.shape != decoded.shape
            or reference.device != decoded.device):
        raise TypeError("reference must be a tensor of the decoded frames' "
                        "type, shape and device")
    _check_device(decoded)
    if decoded.device.type == "cpu":
        return count_errors_plain(decoded, cols, reference)
    out = torch.empty(2, dtype=torch.int64, device=decoded.device)
    if decoded.shape[0] == 0:
        return out.zero_()
    if reference is None:
        rows, stride = _byte_rows(decoded)
        _launch("count_errors", decoded.device, rows.data_ptr(),
                rows.shape[0], stride, cols, out.data_ptr())
        return out
    rows, stride, ref, ref_stride = _byte_row_pair(decoded, reference, cols)
    _launch("count_errors_ref", decoded.device, rows.data_ptr(),
            ref.data_ptr(), rows.shape[0], stride, ref_stride, cols,
            out.data_ptr())
    return out

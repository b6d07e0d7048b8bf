"""Wrapper of the hand-written CUDA layered min-sum kernel
(``csrc/layered_minsum.cu``).

Replaces ``ldpcgputegra_tpu/kernels/pallas_layered.py::_build_kernel``
(launched there by ``make_pallas_decoder``): one launch runs the whole
layered decode of a QC code, all iterations and all block-rows.

What bounds it on the card: every edge of every codeword costs one int8
message read and one int8 message write in device memory per iteration
(2 bytes per edge per iteration; 60 MB of messages at 2304x1152, B=8192,
more than the 50 MB L2).  The design keeps the other half of the traffic,
the APP reads and writes, in shared memory: a CTA holds its tile of 32
codewords' APP array there ([N][32] int8), and lays the messages out
codeword-fastest so that a warp moves 32 contiguous bytes per edge.

The kernel is compiled at first use (``kernels/_lib.py``), from this
checkout's sources only, and loaded with ctypes.  Importing this module
needs neither nvcc nor CUDA.

On a CPU tensor the decoder runs the plain version
(``ops/layered.py::make_layered_decoder``); on a CUDA tensor it launches
the kernel or raises.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import torch

from ..codes.code import LdpcCode
from ..codes.convert import qc_tables
from ..codes.schedule import build_layers
from ..ops.layered import (
    LayeredSpec,
    is_qc_view,
    make_layered_decoder,
    unsupported_reason,
)
from . import _lib

__all__ = ["make_cuda_decoder", "cuda_supported", "build", "launches",
           "SOURCE", "REPLACES"]

SOURCE = os.path.join(_lib.CSRC, "layered_minsum.cu")
BUILD_DIR = _lib.BUILD_DIR
REPLACES = "ldpcgputegra_tpu/kernels/pallas_layered.py:139"  # _build_kernel

# mirrored from csrc/layered_minsum.cu
_TB = 32
_MAX_DEG = 32

# Kernel launches in this process, by kernel name: the decoder adds one
# where it launches the kernel, and nowhere else.
launches = {"layered_minsum": 0}

_lib_handle: Optional[ctypes.CDLL] = None


def _smem_bytes(code: LdpcCode) -> int:
    n_edges = sum(lay.deg for lay in code.layers)
    app = (code.N * _TB + 15) & ~15
    return app + 4 * (2 * n_edges + len(code.layers) + 1 + _TB)


def build() -> dict:
    """Compile the kernel library if this source has not been built yet;
    ``{"path", "seconds", "log"}`` (see ``_lib.build_library``)."""
    return _lib.build_library(SOURCE, BUILD_DIR)


def _library() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is None:
        lib = ctypes.CDLL(build()["path"])
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.layered_minsum_launch.argtypes = [p] * 7 + [i] * 14 + [p]
        lib.layered_minsum_launch.restype = i
        lib.layered_minsum_error_string.argtypes = [i]
        lib.layered_minsum_error_string.restype = ctypes.c_char_p
        _lib_handle = lib
    return _lib_handle


def kernel_unsupported_reason(code: LdpcCode, spec: LayeredSpec):
    """Why the CUDA kernel cannot take this code yet; None when it can."""
    why = unsupported_reason(code, spec)
    if why is not None:
        return why
    if is_qc_view(code):
        return (f"{code.name}: a QC view (col_perm, deficient circulants, "
                "sub-pass layers); no staircase view fits a 32-codeword APP "
                "tile, so this kernel leaves them to the streamed kernel "
                "(kernels/streamed.py)")
    # the kernel's tables are code.layers: it takes a schedule only where
    # that gives the same QC block-rows
    if not code.is_qc or any(
            lay.qc is None for lay in build_layers(code, spec.schedule)):
        return (f"{code.name}: the {spec.schedule} schedule gives non-QC "
                "layers, which this kernel does not walk (the gather kernel, "
                "kernels/gather.py, does)")
    if max(lay.deg for lay in code.layers) > _MAX_DEG:
        return f"{code.name}: check degree above {_MAX_DEG}"
    if _smem_bytes(code) > _lib.SMEM_MAX:
        return (f"{code.name}: a 32-codeword APP tile ({_smem_bytes(code)} B) "
                "does not fit shared memory (the streamed kernel, "
                "kernels/streamed.py, keeps the APP in device memory)")
    return None


def cuda_supported(code: LdpcCode, spec: LayeredSpec) -> bool:
    """True when the CUDA kernel takes this code and spec."""
    return kernel_unsupported_reason(code, spec) is None


def make_cuda_decoder(code: LdpcCode, spec: LayeredSpec = LayeredSpec()):
    """Build ``decode(llr[B, N] int8) -> (bits[B, N] uint8, iters_used)``.

    On a CUDA tensor it launches the kernel on PyTorch's current stream,
    with no host synchronisation; ``iters_used`` is a 0-d int32 tensor on
    the card.  On a CPU tensor it runs the plain version.
    """
    if spec.algo not in _lib.ALGO:
        raise ValueError(f"unknown algo {spec.algo!r}")
    why = kernel_unsupported_reason(code, spec)
    if why is not None:
        raise NotImplementedError(why)
    n_slots = sum(lay.deg * lay.n_checks for lay in code.layers)
    tables: dict[torch.device, dict] = {}  # copied on the first call per card
    plain = make_layered_decoder(code, spec, "cpu")

    def decode(llr: torch.Tensor):
        _lib.check_llr(llr, code.N)
        if llr.device.type == "cpu":
            return plain(llr)
        lib = _library()
        dev = llr.device
        if dev not in tables:
            tables[dev] = qc_tables(code, dev)
        t = tables[dev]
        B = llr.shape[0]
        bits = torch.empty((B, code.N), dtype=torch.uint8, device=dev)
        msgs = torch.empty((n_slots, B), dtype=torch.int8, device=dev)
        iters = torch.empty((), dtype=torch.int32, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.layered_minsum_launch(
                llr.data_ptr(), bits.data_ptr(), msgs.data_ptr(),
                iters.data_ptr(), t["row_ptr"].data_ptr(),
                t["cols"].data_ptr(), t["shifts"].data_ptr(),
                len(code.layers), int(t["cols"].numel()), code.N, code.Z, B,
                _lib.ALGO[spec.algo], int(spec.minclamp == "pre"), spec.iters,
                int(spec.early_term), spec.offset, spec.nms_f, spec.nms_f2,
                spec.sat_var, spec.sat_msg, stream,
            )
        if err != 0:
            msg = lib.layered_minsum_error_string(err).decode()
            raise RuntimeError(f"layered_minsum launch failed: {msg} ({err})")
        launches["layered_minsum"] += 1
        return bits, iters

    return decode

"""Wrapper of the hand-written CUDA streamed min-sum kernel
(``csrc/streamed_minsum.cu``): layered min-sum of codes whose APP array
does not fit shared memory, the decode path of the DVB-S2 family (the
Z=360 QC views of the staircase codes) and of synthqc-256x128x6-z1024.

Replaces ``ldpcgputegra_tpu/kernels/pallas_streamed.py::
_build_streamed_kernel`` (K2, ``REPLACES``): one launch runs the whole
decode.  K2 keeps the APP on chip and streams the messages; on the card
neither fits a block's shared memory at these sizes, so the APP and the
messages are scratch buffers in device memory that this wrapper allocates
(``[ceil(B / tile)][N][tile]`` and ``[ceil(B / tile)][E][tile]`` int8).

What bounds it on the card: the latency of each check lane's APP and
message accesses in device memory, mostly served by the L2 (``PERF.md``
§6); ``pick_tile`` picks the codewords per CTA for check lanes and CTAs in
flight.

The kernel is compiled at first use (``kernels/_lib.py``) and loaded with
ctypes.  Importing this module needs neither nvcc nor CUDA.  On a CPU
tensor the decoder runs the plain version
(``ops/layered.py::make_layered_decoder``); on a CUDA tensor it launches
the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Optional

import torch

from ..codes.code import LdpcCode
from ..codes.convert import edge_tables
from ..ops.layered import LayeredSpec, make_layered_decoder, unsupported_reason
from . import _lib

__all__ = ["make_streamed_decoder", "kernel_unsupported_reason", "pick_tile",
           "build", "launches", "SOURCE", "REPLACES"]

SOURCE = os.path.join(_lib.CSRC, "streamed_minsum.cu")
BUILD_DIR = _lib.BUILD_DIR
REPLACES = "ldpcgputegra_tpu/kernels/pallas_streamed.py:73"  # _build_streamed_kernel

# mirrored from csrc/streamed_minsum.cu
NTHREADS = 512  # threads per CTA
TILES = (32, 16, 8, 4, 2, 1)  # codewords per CTA
DMAXES = (8, 16, 32)  # unrolled contribution array lengths
SMS_H100 = 132  # an H100 SXM's SMs: pick_tile's count where no card is read

# Kernel launches in this process: the decoder adds one where it launches
# the kernel, and nowhere else.
launches = {"streamed_minsum": 0}

_lib_handle: Optional[ctypes.CDLL] = None


def pick_tile(code: LdpcCode, B: int, sms: int = SMS_H100) -> int:
    """Codewords per CTA for a batch of ``B`` on a card of ``sms`` SMs: the
    narrowest tile whose CTAs all fit the card at once, else the widest.

    Each lane walks its checks of a layer one after the other and waits
    on device memory for each, so more lanes (512 / tile) win until the
    CTAs no longer fit: two on each SM at DMAX = 8 (64 registers a
    thread), one at DMAX = 16 and 32 (``csrc/streamed_minsum.cu``'s launch
    bounds).  The tile against ms on the H100 is ``PERF.md`` §6's table,
    from ``bench/tiles.py``."""
    ctas = sms * (2 if _dmax(code) == 8 else 1)
    return next((t for t in reversed(TILES) if -(-B // t) <= ctas), TILES[0])


def _dmax(code: LdpcCode) -> int:
    """The smallest unrolled contribution array that holds every check
    degree; 0 when none does."""
    deg = max(lay.deg for lay in code.layers)
    return next((d for d in DMAXES if d >= deg), 0)


def build() -> dict:
    """Compile the kernel library if this source has not been built yet;
    ``{"path", "seconds", "log"}`` (see ``_lib.build_library``)."""
    return _lib.build_library(SOURCE, BUILD_DIR)


def _library() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is None:
        lib = ctypes.CDLL(build()["path"])
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.streamed_minsum_launch.argtypes = (
            [p] * 10 + [i, ctypes.c_longlong] + [i] * 13 + [p])
        lib.streamed_minsum_launch.restype = i
        lib.streamed_minsum_error_string.argtypes = [i]
        lib.streamed_minsum_error_string.restype = ctypes.c_char_p
        _lib_handle = lib
    return _lib_handle


def kernel_unsupported_reason(code: LdpcCode, spec: LayeredSpec):
    """Why the streamed kernel cannot take this code; None when it can."""
    why = unsupported_reason(code, spec)
    if why is not None:
        return why
    if _dmax(code) == 0:
        return f"{code.name}: check degree above {DMAXES[-1]}"
    return None


def make_streamed_decoder(code: LdpcCode, spec: LayeredSpec = LayeredSpec()):
    """Build ``decode(llr[B, N] int8) -> (bits[B, N] uint8, iters_used)``
    over the committed edges of ``build_layers(code, spec.schedule)``,
    ``pick_tile`` codewords per CTA; ``code`` may be a QC view
    (``col_perm``, deficient circulants, sub-pass layers), whose callers
    keep the base code's column order.

    On a CUDA tensor the decoder launches the kernel on PyTorch's current
    stream, with no host synchronisation; ``iters_used`` is a 0-d int32
    tensor on the card.  On a CPU tensor it runs the plain version, built
    on the first such call.
    """
    if spec.algo not in _lib.ALGO:
        raise ValueError(f"unknown algo {spec.algo!r}")
    why = kernel_unsupported_reason(code, spec)
    if why is not None:
        raise NotImplementedError(why)
    dmax = _dmax(code)
    # the tables and the SM count, read on the first call per card
    tables: dict[torch.device, tuple[dict, int]] = {}

    @functools.cache
    def plain():
        return make_layered_decoder(code, spec, "cpu")

    def decode(llr: torch.Tensor):
        _lib.check_llr(llr, code.N)
        if llr.device.type == "cpu":
            return plain()(llr)
        lib = _library()
        dev = llr.device
        if dev not in tables:
            tables[dev] = (edge_tables(code, spec, dev),
                           torch.cuda.get_device_properties(dev)
                           .multi_processor_count)
        t, sms = tables[dev]
        B = llr.shape[0]
        tile = pick_tile(code, B, sms)
        n_tiles = -(-B // tile)
        n_edges = int(t["vn"].numel())
        bits = torch.empty((B, code.N), dtype=torch.uint8, device=dev)
        app = torch.empty((n_tiles, code.N, tile), dtype=torch.int8, device=dev)
        msgs = torch.empty((n_tiles, n_edges, tile), dtype=torch.int8,
                           device=dev)
        iters = torch.empty((), dtype=torch.int32, device=dev)
        perm = t["perm"].data_ptr() if t["perm"].numel() else None
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.streamed_minsum_launch(
                llr.data_ptr(), bits.data_ptr(), app.data_ptr(),
                msgs.data_ptr(), iters.data_ptr(), t["row_ptr"].data_ptr(),
                t["n_checks"].data_ptr(), t["deg"].data_ptr(),
                t["vn"].data_ptr(), perm, int(t["deg"].numel()), n_edges,
                code.N, B, tile, dmax, _lib.ALGO[spec.algo],
                int(spec.minclamp == "pre"), spec.iters, int(spec.early_term),
                spec.offset, spec.nms_f, spec.nms_f2, spec.sat_var,
                spec.sat_msg, stream,
            )
        if err != 0:
            msg = lib.streamed_minsum_error_string(err).decode()
            raise RuntimeError(f"streamed_minsum launch failed: {msg} ({err})")
        launches["streamed_minsum"] += 1
        return bits, iters

    return decode

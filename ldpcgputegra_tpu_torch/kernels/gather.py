"""Wrapper of the hand-written CUDA gather min-sum kernel
(``csrc/gather_minsum.cu``): layered min-sum over the layers of any
schedule, the decode path of the non-QC codes (4000x2000 and its siblings).

Replaces the three TPU kernels of ``ldpcgputegra_tpu/kernels/
pallas_gather.py`` (``REPLACES``): the unrolled ``_build_kernel``, the
chunked ``_build_chunked_kernel`` and the message-streaming
``_build_streamed_chunked_kernel``, which compute the same decode and
differ only in TPU workarounds.  One launch runs the whole decode.

What bounds it on the card: as for the QC kernel, each edge of each
codeword costs an int8 message read and write in device memory per
iteration; the APP tile stays in shared memory.  A CTA of 512 threads
holds a tile of 32, 16 or 8 codewords and walks a layer's checks on
512 / tile lanes; ``pick_tile`` picks the tile and ``smem_bytes`` charges
the footprint of the variant launched.

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
from ..codes.schedule import build_layers
from ..ops.layered import (
    LayeredSpec,
    is_qc_view,
    make_layered_decoder,
    unsupported_reason,
)
from . import _lib

__all__ = ["make_gather_decoder", "kernel_unsupported_reason", "pick_tile",
           "smem_bytes", "build", "launches", "SOURCE", "REPLACES"]

SOURCE = os.path.join(_lib.CSRC, "gather_minsum.cu")
BUILD_DIR = _lib.BUILD_DIR
REPLACES = ("ldpcgputegra_tpu/kernels/pallas_gather.py:1215 (K3 _build_kernel), "
            ":1193 (K4 _build_chunked_kernel), "
            ":1125 (K5 _build_streamed_chunked_kernel)")

# mirrored from csrc/gather_minsum.cu
NTHREADS = 512  # threads per CTA
TILES = (8, 16, 32)  # codewords per CTA
DMAXES = (8, 16, 32)  # unrolled contribution array lengths

# Kernel launches in this process: the decoder adds one where it launches
# the kernel, and nowhere else.
launches = {"gather_minsum": 0}

_lib_handle: Optional[ctypes.CDLL] = None


def smem_bytes(N: int, tile: int) -> int:
    """Dynamic shared memory of one CTA: the [N][tile] int8 APP tile and
    the tile's convergence flags."""
    return ((N * tile + 15) & ~15) + 4 * tile


def pick_tile(code: LdpcCode, spec: LayeredSpec) -> int:
    """Codewords per CTA: of the tiles whose APP fits shared memory, the
    narrowest (the most check lanes) whose lanes number at most twice the
    largest layer's checks, else the widest; 0 when none fits.

    The kernel is bound by latency: each lane walks its checks of a layer
    one after the other, so lanes, not codewords, set its speed until they
    outnumber the checks (measured on the H100, see PERF.md: at 4000x2000,
    B=4096, tiles 32/16/8 took 3.90/2.22/1.70 ms; at 1024x518, whose
    layers hold at most 24 checks, 0.91/0.71/1.19 ms)."""
    fits = [t for t in TILES if smem_bytes(code.N, t) <= _lib.SMEM_MAX]
    if not fits:
        return 0
    max_checks = max(lay.n_checks for lay in build_layers(code, spec.schedule))
    return next((t for t in fits if NTHREADS // t <= 2 * max_checks), fits[-1])


def _dmax(code: LdpcCode) -> int:
    """The smallest unrolled contribution array that holds every check
    degree; 0 when none does."""
    deg = max(c.deg for c in code.classes)
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
        lib.gather_minsum_launch.argtypes = [p] * 8 + [i] * 15 + [p]
        lib.gather_minsum_launch.restype = i
        lib.gather_minsum_error_string.argtypes = [i]
        lib.gather_minsum_error_string.restype = ctypes.c_char_p
        _lib_handle = lib
    return _lib_handle


def kernel_unsupported_reason(code: LdpcCode, spec: LayeredSpec):
    """Why the gather kernel cannot take this code; None when it can."""
    why = unsupported_reason(code, spec)
    if why is not None:
        return why
    if is_qc_view(code):
        # its tables are the layers' full idx: a sub-pass layer's
        # conflicting rows and the deficient edge would decode wrongly
        return (f"{code.name}: a QC view (col_perm, deficient circulants, "
                "sub-pass layers), which this kernel does not take (the "
                "streamed kernel, kernels/streamed.py, does)")
    if _dmax(code) == 0:
        return f"{code.name}: check degree above {DMAXES[-1]}"
    if pick_tile(code, spec) == 0:
        return (f"{code.name}: an {TILES[0]}-codeword APP tile "
                f"({smem_bytes(code.N, TILES[0])} B) does not fit shared "
                "memory")
    return None


def make_gather_decoder(code: LdpcCode, spec: LayeredSpec = LayeredSpec()):
    """Build ``decode(llr[B, N] int8) -> (bits[B, N] uint8, iters_used)``
    over the layers of ``build_layers(code, spec.schedule)``, ``pick_tile``
    codewords per CTA.

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
    tile = pick_tile(code, spec)
    dmax = _dmax(code)
    tables: dict[torch.device, dict] = {}  # copied on the first call per card

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
            tables[dev] = edge_tables(code, spec, dev, wide=False)
        t = tables[dev]
        B = llr.shape[0]
        n_edges = int(t["vn"].numel())
        bits = torch.empty((B, code.N), dtype=torch.uint8, device=dev)
        msgs = torch.empty((-(-B // tile), n_edges, tile), dtype=torch.int8,
                           device=dev)
        iters = torch.empty((), dtype=torch.int32, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.gather_minsum_launch(
                llr.data_ptr(), bits.data_ptr(), msgs.data_ptr(),
                iters.data_ptr(), t["row_ptr"].data_ptr(),
                t["n_checks"].data_ptr(), t["deg"].data_ptr(),
                t["vn"].data_ptr(), int(t["deg"].numel()), n_edges, code.N,
                B, tile, dmax, _lib.ALGO[spec.algo],
                int(spec.minclamp == "pre"), spec.iters, int(spec.early_term),
                spec.offset, spec.nms_f, spec.nms_f2, spec.sat_var,
                spec.sat_msg, stream,
            )
        if err != 0:
            msg = lib.gather_minsum_error_string(err).decode()
            raise RuntimeError(f"gather_minsum launch failed: {msg} ({err})")
        launches["gather_minsum"] += 1
        return bits, iters

    return decode

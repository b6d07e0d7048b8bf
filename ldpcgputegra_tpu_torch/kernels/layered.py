"""Wrapper of the hand-written CUDA layered min-sum kernel
(``csrc/layered_minsum.cu``).

Replaces ``ldpcgputegra_tpu/kernels/pallas_layered.py::_build_kernel``
(launched there by ``make_pallas_decoder``): one launch runs the whole
layered decode of a QC code, all iterations and all block-rows.

What bounds it on the card: the latency of each check lane's message
loads, one round of a block-row's checks after another, not its integer
operations or its bytes.  A CTA of 512 threads holds a tile of codewords'
APP array in shared memory ([N][tile] int8), four codewords a thread at
DMAX 8 (one 32-bit access an edge), and walks a block-row's Z checks on
512 x pack / tile lanes; the messages live in device memory, the codeword
fastest.  ``pick_tile`` picks the tile from the batch and the
card's SM count, the fewest rounds for the card's CTAs, and
``smem_bytes`` / ``ctas_per_sm`` charge the variant launched.

The kernel is compiled at first use (``kernels/_lib.py``), from this
checkout's sources only, and loaded with ctypes.  Importing this module
needs neither nvcc nor CUDA.

With ``emit_mask`` the kernel also writes ``ok[B]``, the true syndrome of
each output codeword (``pallas_layered.py``'s ``syndrome_pass``), from one
more walk over the block-rows after the iteration loop: the phase-1 output
of two-phase early termination (``decoder/twophase.py``).

On a CPU tensor the decoder runs the plain version
(``ops/layered.py::make_layered_decoder``, then
``decoder/twophase.py::syndrome_fn`` for the mask); on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Optional

import torch

from ..codes.code import LdpcCode
from ..codes.convert import qc_tables
from ..codes.schedule import build_layers
from ..decoder.twophase import syndrome_fn
from ..ops.layered import (
    LayeredSpec,
    is_qc_view,
    make_layered_decoder,
    unsupported_reason,
)
from ..utils.profiling import span
from . import _lib

__all__ = ["make_cuda_decoder", "cuda_supported", "kernel_unsupported_reason",
           "pick_tile", "pack", "smem_bytes", "ctas_per_sm", "build",
           "launches", "SOURCE", "REPLACES"]

SOURCE = os.path.join(_lib.CSRC, "layered_minsum.cu")
BUILD_DIR = _lib.BUILD_DIR
REPLACES = "ldpcgputegra_tpu/kernels/pallas_layered.py:139"  # _build_kernel

# mirrored from csrc/layered_minsum.cu
NTHREADS = 512  # threads per CTA
TILES = (32, 16, 8, 4)  # codewords per CTA
DMAXES = (8, 16, 32)  # unrolled contribution array lengths

# Kernel launches in this process, by kernel name: the decoder adds one
# where it launches the kernel, and nowhere else.
launches = {"layered_minsum": 0}

_lib_handle: Optional[ctypes.CDLL] = None


def _dmax(code: LdpcCode) -> int:
    """The smallest unrolled contribution array that holds every block-row's
    degree; 0 when none does."""
    deg = max(lay.deg for lay in code.layers)
    return next((d for d in DMAXES if d >= deg), 0)


def pack(code: LdpcCode) -> int:
    """Codewords a thread holds: 4 packed in one 32-bit access at DMAX 8,
    1 at DMAX 16 and 32."""
    return 4 if _dmax(code) == 8 else 1


def smem_bytes(code: LdpcCode, tile: int) -> int:
    """Dynamic shared memory of one CTA: the [N][tile] int8 APP tile, the
    block edges' columns and shifts, the block-row offsets and the tile's
    convergence flags."""
    n_edges = sum(lay.deg for lay in code.layers)
    app = (code.N * tile + 15) & ~15
    return app + 4 * (2 * n_edges + len(code.layers) + 1 + tile)


def ctas_per_sm(code: LdpcCode, tile: int) -> int:
    """CTAs of this variant that one SM holds at once: one (the kernel's
    launch bounds give a thread up to 128 registers), where its shared
    memory fits."""
    return _lib.ctas_per_sm(NTHREADS, smem_bytes(code, tile), 1)


def pick_tile(code: LdpcCode, B: int, sms: int = _lib.SMS_H100) -> int:
    """Codewords per CTA for a batch of ``B`` on a card of ``sms`` SMs; 0
    when no tile's APP fits shared memory.

    Each check lane waits on device memory once a round, and a block-row
    takes ceil(Z / lanes) rounds, lanes = 512 x pack / tile; the CTAs run
    ceil(CTAs / (sms x ctas_per_sm)) after one another.  The pick is the
    tile with the fewest of their product, the narrowest of equals (more
    SMs at work).  The tile against ms on the H100 is ``PERF.md`` §6's
    table, from ``bench/tiles.py``."""
    best, best_cost = 0, None
    for tile in TILES:
        if smem_bytes(code, tile) > _lib.SMEM_MAX:
            continue
        waves = -(-(-(-B // tile)) // (sms * ctas_per_sm(code, tile)))
        rounds = -(-code.Z // (NTHREADS * pack(code) // tile))
        cost = waves * rounds
        if best_cost is None or cost <= best_cost:
            best, best_cost = tile, cost
    return best


def build() -> dict:
    """Compile the kernel library if this source has not been built yet;
    ``{"path", "seconds", "log"}`` (see ``_lib.build_library``)."""
    return _lib.build_library(SOURCE, BUILD_DIR)


def _library() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is None:
        lib = ctypes.CDLL(build()["path"])
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.layered_minsum_launch.argtypes = [p] * 8 + [i] * 16 + [p]
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
                "sub-pass layers); this kernel walks whole QC block-rows, so "
                "it leaves the views to the streamed kernel "
                "(kernels/streamed.py), which walks committed edges")
    # the kernel's tables are code.layers: it takes a schedule only where
    # that gives the same QC block-rows
    if not code.is_qc or any(
            lay.qc is None for lay in build_layers(code, spec.schedule)):
        return (f"{code.name}: the {spec.schedule} schedule gives non-QC "
                "layers, which this kernel does not walk (the gather kernel, "
                "kernels/gather.py, does)")
    if _dmax(code) == 0:
        return f"{code.name}: check degree above {DMAXES[-1]}"
    if smem_bytes(code, TILES[-1]) > _lib.SMEM_MAX:
        return (f"{code.name}: a {TILES[-1]}-codeword APP tile "
                f"({smem_bytes(code, TILES[-1])} B) does not fit shared "
                "memory (the streamed kernel, kernels/streamed.py, keeps the "
                "APP in device memory)")
    return None


def cuda_supported(code: LdpcCode, spec: LayeredSpec) -> bool:
    """True when the CUDA kernel takes this code and spec."""
    return kernel_unsupported_reason(code, spec) is None


def make_cuda_decoder(code: LdpcCode, spec: LayeredSpec = LayeredSpec(),
                      emit_mask: bool = False):
    """Build ``decode(llr[B, N] int8) -> (bits[B, N] uint8, iters_used)``,
    ``pick_tile`` codewords per CTA for each call's batch (computed once a
    batch size and card, ``_lib.cached_pick``); with ``emit_mask``, ``(bits,
    iters_used, ok[B] bool)``, ``ok`` true where the output satisfies every
    check (not with ``spec.early_term``, as in the JAX package).

    On a CUDA tensor it launches the kernel on PyTorch's current stream,
    with no host synchronisation; ``iters_used`` is a 0-d int32 tensor on
    the card.  On a CPU tensor it runs the plain version, built on the
    first such call.
    While a profiler runs, each call records the span ``ldpc.decode``
    (its frames) and, on the card, ``ldpc.decode.pick`` around the
    tile's pick, count 1 where it was computed and 0 where it was looked
    up (``utils/profiling.py``).
    """
    if spec.algo not in _lib.ALGO:
        raise ValueError(f"unknown algo {spec.algo!r}")
    if emit_mask and spec.early_term:
        raise ValueError("emit_mask is the phase-1 output of two-phase early "
                         "termination; it does not combine with early_term")
    why = kernel_unsupported_reason(code, spec)
    if why is not None:
        raise NotImplementedError(why)
    dmax = _dmax(code)
    # the tables and the SM count, read on the first call per card
    tables: dict[torch.device, tuple[dict, int]] = {}
    # the tiles by (pick_tile, B, SMs) (_lib.cached_pick)
    picks: dict[tuple, int] = {}

    @functools.cache
    def plain():
        return make_layered_decoder(code, spec, "cpu")

    @functools.cache
    def plain_ok():
        return syndrome_fn(code, "cpu")

    def decode(llr: torch.Tensor):
        _lib.check_llr(llr, code.N)
        with span("decode", count=llr.shape[0]):
            if llr.device.type == "cpu":
                bits, iters = plain()(llr)
                if emit_mask:
                    return bits, iters, plain_ok()(bits)
                return bits, iters
            lib = _library()
            dev = llr.device
            if dev not in tables:
                tables[dev] = (qc_tables(code, dev), _lib.sm_count(dev))
            t, sms = tables[dev]
            B = llr.shape[0]
            tile = _lib.cached_pick(picks, pick_tile, code, B, sms)
            n_edges = int(t["cols"].numel())
            bits = torch.empty((B, code.N), dtype=torch.uint8, device=dev)
            msgs = torch.empty((-(-B // tile), code.Z * n_edges, tile),
                               dtype=torch.int8, device=dev)
            iters = torch.empty((), dtype=torch.int32, device=dev)
            ok = (torch.empty(B, dtype=torch.bool, device=dev) if emit_mask
                  else None)
            with torch.cuda.device(dev):
                stream = torch.cuda.current_stream(dev).cuda_stream
                err = lib.layered_minsum_launch(
                    llr.data_ptr(), bits.data_ptr(), msgs.data_ptr(),
                    iters.data_ptr(), ok.data_ptr() if emit_mask else None,
                    t["row_ptr"].data_ptr(),
                    t["cols"].data_ptr(), t["shifts"].data_ptr(),
                    len(code.layers), n_edges, code.N, code.Z, B, tile, dmax,
                    _lib.ALGO[spec.algo], int(spec.minclamp == "pre"),
                    spec.iters, int(spec.early_term), spec.offset, spec.nms_f,
                    spec.nms_f2, spec.sat_var, spec.sat_msg, stream,
                )
            if err != 0:
                msg = lib.layered_minsum_error_string(err).decode()
                raise RuntimeError(
                    f"layered_minsum launch failed: {msg} ({err})")
            launches["layered_minsum"] += 1
            return (bits, iters, ok) if emit_mask else (bits, iters)

    return decode

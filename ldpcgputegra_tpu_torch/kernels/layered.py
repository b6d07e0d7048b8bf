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

The kernel is compiled (``kernels/_lib.py``), from this checkout's
sources only, into one library for each (algorithm, minclamp) pair, at
that pair's first use (``build``), and loaded with ctypes.  Importing this
module needs neither nvcc nor CUDA.

With ``emit_mask`` the kernel also writes ``ok[B]``, the true syndrome of
each output codeword (``pallas_layered.py``'s ``syndrome_pass``), from one
more walk over the block-rows after the iteration loop: the phase-1 output
of two-phase early termination (``decoder/twophase.py``).

On a CPU tensor the decoder runs the plain version
(``ops/layered.py::make_layered_decoder``, then
``decoder/twophase.py::syndrome_fn`` for the mask); on a CUDA tensor it
launches the kernel or raises (``_lib.make_decode``).
"""

from __future__ import annotations

import ctypes
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
# the C entry's arguments before the spec's (_lib.SPEC_ARGTYPES)
ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7

# Kernel launches in this process, by kernel name: the decoder adds one
# where it launches the kernel, and nowhere else; those with the mask
# (``emit_mask``) count under "layered_minsum_mask" too.
launches = {"layered_minsum": 0, "layered_minsum_mask": 0}


def pack(code: LdpcCode) -> int:
    """Codewords a thread holds: 4 packed in one 32-bit access at DMAX 8,
    1 at DMAX 16 and 32."""
    return 4 if _lib.dmax(code.layers) == 8 else 1


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


def build(algo: str = "OMS", minclamp: str = "pre",
          build_dir: Optional[str] = None) -> dict:
    """Compile the library of one (algorithm, minclamp) pair if this source
    has not been built for it yet; ``{"path", "seconds", "log"}`` (see
    ``_lib.build_library``)."""
    return _lib.build_library(SOURCE, build_dir or BUILD_DIR,
                              _lib.defines(algo, minclamp))


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
    if _lib.dmax(code.layers) == 0:
        return f"{code.name}: check degree above {_lib.DMAXES[-1]}"
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

    On a CUDA tensor the decoder launches the kernel (``_lib.make_decode``:
    the current stream, no host synchronisation, the spans ``ldpc.decode``
    and ``ldpc.decode.pick``; with ``emit_mask`` each launch is counted
    under ``launches["layered_minsum_mask"]`` too); ``iters_used`` is a 0-d
    int32 tensor on the card.  On a CPU tensor it runs the plain version.
    """
    if spec.algo not in _lib.ALGO:
        raise ValueError(f"unknown algo {spec.algo!r}")
    if emit_mask and spec.early_term:
        raise ValueError("emit_mask is the phase-1 output of two-phase early "
                         "termination; it does not combine with early_term")
    why = kernel_unsupported_reason(code, spec)
    if why is not None:
        raise NotImplementedError(why)
    dmax = _lib.dmax(code.layers)

    def launch(t: dict, llr: torch.Tensor, tile: int):
        B, dev = llr.shape[0], llr.device
        n_edges = int(t["cols"].numel())
        bits = torch.empty((B, code.N), dtype=torch.uint8, device=dev)
        msgs = torch.empty((-(-B // tile), code.Z * n_edges, tile),
                           dtype=torch.int8, device=dev)
        iters = torch.empty((), dtype=torch.int32, device=dev)
        if not emit_mask:
            ok, out = None, (bits, iters)
        else:
            ok = torch.empty(B, dtype=torch.bool, device=dev)
            out = (bits, iters, ok)
        return (llr.data_ptr(), bits.data_ptr(), msgs.data_ptr(),
                iters.data_ptr(), None if ok is None else ok.data_ptr(),
                t["row_ptr"].data_ptr(), t["cols"].data_ptr(),
                t["shifts"].data_ptr(), len(code.layers), n_edges, code.N,
                code.Z, B, tile, dmax), out

    def plain_with_mask():
        dec = make_layered_decoder(code, spec, "cpu")
        syndrome = syndrome_fn(code, "cpu")

        def decode(llr):
            bits, iters = dec(llr)
            return bits, iters, syndrome(bits)

        return decode

    decode = _lib.make_decode(
        code, spec, "layered_minsum", ARGTYPES, launches,
        tables=lambda dev: qc_tables(code, dev), pick_tile=lambda: pick_tile,
        pick_args=(), launch=launch,
        plain=plain_with_mask if emit_mask else None)
    if not emit_mask:
        return decode

    def decode_mask(llr: torch.Tensor):
        out = decode(llr)
        if llr.device.type == "cuda":
            launches["layered_minsum_mask"] += 1
        return out

    return decode_mask

"""Wrapper of the hand-written CUDA gather min-sum kernel
(``csrc/gather_minsum.cu``): layered min-sum over the layers of any
schedule, the decode path of the non-QC codes (4000x2000 and its siblings).

Replaces the three TPU kernels of ``ldpcgputegra_tpu/kernels/
pallas_gather.py`` (``REPLACES``): the unrolled ``_build_kernel``, the
chunked ``_build_chunked_kernel`` and the message-streaming
``_build_streamed_chunked_kernel``, which compute the same decode and
differ only in TPU workarounds.  One launch runs the whole decode.

What bounds it on the card: the instructions of its edge updates at the
sweep's shape, and the latency of each check lane's round where a batch
or a layer is small.  A CTA of 512 threads holds a tile of codewords' APP
in shared memory ([N][tile] int8) and walks a layer's checks on its check
lanes, four codewords a thread packed in one 32-bit access; a build
(``Variant``) fixes the tile and the lanes a check (``k``); the algorithm
and the minclamp placement are compiled in, one build each.
``pick_tile`` picks the variant from the code, the batch and the card's
SM count; ``smem_bytes`` and ``ctas_per_sm`` charge the variant launched.

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
from typing import NamedTuple, Optional, Sequence

import torch

from ..codes.code import LdpcCode
from ..codes.convert import edge_tables, layer_shapes
from ..ops.layered import (
    LayeredSpec,
    is_qc_view,
    make_layered_decoder,
    unsupported_reason,
)
from ..utils.profiling import span
from . import _lib

__all__ = ["make_gather_decoder", "kernel_unsupported_reason", "pick_tile",
           "Variant", "variants", "smem_bytes", "ctas_per_sm", "BUILDS",
           "build", "launches", "SOURCE", "REPLACES"]

SOURCE = os.path.join(_lib.CSRC, "gather_minsum.cu")
BUILD_DIR = _lib.BUILD_DIR
REPLACES = ("ldpcgputegra_tpu/kernels/pallas_gather.py:1215 (K3 _build_kernel), "
            ":1193 (K4 _build_chunked_kernel), "
            ":1125 (K5 _build_streamed_chunked_kernel)")

# mirrored from csrc/gather_minsum.cu
NTHREADS = 512  # threads per CTA
W = 4  # codewords a thread, packed in one 32-bit access
TILES = (32, 16, 8, 4)  # codewords per CTA
DMAXES = (8, 16, 32)  # unrolled contribution array lengths
SMS_H100 = _lib.SMS_H100


class Variant(NamedTuple):
    """One build of the kernel: codewords per CTA, lanes a check."""

    tile: int
    k: int


# the builds by DMAX (csrc/gather_minsum.cu::GATHER_VARIANTS): a lane holds
# DMAX / k <= 8 edges, at the (tile, k) that the pick reaches
BUILDS = {
    8: tuple(Variant(t, 2) for t in TILES) + (Variant(32, 4), Variant(16, 4)),
    16: (Variant(32, 2),) + tuple(Variant(t, 4) for t in TILES),
    32: tuple(Variant(t, 4) for t in TILES),
}

# The pick's model of a check round on one lane, in units of its memory
# trips (the VN ids and messages, then the APP words): the issue of its
# ceil(d / k) edges at EDGE_COST each, stretched by SHARE x the CTAs an SM
# holds x the share of a CTA's threads at work in the round: the warps
# that issue beside it on the SM.  Fitted to the variant table of an H100
# (bench/tiles.py, PERF.md §6): the pick is within 3.1% of the fastest
# variant at all 16 shapes there, and stays so with either moved alone
# over SHARE 0.1-3.9 or EDGE_COST 0.95-2.3.
EDGE_COST = 1.5
SHARE = 1.0

# Kernel launches in this process: the decoder adds one where it launches
# the kernel, and nowhere else.
launches = {"gather_minsum": 0}

_lib_handle: Optional[ctypes.CDLL] = None


def _dmax(code: LdpcCode) -> int:
    """The smallest unrolled contribution array that holds every check
    degree; 0 when none does."""
    deg = max(c.deg for c in code.classes)
    return next((d for d in DMAXES if d >= deg), 0)


def smem_bytes(code: LdpcCode, v: Variant) -> int:
    """Dynamic shared memory of one CTA: the [N][tile] int8 APP tile and
    the tile's convergence flags."""
    return ((code.N * v.tile + 15) & ~15) + 4 * v.tile


def ctas_per_sm(code: LdpcCode, v: Variant) -> int:
    """CTAs of this variant that one SM holds at once: two (the kernel's
    launch bounds give it 64 registers a thread), as its shared memory
    allows."""
    return _lib.ctas_per_sm(NTHREADS, smem_bytes(code, v), 2)


def variants(code: LdpcCode) -> list[Variant]:
    """The builds that take this code: its DMAX, and an APP tile that fits
    shared memory."""
    return [v for v in BUILDS.get(_dmax(code), ())
            if smem_bytes(code, v) <= _lib.SMEM_MAX]


def pick_tile(code: LdpcCode, B: int, sms: int = SMS_H100,
              schedule: str = "auto",
              shapes: Optional[Sequence[tuple]] = None) -> Optional[Variant]:
    """The variant for a batch of ``B`` on a card of ``sms`` SMs, by
    ``_lib.pick_by_rounds``; None when no build takes the code.

    A layer of G checks of degree d takes ceil(G / lanes) rounds, lanes =
    512 x 4 / (tile x k), each costing one round trip and ceil(d / k) x
    ``EDGE_COST`` x (1 + ``SHARE`` x busy) of issue, busy being the CTAs
    an SM holds times the share of a round's lanes at work.  The pick has
    the least waves x rounds; of equals, the wider tile (fewer CTAs share
    an SM).  The variants against ms on the H100 are ``PERF.md`` §6's
    table, from ``bench/tiles.py``."""
    shapes = layer_shapes(code, schedule) if shapes is None else shapes
    return _lib.pick_by_rounds(
        variants(code), B, sms, shapes,
        lanes=lambda v: NTHREADS * W // (v.tile * v.k),
        per_sm=lambda v: ctas_per_sm(code, v),
        round_cost=lambda v, d, busy: (1.0 + EDGE_COST * -(-d // v.k)
                                       * (1.0 + SHARE * busy)),
        prefer=lambda v: -v.tile)


def build() -> dict:
    """Compile the kernel library if this source has not been built yet;
    ``{"path", "seconds", "log"}`` (see ``_lib.build_library``)."""
    return _lib.build_library(SOURCE, BUILD_DIR)


def _library() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is None:
        lib = ctypes.CDLL(build()["path"])
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gather_minsum_launch.argtypes = [p] * 8 + [i] * 16 + [p]
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
    if not variants(code):
        smallest = min(BUILDS[_dmax(code)], key=lambda v: v.tile)
        return (f"{code.name}: a {smallest.tile}-codeword APP tile "
                f"({smem_bytes(code, smallest)} B) does not fit shared "
                "memory")
    return None


def make_gather_decoder(code: LdpcCode, spec: LayeredSpec = LayeredSpec()):
    """Build ``decode(llr[B, N] int8) -> (bits[B, N] uint8, iters_used)``
    over the layers of ``build_layers(code, spec.schedule)``, in the variant
    ``pick_tile`` picks for each call's batch (computed once a batch size
    and card, ``_lib.cached_pick``).

    On a CUDA tensor the decoder launches the kernel on PyTorch's current
    stream, with no host synchronisation; ``iters_used`` is a 0-d int32
    tensor on the card.  On a CPU tensor it runs the plain version, built
    on the first such call.
    While a profiler runs, each call records the span ``ldpc.decode``
    (its frames) and, on the card, ``ldpc.decode.pick`` around the
    variant's pick, count 1 where it was computed and 0 where it was
    looked up (``utils/profiling.py``).
    """
    if spec.algo not in _lib.ALGO:
        raise ValueError(f"unknown algo {spec.algo!r}")
    why = kernel_unsupported_reason(code, spec)
    if why is not None:
        raise NotImplementedError(why)
    dmax = _dmax(code)
    shapes = layer_shapes(code, spec.schedule)
    # the tables and the SM count, read on the first call per card
    tables: dict[torch.device, tuple[dict, int]] = {}
    # the picks by (pick_tile, B, SMs) (_lib.cached_pick)
    picks: dict[tuple, Variant] = {}

    @functools.cache
    def plain():
        return make_layered_decoder(code, spec, "cpu")

    def decode(llr: torch.Tensor):
        _lib.check_llr(llr, code.N)
        with span("decode", count=llr.shape[0]):
            if llr.device.type == "cpu":
                return plain()(llr)
            lib = _library()
            dev = llr.device
            if dev not in tables:
                tables[dev] = (edge_tables(code, spec, dev, wide=False),
                               _lib.sm_count(dev))
            t, sms = tables[dev]
            B = llr.shape[0]
            v = _lib.cached_pick(picks, pick_tile, code, B, sms,
                                 spec.schedule, shapes)
            n_edges = int(t["vn"].numel())
            bits = torch.empty((B, code.N), dtype=torch.uint8, device=dev)
            msgs = torch.empty((-(-B // v.tile), n_edges, v.tile),
                               dtype=torch.int8, device=dev)
            iters = torch.empty((), dtype=torch.int32, device=dev)
            with torch.cuda.device(dev):
                stream = torch.cuda.current_stream(dev).cuda_stream
                err = lib.gather_minsum_launch(
                    llr.data_ptr(), bits.data_ptr(), msgs.data_ptr(),
                    iters.data_ptr(), t["row_ptr"].data_ptr(),
                    t["n_checks"].data_ptr(), t["deg"].data_ptr(),
                    t["vn"].data_ptr(), int(t["deg"].numel()), n_edges, code.N,
                    B, v.tile, v.k, dmax, _lib.ALGO[spec.algo],
                    int(spec.minclamp == "pre"), spec.iters,
                    int(spec.early_term), spec.offset, spec.nms_f, spec.nms_f2,
                    spec.sat_var, spec.sat_msg, stream,
                )
            if err != 0:
                msg = lib.gather_minsum_error_string(err).decode()
                raise RuntimeError(
                    f"gather_minsum launch failed: {msg} ({err})")
            launches["gather_minsum"] += 1
            return bits, iters

    return decode

"""Wrapper of the hand-written CUDA streamed min-sum kernel
(``csrc/streamed_minsum.cu``): layered min-sum over committed edges, the
decode path of the DVB-S2 family (the Z=360 QC views of the staircase
codes) and of synthqc-256x128x6-z1024.

Replaces ``ldpcgputegra_tpu/kernels/pallas_streamed.py::
_build_streamed_kernel`` (K2, ``REPLACES``): one launch runs the whole
decode.  K2 keeps the APP on chip and streams the messages; on the card
the messages are a scratch buffer in device memory that this wrapper
allocates (``[ceil(B / tile)][E][tile]`` int8), and the APP lives in
shared memory where ``tile`` codewords of it fit (``[N][tile]`` int8: up to
2 codewords of 64800 bits, 8 of 16200), else in a device-memory scratch
buffer (``[ceil(B / tile)][N][tile]``, synthqc).

What bounds it on the card: the latency of each check lane's accesses,
one round of a layer's checks after another.  ``pick_tile`` picks the
variant, (APP placement, codewords per CTA, lanes per check), from the
code, the batch and the card's SM count; ``smem_bytes`` and
``ctas_per_sm`` charge the variant it launches.

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
from ..ops.layered import LayeredSpec, make_layered_decoder, unsupported_reason
from ..utils.profiling import span
from . import _lib

__all__ = ["make_streamed_decoder", "kernel_unsupported_reason", "pick_tile",
           "Variant", "variants", "smem_bytes", "ctas_per_sm",
           "layer_shapes", "build", "launches", "SOURCE", "REPLACES"]

SOURCE = os.path.join(_lib.CSRC, "streamed_minsum.cu")
BUILD_DIR = _lib.BUILD_DIR
REPLACES = "ldpcgputegra_tpu/kernels/pallas_streamed.py:73"  # _build_streamed_kernel

# mirrored from csrc/streamed_minsum.cu
NTHREADS = 512  # threads per CTA
TILES = (32, 16, 8, 4, 2, 1)  # codewords per CTA, APP in device memory
SMEM_TILES = (8, 4, 2, 1)  # codewords per CTA, APP in shared memory
DMAXES = (8, 16, 32)  # unrolled contribution array lengths
LANES = (1, 2, 4)  # lanes a check; above 1 at DMAX 16 and 32, tiles <= 8
SMS_H100 = _lib.SMS_H100

# The pick's model of a check round, in units of a round with the APP in
# shared memory (one device-memory trip, for the VN ids and messages): a
# round with the APP in device memory, which waits for a second trip and
# shares the L2 with every APP access, and the issue of one edge on a
# lane.  Fitted to the variant table of an H100 (bench/tiles.py, PERF.md
# §6): every value from 2.5 to 6 and from 0.03 to 0.25 picks the fastest
# variant at all six shapes there.
ROUND_COST = {"smem": 1.0, "device": 4.0}
EDGE_COST = 0.125

# Kernel launches in this process: the decoder adds one where it launches
# the kernel, and nowhere else.
launches = {"streamed_minsum": 0}

_lib_handle: Optional[ctypes.CDLL] = None


class Variant(NamedTuple):
    """One build of the kernel: where the APP lives ("smem" or "device"),
    codewords per CTA, lanes per check."""

    placement: str
    tile: int
    k: int


def _dmax(code: LdpcCode) -> int:
    """The smallest unrolled contribution array that holds every check
    degree; 0 when none does."""
    deg = max(lay.deg for lay in code.layers)
    return next((d for d in DMAXES if d >= deg), 0)


def smem_bytes(code: LdpcCode, v: Variant) -> int:
    """Shared memory of one CTA: the [N][tile] APP where it lives there, and
    the tile's convergence flags."""
    app = (code.N * v.tile + 15) & ~15 if v.placement == "smem" else 0
    return app + 4 * v.tile


def ctas_per_sm(code: LdpcCode, v: Variant) -> int:
    """CTAs of this variant that one SM holds at once: two where a lane's
    DMAX / k contributions fit 64 registers a thread (the kernel's launch
    bounds), else one, as its shared memory allows."""
    return _lib.ctas_per_sm(NTHREADS, smem_bytes(code, v),
                            2 if _dmax(code) // v.k <= 8 else 1)


def variants(code: LdpcCode) -> list[Variant]:
    """The built variants that take this code: its DMAX, and an APP that
    fits shared memory where it lives there."""
    dmax = _dmax(code)
    out = []
    for placement, tiles in (("smem", SMEM_TILES), ("device", TILES)):
        for tile in tiles:
            for k in LANES:
                v = Variant(placement, tile, k)
                if k > 1 and (dmax < 16 or tile > 8):
                    continue
                if placement == "smem" and smem_bytes(code, v) > _lib.SMEM_MAX:
                    continue
                out.append(v)
    return out


def pick_tile(code: LdpcCode, B: int, sms: int = SMS_H100,
              schedule: str = "auto",
              shapes: Optional[Sequence[tuple]] = None) -> Variant:
    """The variant for a batch of ``B`` on a card of ``sms`` SMs, by
    ``_lib.pick_by_rounds``.

    A layer of G committed checks of degree d takes ceil(G / lanes)
    rounds, lanes = 512 / (tile x k), each costing ``ROUND_COST`` of its
    APP placement and ceil(d / k) x ``EDGE_COST`` of issue.  The pick has
    the least waves x rounds; of equals, the APP in shared memory, then
    the narrowest tile.
    The variants against ms on the H100 are ``PERF.md`` §6's table, from
    ``bench/tiles.py``."""
    shapes = layer_shapes(code, schedule) if shapes is None else shapes
    return _lib.pick_by_rounds(
        variants(code), B, sms, shapes,
        lanes=lambda v: NTHREADS // (v.tile * v.k),
        per_sm=lambda v: ctas_per_sm(code, v),
        round_cost=lambda v, d, busy: (ROUND_COST[v.placement]
                                       + EDGE_COST * -(-d // v.k)),
        prefer=lambda v: (v.placement != "smem", v.tile))


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
            [p] * 10 + [i, ctypes.c_longlong] + [i] * 15 + [p])
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
    over the committed edges of ``build_layers(code, spec.schedule)``, in
    the variant ``pick_tile`` picks for each call's batch (computed once a
    batch size and card, ``_lib.cached_pick``); ``code`` may be a QC view
    (``col_perm``, deficient circulants, sub-pass layers), whose callers
    keep the base code's column order.

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
                tables[dev] = (edge_tables(code, spec, dev),
                               _lib.sm_count(dev))
            t, sms = tables[dev]
            B = llr.shape[0]
            v = _lib.cached_pick(picks, pick_tile, code, B, sms,
                                 spec.schedule, shapes)
            n_tiles = -(-B // v.tile)
            n_edges = int(t["vn"].numel())
            bits = torch.empty((B, code.N), dtype=torch.uint8, device=dev)
            app = (None if v.placement == "smem" else torch.empty(
                (n_tiles, code.N, v.tile), dtype=torch.int8, device=dev))
            msgs = torch.empty((n_tiles, n_edges, v.tile), dtype=torch.int8,
                               device=dev)
            iters = torch.empty((), dtype=torch.int32, device=dev)
            perm = t["perm"].data_ptr() if t["perm"].numel() else None
            with torch.cuda.device(dev):
                stream = torch.cuda.current_stream(dev).cuda_stream
                err = lib.streamed_minsum_launch(
                    llr.data_ptr(), bits.data_ptr(),
                    None if app is None else app.data_ptr(), msgs.data_ptr(),
                    iters.data_ptr(), t["row_ptr"].data_ptr(),
                    t["n_checks"].data_ptr(), t["deg"].data_ptr(),
                    t["vn"].data_ptr(), perm, int(t["deg"].numel()), n_edges,
                    code.N, B, v.tile, dmax, v.k, int(v.placement == "smem"),
                    _lib.ALGO[spec.algo], int(spec.minclamp == "pre"),
                    spec.iters, int(spec.early_term), spec.offset, spec.nms_f,
                    spec.nms_f2, spec.sat_var, spec.sat_msg, stream,
                )
            if err != 0:
                msg = lib.streamed_minsum_error_string(err).decode()
                raise RuntimeError(
                    f"streamed_minsum launch failed: {msg} ({err})")
            launches["streamed_minsum"] += 1
            return bits, iters

    return decode

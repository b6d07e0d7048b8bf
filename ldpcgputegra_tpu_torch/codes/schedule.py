"""Layered-schedule construction beyond the reference check order
(the port's copy of ``ldpcgputegra_tpu/codes/schedule.py``).

The reference processes checks strictly in table order (layered/turbo
schedule; one CUDA thread walks every check sequentially,
``code/gpu_fixed/decoder_ms/cuda/CUDA_MS_SIMD.cu:138-246``).  A batched
decoder wants wide conflict-free groups of checks to work on at once.

Two schedules are provided:

* ``reference`` — greedy maximal runs of *consecutive* checks with disjoint
  VNs (``codes.code.compute_layers``).  Bit-exact to the reference order,
  but degenerates to 1-check runs for staircase codes (DVB-S2).
* ``colored`` — balanced greedy graph coloring of the check-conflict graph
  (two checks conflict iff they share a VN).  Every color class is a valid
  parallel layer; the schedule is still serial-C layered decoding, just in
  a permuted check order, so BER behaviour is preserved (validated by the
  Monte-Carlo tests) while the number of sequential steps drops to roughly
  the maximum VN degree.
"""

from __future__ import annotations

import weakref
from typing import Sequence

import numpy as np

from ..utils.profiling import span
from .code import Layer, LdpcCode

__all__ = ["color_layers", "build_layers"]

# id(code) -> (weak reference to the code, its colored layers)
_colored: dict[int, tuple] = {}


def color_layers(code: LdpcCode) -> list[Layer]:
    """Balanced greedy coloring of checks into conflict-free layers.

    Checks are visited in reference order; each is assigned the lowest
    color whose class doesn't already use one of its VNs, preferring the
    least-filled class among admissible colors to balance layer sizes.
    Layers keep one uniform degree each (degree classes are colored
    separately so the index tables stay rectangular).

    The pass is pure Python, and routing, the fit check, the kernel's
    tables and the plain decoder all ask for the same layers: they are
    computed once per code object, while it lives.  The computation (not
    the lookup) is the span ``ldpc.schedule.color``, counting the layers
    made.
    """
    key = id(code)
    hit = _colored.get(key)
    if hit is not None and hit[0]() is code:
        return hit[1]
    with span("schedule.color") as sp:
        layers = _color(code)
        sp.count = len(layers)
    _colored[key] = (weakref.ref(code, lambda _: _colored.pop(key, None)),
                     layers)
    return layers


def _color(code: LdpcCode) -> list[Layer]:
    layers: list[Layer] = []
    edge_offset = 0
    for ci in code.class_idx:
        n, deg = ci.shape
        used_vns: list[set[int]] = []
        members: list[list[int]] = []
        for c in range(n):
            row = ci[c].tolist()
            best = -1
            for k in range(len(members)):
                if not any(v in used_vns[k] for v in row):
                    if best < 0 or len(members[k]) < len(members[best]):
                        best = k
            if best < 0:
                used_vns.append(set())
                members.append([])
                best = len(members) - 1
            used_vns[best].update(row)
            members[best].append(c)
        for k in range(len(members)):
            idx = ci[np.asarray(members[k], dtype=np.int64)]
            layers.append(Layer(idx=idx, edge_offset=edge_offset))
            edge_offset += idx.size
    return layers


def build_layers(code: LdpcCode, schedule: str = "auto") -> Sequence[Layer]:
    """Return layers for the requested schedule.

    ``auto`` keeps the bit-exact reference layers when they are efficient
    (QC block-rows, or few runs) and falls back to coloring otherwise.
    """
    if schedule == "reference":
        return code.layers
    if schedule == "colored":
        return color_layers(code)
    if schedule == "auto":
        if code.is_qc or len(code.layers) <= 4 * max(
            1, code.N // (code.Z or code.N)
        ) or len(code.layers) <= 32:
            return code.layers
        colored = color_layers(code)
        return colored if len(colored) < len(code.layers) else code.layers
    raise ValueError(f"unknown schedule {schedule!r}")

"""The batch-sharded decode step: the port's counterpart of
``ldpcgputegra_tpu/parallel/sharded.py``.

Every rank receives the global ``llr[B, N]`` and decodes its own rows
``[r*B/D, (r+1)*B/D)`` with the full one-device decoder
(``decoder.make_decoder``: on the card K1, the gather kernel or K2, as
``auto`` resolves); the (BE, FE) counters are then ``all_reduce(SUM)``
over the ``dp`` group and ``iters_used`` is ``all_reduce(MAX)``: the
collectives that replace the reference's shared-memory
``CErrorAnalyzer::accumulate`` (``CErrorAnalyzer.cpp:87-92``).

Early termination stays local to a rank, as in JAX: a codeword freezes on
its own, so the bits do not depend on how far the vote reaches, and the
maximum of the ranks' ``iters_used`` is the count a global vote would
report.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..codes.code import LdpcCode
from ..ops.layered import LayeredSpec
from .mesh import DecodeMesh, all_reduce, local_batch_size

__all__ = ["make_sharded_decoder", "count_and_reduce"]


def count_and_reduce(bits: torch.Tensor, ref_bits, group):
    """(BE, FE) of ``bits`` [b, N] against ``ref_bits`` (None: the all-zero
    word), summed over ``group``: two 0-d int64 tensors."""
    ref = 0 if ref_bits is None else torch.as_tensor(ref_bits).to(bits.device)
    be_pf = (bits != ref).sum(1)
    counts = torch.stack([be_pf.sum(), (be_pf != 0).sum()])
    all_reduce(counts, group)
    return counts[0], counts[1]


def rows_of(x, rank: int, b: int):
    """Rows ``[rank*b, (rank+1)*b)`` of a global [B, ...] array or tensor."""
    return None if x is None else torch.as_tensor(x)[rank * b:(rank + 1) * b]


def make_sharded_decoder(
    code: LdpcCode,
    spec: LayeredSpec,
    mesh: DecodeMesh,
    count_errors: bool = True,
    backend: str = "auto",
    device=None,
):
    """Build ``step(llr[B, N], ref_bits=None) -> (bits, iters_used, be,
    fe)``, or ``(bits, iters_used)`` without ``count_errors``.

    ``llr`` and ``ref_bits`` are the global batch, the same on every rank;
    ``bits`` are this rank's ``B / D`` rows on ``device`` (default: the
    card); ``iters_used``, ``be`` and ``fe`` are 0-d tensors, the same on
    every rank.  ``ref_bits=None`` counts against the all-zero codeword.
    """
    from ..decoder import default_device, make_decoder

    device = torch.device(device) if device is not None else default_device()
    inner = make_decoder(code, spec, backend=backend, device=device)

    def run(llr, ref_bits: Optional[torch.Tensor] = None):
        b = local_batch_size(len(llr), mesh)
        bits, iters_used = inner(rows_of(llr, mesh.dp_rank, b).to(device))
        iters_used = all_reduce(
            iters_used.to(torch.int32).reshape(()).clone(), mesh.dp_group,
            dist.ReduceOp.MAX)
        if not count_errors:
            return bits, iters_used
        be, fe = count_and_reduce(bits, rows_of(ref_bits, mesh.dp_rank, b),
                                  mesh.dp_group)
        return bits, iters_used, be, fe

    return run

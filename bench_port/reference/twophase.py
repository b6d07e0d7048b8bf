"""Two-phase early termination, plainly: each frame decoded at ``k1``
iterations (no early termination), its hard decision held to every check
of the code (the true syndrome, from the schedule worked out of the raw
matrix file; a pinned phantom edge is no edge of its check), and each
frame that fails decoded again from its LLRs at the full budget.  A frame
that passes keeps its ``k1``-iteration decision; every other frame takes
its full-budget decode.  With early termination off, each frame's decode
depends on its own LLRs alone, so the frames of any set of batches are
decoded together."""

from __future__ import annotations

import dataclasses

import torch

from .codes import Schedule
from .decoder import Fixed, decode


def satisfied(sched: Schedule, bits: torch.Tensor) -> torch.Tensor:
    """``ok[B]`` bool: frame b of ``bits`` [B, N] (0 or 1) satisfies every
    check."""
    ok = torch.ones(bits.shape[0], dtype=torch.bool, device=bits.device)
    for idx, pinned in sched.layers:
        t_idx = torch.as_tensor(idx, device=bits.device)
        par = bits[:, t_idx].to(torch.int32)  # [B, deg, G]
        if pinned is not None:
            par = par.masked_fill(
                torch.as_tensor(pinned, device=bits.device), 0)
        ok &= ~(par.sum(1) & 1).bool().any(1)
    return ok


def decode_twophase(sched: Schedule, llr: torch.Tensor, fx: Fixed,
                    k1: int):
    """``llr`` [B, N] int8 -> (bits [B, N] uint8, unconverged [B] bool):
    phase 1 at ``k1`` iterations, phase 2 at ``fx.iters`` on the frames
    whose phase-1 decision fails a check; ``fx.early_term`` is not used."""
    full = dataclasses.replace(fx, early_term=False)
    bits, _, _ = decode(sched, llr, dataclasses.replace(full, iters=k1))
    bad = ~satisfied(sched, bits)
    rows = torch.nonzero(bad).squeeze(1)
    if rows.numel():
        bits[rows] = decode(sched, llr.index_select(0, rows), full)[0]
    return bits, bad

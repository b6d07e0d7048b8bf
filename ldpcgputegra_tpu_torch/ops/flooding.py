"""Flooding-schedule min-sum decoding in plain PyTorch, any code (the
port's counterpart of ``ldpcgputegra_tpu/ops/flooding.py``).

The JAX decoder is XLA, not a Pallas kernel, so its counterpart here is
PyTorch operations on the decoder's device: per iteration one gather an
edge of the APP array, a check-node reduction per degree class over
``[count, deg, B]`` contributions, and one ``index_add_`` of the new
messages into the variable nodes.  All checks read the previous
iteration's APP, and APP = channel LLR + the sum of a node's incoming
messages.  Flooding converges about 2x slower per iteration than the
layered schedule (``paper/ldpcGpuTegra.tex:200``).

Fixed point as the layered decoders: int16 arithmetic on int8 LLRs,
SAT_VAR / SAT_MSG clamps and the same MS/OMS/NMS/2NMS f(); the messages'
sum into a node is taken in int32 (no int16 sum here can overflow, so it
equals the JAX package's int16 ``segment_sum``).  As in JAX, the first
minimal edge of a check takes f(min2) and every other edge f(min1), where
min2 is the minimum over the other edges (ties keep min2 = min1).

Early termination (JAX ``:105-121``): a codeword whose checks all had
even parity in an iteration's contributions is frozen from the next
iteration on; ``iters_used`` counts the iterations run until every
codeword is frozen or the budget ends.  Here every iteration of the budget
runs, a frozen codeword unchanged, and ``iters_used`` is counted on the
device, so a decode never waits on the host and a CUDA graph can capture
it (``sim/scan.py``); bits and ``iters_used`` equal JAX's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..codes.code import LdpcCode
from .layered import LayeredSpec, _f_consts

__all__ = ["make_flooding_decoder", "flooding_golden"]

_CT = torch.int16
_ST = torch.int8


def _cn_update(c: torch.Tensor, spec: LayeredSpec):
    """Check-node core on [count, deg, B] int16 contributions: (new
    messages [count, deg, B] int16, parity [count, B] int16)."""
    sv, sm = spec.sat_var, spec.sat_msg
    a = c.clamp(-sm, sm).abs() if spec.minclamp == "pre" else c.abs()
    sgn = (c > 0).to(_CT)
    min1 = a.amin(1, keepdim=True)
    ismin = a == min1
    first = ismin & (ismin.cumsum(1) == 1)  # the first minimal edge only
    min2 = a.masked_fill(first, sv + 1).amin(1, keepdim=True)
    parity = sgn.sum(1, keepdim=True, dtype=_CT) & 1
    f1, f2 = _f_consts(min1, min2, spec)
    mag = torch.where(first, f1, f2)
    m = torch.where((parity ^ sgn) == 1, mag, -mag)
    if spec.minclamp == "pre":
        m = m.clamp(-sm, sm)
    return m, parity[:, 0]


def make_flooding_decoder(code: LdpcCode, spec: LayeredSpec = LayeredSpec(),
                          device="cpu"):
    """Build ``decode(llr[B, N] int8) -> (bits[B, N] uint8, iters_used)``
    on ``device``, flooding schedule; ``iters_used`` is a 0-d int32 tensor
    on the device.  ``code`` is decoded in its own column order (a QC view
    is not needed: the schedule has no layers)."""
    device = torch.device(device)
    edge_vn = torch.as_tensor(code.edges.astype(np.int64), device=device)
    shapes = [(c.count, c.deg) for c in code.classes]
    sv = spec.sat_var

    def decode(llr: torch.Tensor):
        if not isinstance(llr, torch.Tensor) or llr.dtype != torch.int8:
            raise TypeError("llr must be an int8 torch tensor")
        if llr.dim() != 2 or llr.shape[1] != code.N:
            raise ValueError(
                f"llr must be [B, {code.N}], got {tuple(llr.shape)}")
        if llr.device.type != device.type or (
            device.index is not None and llr.device.index != device.index
        ):
            raise ValueError(f"llr is on {llr.device}, decoder on {device}")
        B = llr.shape[0]
        V0 = llr.t().to(_CT)  # [N, B] channel LLRs, the unclipped base
        V = V0.clamp(-sv, sv)
        msgs = torch.zeros((code.M, B), dtype=_ST, device=device)
        unsat = torch.ones(B, dtype=torch.bool, device=device)
        used = torch.zeros((), dtype=torch.int32, device=device)
        for _ in range(spec.iters):
            gathered = V[edge_vn]  # [M, B]
            contrib = (gathered - msgs.to(_CT)).clamp(-sv, sv)
            new, unsat_new, off = [], torch.zeros_like(unsat), 0
            for cnt, deg in shapes:
                m, parity = _cn_update(
                    contrib[off:off + cnt * deg].view(cnt, deg, B), spec)
                new.append(m.view(cnt * deg, B))
                unsat_new |= (parity != 0).any(0)
                off += cnt * deg
            m_all = torch.cat(new)  # [M, B] int16
            acc = torch.zeros((code.N, B), dtype=torch.int32, device=device)
            acc.index_add_(0, edge_vn, m_all.to(torch.int32))
            V_new = (V0 + acc).clamp(-sv, sv).to(_CT)
            if spec.early_term:
                used += unsat.any().to(torch.int32)
                V = torch.where(unsat, V_new, V)
                msgs = torch.where(unsat, m_all.to(_ST), msgs)
                unsat = unsat & unsat_new
            else:
                V, msgs = V_new, m_all.to(_ST)
        if not spec.early_term:
            used.fill_(spec.iters)
        bits = (V > 0).to(torch.uint8).t().contiguous()
        return bits, used

    return decode


def flooding_golden(code: LdpcCode, llr: np.ndarray, spec: LayeredSpec):
    """Scalar NumPy flooding oracle of one frame [N] (the JAX package's
    specification of its flooding decoder, copied); int8 bits [N]."""
    from ..golden.decoder import GoldenParams, _f_consts as gf

    sv, sm = spec.sat_var, spec.sat_msg
    gp = GoldenParams(algo=spec.algo, offset=spec.offset, sat_var=sv,
                      sat_msg=sm)
    v0 = llr.astype(np.int64)
    msgs = np.zeros(code.M, np.int64)
    edges = code.edges
    v = np.clip(v0, -sv, sv)
    for _ in range(spec.iters):
        gathered = v[edges]
        new_msgs = np.empty_like(msgs)
        off = 0
        for c in code.classes:
            for _chk in range(c.count):
                sl = slice(off, off + c.deg)
                contrib = np.clip(gathered[sl] - msgs[sl], -sv, sv)
                a = (np.abs(np.clip(contrib, -sm, sm))
                     if spec.minclamp == "pre" else np.abs(contrib))
                sgn = (contrib > 0).astype(np.int64)
                order = np.argsort(a, kind="stable")
                min1, min2 = int(a[order[0]]), int(a[order[1]])
                parity = int(sgn.sum() & 1)
                f1, f2 = gf(min1, min2, gp)
                for j in range(c.deg):
                    mag = f1 if j == order[0] else f2
                    m = mag if parity ^ int(sgn[j]) == 1 else -mag
                    if spec.minclamp == "pre":
                        m = max(-sm, min(sm, m))
                    new_msgs[off + j] = m
                off += c.deg
        msgs = new_msgs
        acc = np.zeros(code.N, np.int64)
        np.add.at(acc, edges, msgs)
        v = np.clip(v0 + acc, -sv, sv)
    return (v > 0).astype(np.int8)

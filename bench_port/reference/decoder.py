"""Layered min-sum over a ``Schedule``, in the fixed point of the
reference decoders (``code/gpu_fixed`` and the x86 oracle): int8 APP and
messages, int16 arithmetic.

For each layer: the contribution ``c = clamp(APP - msg, +-sat_var)`` (a
pinned edge: ``-sat_var``); with ``minclamp`` "pre" the magnitudes are
clamped to ``sat_msg`` first; the two smallest magnitudes give the new
message, OMS ``max(min - offset, 0)`` (min2 for the edges that hold min1,
min1 for the others) with the sign of the other edges' product; then
``APP = clamp(c + msg_new, +-sat_var)``.  A pinned edge writes nothing
and keeps its message.

Early termination: the first iteration always runs; a frame whose checks
were all satisfied as the layers went by (the parity of each check's
contributions) is frozen from then on, and the loop stops when every
frame is, or after ``iters``.  ``iters_used`` is the loop's count; a
frame's own count is the iteration at which it froze.
"""

from __future__ import annotations

import dataclasses

import torch

from .codes import Schedule

_CT = torch.int16
_ST = torch.int8


@dataclasses.dataclass(frozen=True)
class Fixed:
    """The decoder's settings: OMS or MS, iterations, offset, the APP
    (``var_bits``) and message (``msg_bits``) widths."""

    algo: str = "OMS"
    iters: int = 10
    offset: int = 1
    var_bits: int = 8
    msg_bits: int = 6
    minclamp: str = "pre"
    early_term: bool = False

    @property
    def sat_var(self) -> int:
        return (1 << (self.var_bits - 1)) - 1

    @property
    def sat_msg(self) -> int:
        return (1 << (self.msg_bits - 1)) - 1

    @staticmethod
    def of(config: dict, early_term: bool, **override) -> "Fixed":
        keys = ("algo", "iters", "offset", "var_bits", "msg_bits", "minclamp")
        kw = {k: config[k] for k in keys}
        kw.update(override)
        return Fixed(early_term=early_term, **kw)


def _check_update(c: torch.Tensor, fx: Fixed):
    """New messages [deg, G, B] and parity [G, B] from contributions c."""
    sm = fx.sat_msg
    a = c.clamp(-sm, sm).abs() if fx.minclamp == "pre" else c.abs()
    s = (c > 0).to(_CT)
    min1 = a.min(dim=0).values
    # the second smallest, counting a repeated smallest twice
    is_min = a == min1
    first = torch.cumsum(is_min.to(torch.int32), 0) == 1
    min2 = torch.where(is_min & first, fx.sat_var + 1, a).min(dim=0).values
    parity = s.sum(0, dtype=_CT) & 1
    if fx.algo == "OMS":
        f_min = (min2 - fx.offset).clamp(0, sm)
        f_rest = (min1 - fx.offset).clamp(0, sm)
    elif fx.algo == "MS":
        f_min, f_rest = min2.clamp(max=sm), min1.clamp(max=sm)
    else:
        raise ValueError(f"the reference has no {fx.algo!r}")
    mag = torch.where(is_min, f_min, f_rest)
    m = torch.where((parity ^ s) == 1, mag, -mag)
    if fx.minclamp == "pre":
        m = m.clamp(-sm, sm)
    return m, parity


def decode(sched: Schedule, llr: torch.Tensor, fx: Fixed):
    """``llr`` [B, N] int8 -> (bits [B, N] uint8, iters_used, frame_iters
    [B] int32), on ``llr``'s device."""
    dev = llr.device
    sv = fx.sat_var
    V = llr.t().contiguous()  # [N, B]
    B = V.shape[1]
    layers = []
    for idx, pinned in sched.layers:
        t_idx = torch.as_tensor(idx, device=dev)
        t_pin = None if pinned is None else torch.as_tensor(pinned, device=dev)
        keep = None
        if t_pin is not None:
            keep = torch.nonzero(~t_pin.reshape(-1)).squeeze(1)
        layers.append((t_idx, t_pin, keep))
    msgs = [torch.zeros((*idx.shape, B), dtype=_ST, device=dev)
            for idx, _, _ in layers]

    def iteration(active):
        unsat = torch.zeros(B, dtype=torch.bool, device=dev)
        for li, (idx, pin, keep) in enumerate(layers):
            old = V[idx]  # [deg, G, B]
            c = (old.to(_CT) - msgs[li].to(_CT)).clamp(-sv, sv)
            if pin is not None:
                c = c.masked_fill(pin[..., None], -sv)
            m, parity = _check_update(c, fx)
            v_new = (c + m).clamp(-sv, sv).to(_ST)
            m_new = m.to(_ST)
            if active is not None:
                v_new = torch.where(active, v_new, old)
                m_new = torch.where(active, m_new, msgs[li])
            if pin is None:
                V[idx.reshape(-1)] = v_new.reshape(-1, B)
            else:
                m_new = torch.where(pin[..., None], msgs[li], m_new)
                V[idx.reshape(-1)[keep]] = v_new.reshape(-1, B)[keep]
            msgs[li] = m_new
            unsat |= (parity != 0).any(0)
        return unsat

    frame_iters = torch.full((B,), fx.iters, dtype=torch.int32, device=dev)
    if not fx.early_term:
        for _ in range(fx.iters):
            iteration(None)
        used = fx.iters
    else:
        unsat = iteration(None)
        used = 1
        frame_iters[~unsat] = 1
        while used < fx.iters and bool(unsat.any()):
            unsat = unsat & iteration(unsat)
            used += 1
            frame_iters[~unsat & (frame_iters == fx.iters)] = used
    bits = (V > 0).to(torch.uint8).t().contiguous()
    return bits, used, frame_iters

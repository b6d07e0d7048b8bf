"""Batched layered min-sum decoding in plain PyTorch.

The port's counterpart of ``ldpcgputegra_tpu/ops/layered.py``, and the
plain version of the CUDA kernels in ``kernels/layered.py`` (QC codes),
``kernels/gather.py`` (any layers) and ``kernels/streamed.py`` (QC codes
and views beyond shared memory): the CPU tests run it, and
``chip_smoke.py`` holds the kernels against it on the card.

* The APP array is node-major ``[N, B]`` int8; codewords ride the last
  axis.
* Each layer of ``build_layers(code, spec.schedule)`` is one step over all
  of its committed checks at once (``codes/code.py::committed_edges``).
  Those checks touch pairwise-disjoint VNs, so that is bit-identical to
  the reference's sequential check loop.
* A layer's ``[deg, G]`` index tensor holds the VN of edge j of check g.
  For a QC block-row that is ``cols[j]*Z + (shifts[j] + z) % Z`` (the JAX
  path's ``_roll``); for any other layer it is the JAX path's static
  gather (``_layer_step_gather``).  The writeback is an index assignment
  through the same tensor, and the APP array is updated in place, one
  layer at a time.
* QC views of staircase codes (``codes/dvbs2.py::to_qc_form``) decode as
  JAX ``_layer_step_qc`` does: LLRs permuted by ``col_perm`` on the way in
  and bits back on the way out; a sub-pass layer computes and commits only
  its ``commit_rows``, and only their parity counts; the deficient edge's
  contribution is pinned to -sat_var, nothing is written back at it, and
  its message stays 0.
* Early termination freezes each converged codeword: its APP and messages
  stop changing, so its output is its hard decision at the end of the
  first iteration whose on-the-fly parity is all zero.  The loop stops
  once every codeword has converged (one host read of a flag per
  iteration; this version is not on the card's main path).

Arithmetic is int16 on int8-stored state.  Saturation defaults to the
reference's SAT_VAR=127 / SAT_MSG=31 (``constantes_sse.h:43-49``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..codes.code import LdpcCode, committed_edges
from ..codes.schedule import build_layers

__all__ = ["LayeredSpec", "make_layered_decoder", "SAT_VAR", "SAT_MSG",
           "unsupported_reason", "is_qc_view"]

SAT_VAR = 127
SAT_MSG = 31

_CT = torch.int16  # compute dtype
_ST = torch.int8  # storage dtype


@dataclasses.dataclass(frozen=True)
class LayeredSpec:
    """Static decode configuration; same fields and validation as the JAX
    package's ``LayeredSpec``."""

    algo: str = "OMS"  # MS | OMS | NMS | 2NMS
    iters: int = 10
    offset: int = 1
    early_term: bool = False
    minclamp: str = "pre"  # 'pre' = x86 oracle, 'post' = GPU kernels
    schedule: str = "auto"  # reference | colored | auto
    # NMS normalization factors in 1/32 units; nms_f scales min1 (and min2
    # for plain NMS), nms_f2 scales min2 in 2NMS
    nms_f: int = 24
    nms_f2: int = 28
    sat_var: int = SAT_VAR
    sat_msg: int = SAT_MSG

    def __post_init__(self) -> None:
        # APP and messages are stored as int8 on every path
        if not (0 < self.sat_var <= 127):
            raise ValueError(
                f"sat_var={self.sat_var}: accelerated paths store APP as "
                "int8, so var quantizer width is limited to 8 bits "
                "(sat_var <= 127)"
            )
        if not (0 < self.sat_msg <= 127):
            raise ValueError(
                f"sat_msg={self.sat_msg}: accelerated paths store messages "
                "as int8, so msg quantizer width is limited to 8 bits "
                "(sat_msg <= 127)"
            )
        if not (0 < self.nms_f <= 32 and 0 < self.nms_f2 <= 32):
            raise ValueError(
                f"nms_f={self.nms_f}, nms_f2={self.nms_f2}: NMS factors "
                "are 1/32 units in (0, 32] (1.0 max, like the reference's "
                "DIV32 fixed path)"
            )


def _f_consts(min1, min2, spec: LayeredSpec):
    """Message magnitudes (f1 for the min edge, f2 for the rest), the
    integer-exact forms of CUDA_{MS,OMS,NMS,2NMS}_SIMD.cu."""
    if spec.algo == "MS":
        return min2.clamp(max=spec.sat_msg), min1.clamp(max=spec.sat_msg)
    if spec.algo == "OMS":
        return ((min2 - spec.offset).clamp(0, spec.sat_msg),
                (min1 - spec.offset).clamp(0, spec.sat_msg))
    if spec.algo == "NMS":
        return (min2 * spec.nms_f) >> 5, (min1 * spec.nms_f) >> 5
    if spec.algo == "2NMS":
        return (min2 * spec.nms_f2) >> 5, (min1 * spec.nms_f) >> 5
    raise ValueError(f"unknown algo {spec.algo!r}")


def _cn_update(c: torch.Tensor, spec: LayeredSpec):
    """Check-node core on [deg, Z, B] int16 contributions.

    Returns (new messages [deg, Z, B] int16, parity [Z, B] int16); parity
    is the XOR of the contribution signs, 0 when the check is satisfied.
    """
    sm = spec.sat_msg
    a = c.clamp(-sm, sm).abs() if spec.minclamp == "pre" else c.abs()
    s = (c > 0).to(_CT)
    min1 = a[0]
    min2 = torch.full_like(min1, spec.sat_var + 1)
    for j in range(1, c.shape[0]):
        # running two-min, order-identical to CUDA_MS_SIMD.cu:168-170
        min2 = torch.minimum(min2, torch.maximum(a[j], min1))
        min1 = torch.minimum(min1, a[j])
    parity = s.sum(0, dtype=_CT) & 1
    f1, f2 = _f_consts(min1, min2, spec)
    mag = torch.where(a == min1, f1, f2)
    m = torch.where((parity ^ s) == 1, mag, -mag)
    if spec.minclamp == "pre":
        m = m.clamp(-sm, sm)
    return m, parity


def _layer_step(V, msg, idx, spec: LayeredSpec, active=None, pin=None):
    """One layer, in place on V [N, B] int8.

    ``idx`` [deg, G] holds the VN of edge j of check g; ``msg`` is the
    layer's [deg, G, B] int8 messages.  ``active`` ([B] bool, early
    termination) keeps converged codewords unchanged.  ``pin`` is None or
    ``(pinned [deg, G] bool, keep)``: pinned edges contribute -sat_var,
    keep their message and write nothing; ``keep`` indexes the other
    slots of the flattened [deg * G].  Returns the new messages and the
    [G, B] parity.
    """
    sv = spec.sat_var
    rolled = V[idx]  # [deg, G, B]
    c = (rolled.to(_CT) - msg.to(_CT)).clamp(-sv, sv)
    if pin is not None:
        c = c.masked_fill(pin[0][..., None], -sv)
    new_msgs, parity = _cn_update(c, spec)
    v_new = (c + new_msgs).clamp(-sv, sv).to(_ST)
    m_new = new_msgs.to(_ST)
    if active is not None:
        v_new = torch.where(active, v_new, rolled)
        m_new = torch.where(active, m_new, msg)
    v_new = v_new.reshape(-1, V.shape[1])
    if pin is None:
        V[idx.reshape(-1)] = v_new
    else:
        m_new = torch.where(pin[0][..., None], msg, m_new)
        V[idx.reshape(-1)[pin[1]]] = v_new[pin[1]]
    return m_new, parity


def is_qc_view(code: LdpcCode) -> bool:
    """True for a code with ``col_perm``, deficient circulants or sub-pass
    layers (a QC view of a staircase code, ``codes/dvbs2.py``)."""
    return code.col_perm is not None or any(
        lay.qc is not None
        and (lay.qc.mask_edge is not None or lay.qc.commit_rows is not None)
        for lay in code.layers
    )


def unsupported_reason(code: LdpcCode, spec: LayeredSpec):
    """Why the port's layered decoders cannot take this code and schedule;
    None when they can."""
    if spec.schedule == "flooding":
        return ("the flooding schedule has no layers: make_decoder decodes it "
                "with ops/flooding.py")
    if spec.schedule not in ("auto", "reference", "colored"):
        return f"unknown schedule {spec.schedule!r}"
    if spec.schedule == "colored" and is_qc_view(code):
        # colored layers come from class_idx, which still holds the
        # deficient circulant's spurious wrap edge (ROADMAP section 3)
        return (f"{code.name}: the colored schedule of a QC view colors its "
                "class_idx, which holds the deficient circulant's spurious "
                "edge; decode the view in the auto or reference schedule")
    return None


def make_layered_decoder(
    code: LdpcCode,
    spec: LayeredSpec = LayeredSpec(),
    device="cpu",
    node_major: bool = False,
):
    """Build ``decode(llr[B, N] int8) -> (bits[B, N] uint8, iters_used)``
    running on ``device``; ``iters_used`` is a 0-d int32 tensor.  A QC
    view's callers keep the base code's column order.  With ``node_major``
    the LLRs and bits are ``[N, B]`` and the decode skips the transposes
    (JAX ``ops/layered.py::make_layered_decoder``'s option; the caller's
    tensor is copied, never decoded in place)."""
    why = unsupported_reason(code, spec)
    if why is not None:
        raise NotImplementedError(why)
    device = torch.device(device)
    idxs, pins = [], []
    for lay in build_layers(code, spec.schedule):
        idx, pinned = committed_edges(lay)
        idxs.append(torch.as_tensor(idx.T.astype(np.int64), device=device))
        if pinned is None:
            pins.append(None)
        else:
            keep = np.flatnonzero(~pinned.T.ravel())
            pins.append((torch.as_tensor(pinned.T, device=device),
                         torch.as_tensor(keep, device=device)))
    perm = inv_perm = None
    if code.col_perm is not None:
        perm = torch.as_tensor(code.col_perm, dtype=torch.int64, device=device)
        inv_perm = torch.empty_like(perm)
        inv_perm[perm] = torch.arange(code.N, device=device)

    def iteration(V, msgs, active=None):
        unsat = None
        for li, idx in enumerate(idxs):
            msgs[li], parity = _layer_step(V, msgs[li], idx, spec, active,
                                           pins[li])
            lay_unsat = (parity != 0).any(0)  # [B]
            unsat = lay_unsat if unsat is None else (unsat | lay_unsat)
        return unsat

    def decode(llr: torch.Tensor):
        if not isinstance(llr, torch.Tensor) or llr.dtype != torch.int8:
            raise TypeError("llr must be an int8 torch tensor")
        n_axis = 0 if node_major else 1
        if llr.dim() != 2 or llr.shape[n_axis] != code.N:
            want = f"[{code.N}, B]" if node_major else f"[B, {code.N}]"
            raise ValueError(f"llr must be {want}, got {tuple(llr.shape)}")
        if llr.device.type != device.type or (
            device.index is not None and llr.device.index != device.index
        ):
            raise ValueError(f"llr is on {llr.device}, decoder on {device}")
        if node_major:
            # into the view's column order, or a copy the decode may update
            V = (llr[perm] if perm is not None
                 else llr.clone(memory_format=torch.contiguous_format))
        else:
            if perm is not None:
                llr = llr[:, perm]  # into the view's column order
            V = llr.t().contiguous()  # interleave: frame-major -> node-major
        B = V.shape[1]
        msgs = [torch.zeros((*idx.shape, B), dtype=_ST, device=V.device)
                for idx in idxs]
        if not spec.early_term:
            for _ in range(spec.iters):
                iteration(V, msgs)
            used = spec.iters
        else:
            # the first iteration always runs (messages start at zero)
            unsat = iteration(V, msgs)
            used = 1
            while used < spec.iters and bool(unsat.any()):
                unsat = unsat & iteration(V, msgs, active=unsat)
                used += 1
        bits = (V > 0).to(torch.uint8)
        if node_major:
            if inv_perm is not None:
                bits = bits[inv_perm]  # back to the base code's order
        else:
            bits = bits.t()
            if inv_perm is not None:
                bits = bits[:, inv_perm]
        return bits.contiguous(), torch.tensor(used, dtype=torch.int32,
                                               device=V.device)

    return decode

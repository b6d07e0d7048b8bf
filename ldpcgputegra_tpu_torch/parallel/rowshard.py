"""Tanner-graph (block-row) sharding: ONE codeword decoded across ranks.
The port's counterpart of ``ldpcgputegra_tpu/parallel/rowshard.py``.

The reference never splits a codeword; this is the axis SURVEY designs for
the giant DVB-S2 codes, where one codeword's checks are shared out over
the ranks, which exchange APP updates once a layer:

* the APP array ``V [N, B]`` is replicated; each of the D ranks of the
  group owns Z/D rows of every QC block-row (the checks of a block-row
  touch pairwise-disjoint VNs, so the ranks' slices commute);
* a rank computes int32 APP deltas for its rows (0 outside its slice, at
  the deficient circulant's rows, at the rows a sub-pass does not commit,
  and for codewords frozen by early termination), places them in a full
  ``[deg, Z, B]`` slab, and one ``all_reduce(SUM)`` a layer merges the
  disjoint slabs; integer adds, so the result is bit-exact;
* the check-to-variable messages stay local (``[deg, Z/D, B]``);
* early termination: each rank's parities are OR-ed over the layers and
  ``all_reduce(SUM)``-ed into one vote a codeword, once an iteration.

JAX sums the deltas as int16; neither gloo nor NCCL reduces int16, so they
travel as int32 (int8 would overflow).  JAX's layer step is XLA, not a
Pallas kernel, and so is this one: PyTorch operations on the rank's
device, the port's ``ops/layered.py::_cn_update`` for the check nodes.
The bits equal the one-device layered decoder's on the same (QC-view)
schedule (``tests/test_torch_parallel.py``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..codes.code import LdpcCode
from ..codes.schedule import build_layers
from ..ops.layered import LayeredSpec, _cn_update
from .mesh import BATCH_AXIS, TP_AXIS, DecodeMesh, all_reduce, local_batch_size
from .sharded import count_and_reduce, rows_of

__all__ = [
    "make_rowsharded_decoder",
    "make_dp_tp_decoder",
    "rowshard_supported",
]

_CT = torch.int16  # compute dtype
_ST = torch.int8  # storage dtype
_RT = torch.int32  # the dtype the deltas are reduced in


def rowshard_supported(code: LdpcCode, n_devices: int,
                       schedule: str = "auto") -> bool:
    """Every layer of the schedule must be a QC block-row, with Z divisible
    by the number of ranks."""
    from ..decoder import effective_code

    code = effective_code(code)
    if code.Z is None or code.Z % n_devices:
        return False
    return all(l.qc is not None for l in build_layers(code, schedule))


class _Layer:
    """One QC block-row's index tensors for the rank that owns rows
    ``[r0, r0 + zd)`` of it."""

    def __init__(self, layer, Z: int, r0: int, zd: int, device):
        qc = layer.qc
        cols = np.asarray(qc.cols, np.int64)
        shifts = np.asarray(qc.shifts, np.int64)
        self.deg = deg = len(cols)
        z_loc = r0 + np.arange(zd)
        # the VN that edge j of local check z reads: cols[j]*Z + (s_j+z)%Z
        loc = cols[:, None] * Z + (shifts[:, None] + z_loc[None, :]) % Z
        self.loc_idx = torch.as_tensor(loc.ravel(), device=device)
        # row z of the merged delta slab of edge j lands on VN
        # cols[j]*Z + (s_j + z) % Z: gathered back into block-column order
        back = (np.arange(Z)[None, :] - shifts[:, None]) % Z
        back = back + np.arange(deg)[:, None] * Z
        self.back = torch.as_tensor(back.ravel(), device=device)
        ucols, slot = np.unique(cols, return_inverse=True)
        self.ucols = torch.as_tensor(ucols, device=device)
        self.slot = torch.as_tensor(slot.ravel(), device=device)
        self.me = qc.mask_edge
        self.mrow = self.pin_ok = None
        if qc.mask_edge is not None:
            m = np.zeros(Z, bool)
            m[np.asarray(qc.mask_rows, np.int64)] = True
            self.mrow = torch.as_tensor(m[z_loc, None], device=device)
            ok = np.ones((deg, zd, 1), bool)
            ok[qc.mask_edge] = ~m[z_loc, None]
            self.pin_ok = torch.as_tensor(ok, device=device)
        self.cmask = None
        if qc.commit_rows is not None:
            c = np.zeros(Z, bool)
            c[np.asarray(qc.commit_rows, np.int64)] = True
            self.cmask = torch.as_tensor(c[z_loc, None], device=device)


def _layer_step(V, msg, lay: _Layer, spec: LayeredSpec, Z: int, r0: int,
                zd: int, active, group):
    """One QC block-row, this rank's rows: updates ``V`` [N, B] int8 in
    place; returns the new local messages [deg, zd, B] and the local
    parity [zd, B]."""
    sv = spec.sat_var
    B = V.shape[1]
    rolled = V[lay.loc_idx].view(lay.deg, zd, B)
    c = (rolled.to(_CT) - msg.to(_CT)).clamp(-sv, sv)
    if lay.me is not None:
        c[lay.me] = c[lay.me].masked_fill(lay.mrow, -sv)
    new_msgs, parity = _cn_update(c, spec)
    v_new = (c + new_msgs).clamp(-sv, sv)
    m_new = new_msgs.to(_ST)
    allowed = None  # None: every local row commits
    for mask in (None if active is None else active.view(1, 1, B),
                 lay.pin_ok,
                 None if lay.cmask is None else lay.cmask[None]):
        if mask is not None:
            allowed = mask if allowed is None else allowed & mask
    delta = v_new - rolled.to(_CT)
    if allowed is not None:
        delta = torch.where(allowed, delta, 0)
        m_new = torch.where(allowed, m_new, msg)
    # place the local deltas into the full [deg, Z, B] slab and merge over
    # the group: the ranks' rows are disjoint, so the sum is their union
    full = torch.zeros((lay.deg, Z, B), dtype=_RT, device=V.device)
    full[:, r0:r0 + zd] = delta
    all_reduce(full, group)
    # add each edge's deltas into its block-column; a repeated column adds
    # both of its edges' (which touch disjoint VNs)
    back = full.view(lay.deg * Z, B)[lay.back].view(lay.deg, Z, B)
    acc = torch.zeros((len(lay.ucols), Z, B), dtype=_RT, device=V.device)
    acc.index_add_(0, lay.slot, back)
    V3 = V.view(-1, Z, B)
    V3[lay.ucols] = (V3[lay.ucols].to(_RT) + acc).to(_ST)
    if lay.cmask is not None:
        parity = torch.where(lay.cmask, parity, 0)
    return m_new, parity


def _make_local_decode(code: LdpcCode, spec: LayeredSpec, D: int, rank: int,
                       group, device):
    """The decode of one rank that owns Z/D rows of every block-row and
    exchanges deltas over ``group``; ``code`` is already the effective
    (QC-view) code.  ``decode(llr[B, N] int8 on device) -> (bits[B, N]
    uint8, iters_used 0-d int32)``, the same on every rank of the group."""
    # the layer order must be make_layered_decoder's for the same spec:
    # fixed-point layered min-sum depends on the order
    if not rowshard_supported(code, D, spec.schedule):
        raise ValueError(f"{code.name}: not row-shardable over {D} ranks in "
                         f"schedule {spec.schedule!r}")
    Z = code.Z
    zd = Z // D
    r0 = rank * zd
    layers = [_Layer(l, Z, r0, zd, device)
              for l in build_layers(code, spec.schedule)]
    perm = inv_perm = None
    if code.col_perm is not None:
        perm = torch.as_tensor(code.col_perm, dtype=torch.int64, device=device)
        inv_perm = torch.empty_like(perm)
        inv_perm[perm] = torch.arange(code.N, device=device)

    def iteration(V, msgs, active=None):
        unsat = None
        for li, lay in enumerate(layers):
            msgs[li], parity = _layer_step(V, msgs[li], lay, spec, Z, r0, zd,
                                           active, group)
            lay_un = (parity != 0).any(0)
            unsat = lay_un if unsat is None else unsat | lay_un
        # one vote a codeword over the group (the partial syndromes' OR)
        return all_reduce(unsat.to(torch.int32), group) > 0

    def decode(llr: torch.Tensor):
        if llr.dtype != torch.int8 or llr.dim() != 2 or llr.shape[1] != code.N:
            raise ValueError(f"llr must be int8 [B, {code.N}], got "
                             f"{llr.dtype} {tuple(llr.shape)}")
        llr = llr.to(device)
        if perm is not None:
            llr = llr[:, perm]
        V = llr.t().contiguous()
        B = V.shape[1]
        msgs = [torch.zeros((l.deg, zd, B), dtype=_ST, device=device)
                for l in layers]
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
        bits = (V > 0).to(torch.uint8).t()
        if inv_perm is not None:
            bits = bits[:, inv_perm]
        return bits.contiguous(), torch.tensor(used, dtype=torch.int32,
                                               device=device)

    return decode


def make_rowsharded_decoder(code: LdpcCode, spec: LayeredSpec,
                            mesh: DecodeMesh, device=None):
    """``decode(llr[B, N] int8) -> (bits[B, N] uint8, iters_used)`` with
    each codeword's Tanner graph sharded over the whole (1-D) mesh, on
    ``device`` (default: the card).  ``B`` is small (this is the latency
    axis, not the batch axis); every rank returns the same bits."""
    from ..decoder import default_device, effective_code

    # with two axes the group would span one of them while D spanned both,
    # merging a fraction of the row slices: make_dp_tp_decoder takes those
    assert len(mesh.axis_names) == 1, (
        f"make_rowsharded_decoder shards over the WHOLE mesh and requires a "
        f"1-D mesh, got axes {mesh.axis_names}; use make_dp_tp_decoder for "
        f"a (dp, tp) mesh"
    )
    device = torch.device(device) if device is not None else default_device()
    return _make_local_decode(effective_code(code), spec, mesh.dp_size,
                              mesh.dp_rank, mesh.dp_group, device)


def make_dp_tp_decoder(code: LdpcCode, spec: LayeredSpec, mesh: DecodeMesh,
                       count_errors: bool = True, device=None):
    """DP x TP over a 2-D ``(dp, tp)`` mesh (``mesh.decode_mesh_2d``): the
    codeword batch over ``dp``, each codeword's Tanner graph over ``tp``.

    ``step(llr[B, N], ref_bits=None) -> (bits, iters_used[, be, fe])``:
    ``llr`` is the global batch on every rank, ``bits`` this rank's dp
    rows (the same on the ranks of a tp group); ``iters_used`` is the
    maximum over dp, ``be`` / ``fe`` sums over dp only (a sum over tp too
    would count each codeword tp times).
    """
    from ..decoder import default_device, effective_code

    assert mesh.axis_names == (BATCH_AXIS, TP_AXIS), (
        f"mesh must have ({BATCH_AXIS!r}, {TP_AXIS!r}) axes, "
        f"got {mesh.axis_names}"
    )
    device = torch.device(device) if device is not None else default_device()
    local = _make_local_decode(effective_code(code), spec, mesh.tp_size,
                               mesh.tp_rank, mesh.tp_group, device)

    def run(llr, ref_bits=None):
        b = local_batch_size(len(llr), mesh)
        bits, iters_used = local(rows_of(llr, mesh.dp_rank, b))
        all_reduce(iters_used, mesh.dp_group, dist.ReduceOp.MAX)
        if not count_errors:
            return bits, iters_used
        be, fe = count_and_reduce(bits, rows_of(ref_bits, mesh.dp_rank, b),
                                  mesh.dp_group)
        return bits, iters_used, be, fe

    return run

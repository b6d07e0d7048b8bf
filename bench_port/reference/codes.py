"""A code's layered schedule, worked out from its raw matrix file.

A schedule is the sequence of layers that one iteration walks.  A layer is
a group of checks that touch pairwise-disjoint variable nodes, so taking
them together gives what taking them one after another gives.  Each layer
is ``(idx [deg, G] int64, pinned [deg, G] bool or None)``: edge j of check
g reads VN ``idx[j, g]`` in the file's own column order.

* A QC file (``format: qc-base-v1``): one layer a block-row of Z checks,
  in the file's row order; edge j of check z reads
  ``cols[j] * Z + (shifts[j] + z) % Z``.
* A staircase file (DVB-S2; ``.npz`` of flat check-major edges): its Z=360
  QC arrangement.  Row i of the staircase holds parity VNs K+i-1 and K+i.
  With q = M / 360 block-rows, block-row m holds rows m + q*d, d = 0..359,
  in that order; rows m = 0 .. q-1 follow one another.  Row 0 has no
  K-1 partner: it gets a phantom edge whose contribution is pinned to
  -sat_var and which writes nothing (the circulant's missing entry).  A
  block-row whose checks share VNs is split greedily, in check order, into
  groups whose checks do not, each taken in turn.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
from typing import Optional

import numpy as np

Z_DVBS2 = 360


@dataclasses.dataclass(frozen=True)
class Schedule:
    n: int
    k: int
    layers: tuple  # ((idx [deg, G] int64, pinned [deg, G] bool | None), ...)

    @property
    def edge_updates(self) -> int:
        """Edge updates of one iteration over one frame (pinned edges are
        no work)."""
        return int(sum(idx.size - (0 if p is None else int(p.sum()))
                       for idx, p in self.layers))


@functools.lru_cache(maxsize=None)
def load_schedule(path: str) -> Schedule:
    if path.endswith(".json"):
        return _qc_json(path)
    if path.endswith(".npz"):
        return _staircase_npz(path)
    raise ValueError(f"{path}: no schedule for this kind of file")


def _qc_json(path: str) -> Schedule:
    with open(path) as f:
        doc = json.load(f)
    if doc["format"] != "qc-base-v1":
        raise ValueError(f"{path}: unknown format {doc['format']!r}")
    z = int(doc["Z"])
    zz = np.arange(z, dtype=np.int64)[None, :]
    layers = []
    for r in doc["rows"]:
        cols = np.asarray(r["cols"], np.int64)[:, None]
        shifts = np.asarray(r["shifts"], np.int64)[:, None]
        layers.append((cols * z + (shifts + zz) % z, None))
    m = z * len(layers)
    return Schedule(int(doc["N"]), int(doc["N"]) - m, tuple(layers))


def _staircase_npz(path: str, z: int = Z_DVBS2) -> Schedule:
    d = np.load(path)
    n = int(d["N"])
    edges = d["edges"].astype(np.int64)
    checks = []
    pos = 0
    for deg, count in d["classes"]:
        block = edges[pos: pos + int(deg) * int(count)].reshape(int(count), int(deg))
        checks.extend(block)
        pos += int(deg) * int(count)
    m_checks = len(checks)
    k = n - m_checks
    rows: list[Optional[np.ndarray]] = [None] * m_checks
    for vns in checks:
        par = np.sort(vns[vns >= k]) - k
        if par.size == 1 and par[0] == 0:
            r = 0
        elif par.size == 2 and par[1] == par[0] + 1:
            r = int(par[1])
        else:
            raise ValueError(f"{path}: not a staircase code")
        if rows[r] is not None:
            raise ValueError(f"{path}: two checks claim staircase row {r}")
        rows[r] = np.sort(vns)
    if m_checks % z:
        raise ValueError(f"{path}: {m_checks} checks are not a multiple of {z}")
    q = m_checks // z
    phantom = k + m_checks - 1  # the wrap entry's column; never written
    layers = []
    for m in range(q):
        members = [rows[m + q * dd] for dd in range(z)]
        deg = max(v.size for v in members)
        idx = np.empty((deg, z), np.int64)
        pinned = np.zeros((deg, z), bool)
        for dd, vns in enumerate(members):
            if vns.size == deg - 1 and m + q * dd == 0:
                idx[:, dd] = np.append(vns, phantom)
                pinned[deg - 1, dd] = True
            elif vns.size == deg:
                idx[:, dd] = vns
            else:
                raise ValueError(f"{path}: block-row {m} mixes check degrees")
        for grp in _disjoint_groups(idx):
            layers.append((idx[:, grp],
                           pinned[:, grp] if pinned[:, grp].any() else None))
    return Schedule(n, k, tuple(layers))


def _disjoint_groups(idx: np.ndarray) -> list[np.ndarray]:
    """Checks 0..G-1 of ``idx`` [deg, G], in order, each into the first
    group none of whose checks shares a VN with it."""
    groups: list[list[int]] = []
    seen: list[set] = []
    for g in range(idx.shape[1]):
        vns = set(idx[:, g].tolist())
        for members, used in zip(groups, seen):
            if not (vns & used):
                members.append(g)
                used |= vns
                break
        else:
            groups.append([g])
            seen.append(set(vns))
    return [np.asarray(gr, np.int64) for gr in groups]


def schedule_for(config: dict, root: str) -> Schedule:
    """The schedule of a configuration file's code (``code_file``, relative
    to the checkout's root)."""
    return load_schedule(os.path.join(root, config["code_file"]))

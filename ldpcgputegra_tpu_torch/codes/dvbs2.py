"""QC-ification of DVB-S2-family staircase codes (the port's copy of
``ldpcgputegra_tpu/codes/dvbs2.py``; importing that module would load jax).

The reference stores DVB-S2 H matrices in natural (staircase) row order
(``code/gpu_fixed/matrix/64800x32400``), where consecutive checks share a
parity VN — the layered schedule degenerates to one-check layers and no
cyclic structure is visible.  But every DVB-S2 code IS quasi-cyclic with
circulant size Z=360 under the standard q-permutation (q = M/360):

* rows:            r      -> (r mod q)*Z + (r div q)
* parity columns:  K + c  -> K + (c mod q)*Z + (c div q)
* info columns:    unchanged (already grouped in 360s by construction)

An info bit in group g, offset t scatters to rows ``(p + t*q) mod M``
(``GenericEncoder.cpp:63-66``); writing p = q*a + m gives permuted row
``m*Z + (a + t) mod Z`` — block-row m, cyclic shift a: a circulant.  The
staircase pair (p_{r-1}, p_r) becomes a shift-0 diagonal plus a link to
the previous parity block; the single wrap entry of that link at
block-row 0, check 0 corresponds to the nonexistent p_{-1} — a *deficient
circulant*, ``QCRow.mask_edge/mask_rows`` (decoders neutralize it; see
codes/code.py).

The view carries ``col_perm`` so decoders permute LLRs in and bits out;
its layered schedule is q block-row layers of Z parallel checks, split
into sub-pass layers (``commit_rows``) where a block-row repeats a
block-column.  ``decoder/__init__.py::effective_code`` picks the view.
``_check_rows_in_parity_order`` is copied from
``ldpcgputegra_tpu/channel/encoder.py``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .code import DegreeClass, Layer, LdpcCode, QCRow

__all__ = ["is_staircase", "to_qc_form"]

_Z = 360


def _check_rows_in_parity_order(code: LdpcCode) -> Optional[list[np.ndarray]]:
    """Recover original staircase row order from parity-column membership.

    In a dual-diagonal (staircase) code, original check row ``i`` contains
    parity VNs {K+i-1, K+i} (row 0: just {K}).  Degree-class sorting loses
    row order; this maps each check back, returning for each original row
    the index arrays of its *info* VNs, or None if the code isn't staircase.
    """
    K, M = code.K, code.n_checks
    rows_info: list[Optional[np.ndarray]] = [None] * M
    for ci in code.class_idx:
        for c in range(ci.shape[0]):
            vns = ci[c]
            par = np.sort(vns[vns >= K]) - K
            info = vns[vns < K]
            if par.size == 1 and par[0] == 0:
                row = 0
            elif par.size == 2 and par[1] == par[0] + 1:
                row = int(par[1])
            else:
                return None
            if rows_info[row] is not None:
                return None
            rows_info[row] = info
    if any(r is None for r in rows_info):
        return None
    return rows_info  # type: ignore[return-value]


def is_staircase(code: LdpcCode) -> bool:
    return _check_rows_in_parity_order(code) is not None


def _conflict_groups(cols: np.ndarray, shifts: np.ndarray, z: int):
    """Partition checks 0..z-1 so no group contains a conflicting pair.

    Conflict distances: for every repeated block-column with shifts s1, s2,
    checks z0 and z0 + (s1 - s2) share a VN.  Greedy assignment over the
    circulant conflict graph; returns [np.ndarray] of sorted check ids
    (a single full group when conflict-free).
    """
    dists = set()
    by_col: dict[int, list[int]] = {}
    for j, c in enumerate(cols.tolist()):
        by_col.setdefault(c, []).append(j)
    for js in by_col.values():
        for a in range(len(js)):
            for b in range(a + 1, len(js)):
                d = int(shifts[js[a]] - shifts[js[b]]) % z
                dists.add(d)
                dists.add((-d) % z)
    dists.discard(0)
    if not dists:
        return [np.arange(z, dtype=np.int64)]
    groups: list[set[int]] = []
    for zz in range(z):
        for g in groups:
            if all(((zz - other) % z) not in dists for other in g):
                g.add(zz)
                break
        else:
            groups.append({zz})
    return [np.asarray(sorted(g), np.int64) for g in groups]


def to_qc_form(code: LdpcCode, z: int = _Z) -> LdpcCode:
    """Build the Z=360 QC view of a staircase code.

    Raises ValueError if the code is not staircase or not QC under the
    q-permutation (i.e. not DVB-S2-family).
    """
    rows_info = _check_rows_in_parity_order(code)
    if rows_info is None:
        raise ValueError(f"{code.name}: not a staircase code")
    K, M, N = code.K, code.n_checks, code.N
    if M % z:
        raise ValueError(f"{code.name}: M={M} not divisible by Z={z}")
    q = M // z

    # column permutation: new index -> old index; new parity position
    # (c mod q)*z + (c div q) holds old parity c
    old_of_new = np.arange(N, dtype=np.int64)
    c = np.arange(M, dtype=np.int64)
    old_of_new[K + (c % q) * z + (c // q)] = K + c
    new_of_old = np.empty(N, dtype=np.int64)
    new_of_old[old_of_new] = np.arange(N, dtype=np.int64)

    # per permuted block-row, collect checks in permuted-column space
    layers: list[Layer] = []
    classes: list[DegreeClass] = []
    class_idx: list[np.ndarray] = []
    edge_offset = 0
    for m in range(q):
        # block-row m holds original rows r = m + q*d for d in 0..z-1
        checks = []
        for d in range(z):
            r = m + q * d
            vns = set(int(new_of_old[v]) for v in rows_info[r])
            vns.add(int(new_of_old[K + r]))  # diagonal parity p_r
            if r > 0:
                vns.add(int(new_of_old[K + r - 1]))
            checks.append(vns)
        # infer circulant structure from check d=0 (plus the wrap edge)
        deg = max(len(s) for s in checks)
        base = checks[0]
        cols_shifts = [divmod(v, z) for v in sorted(base)]
        mask_edge = None
        if len(base) == deg - 1:
            # deficient circulant: the p_{-1} wrap at check 0 (block-row 0).
            # Its edge is (previous parity block q-1 in permuted space,
            # shift z-1): check d reads pos (z-1+d) mod z == d-1, i.e.
            # p_{q*d-1} — correct for d>=1, spurious for d=0.
            prev_block = (K // z) + q - 1
            cols_shifts.append((prev_block, z - 1))
            cols_shifts.sort()
            mask_edge = cols_shifts.index((prev_block, z - 1))
        cols = np.asarray([c0 for c0, _ in cols_shifts], np.int32)
        shifts = np.asarray([s0 for _, s0 in cols_shifts], np.int32)
        # a repeated block-column makes checks z and z + (s_j1 - s_j2)
        # touch the same VN: such a block-row is split into masked sub-pass
        # layers (QCRow.commit_rows) of mutually conflict-free checks
        groups = _conflict_groups(cols, shifts, z)
        # validate: every check d must match the circulant prediction
        zz = np.arange(z, dtype=np.int64)[:, None]
        idx = cols[None, :] * z + (shifts[None, :] + zz) % z
        for d in range(z):
            expect = set(int(v) for v in idx[d])
            if mask_edge is not None and d == 0:
                expect.discard(int(idx[0, mask_edge]))
            if expect != checks[d]:
                raise ValueError(
                    f"{code.name}: block-row {m} check {d} breaks QC "
                    f"structure (not DVB-S2-family?)"
                )
        mask_rows = (
            np.asarray([0], np.int64) if mask_edge is not None else None
        )
        for grp in groups:
            qc = QCRow(
                cols=cols,
                shifts=shifts,
                mask_edge=mask_edge,
                mask_rows=mask_rows,
                commit_rows=None if len(groups) == 1 else grp,
            )
            layers.append(
                Layer(idx=idx.astype(np.int32), edge_offset=edge_offset, qc=qc)
            )
        classes.append(DegreeClass(deg, z))
        class_idx.append(idx.astype(np.int32))
        edge_offset += idx.size

    return LdpcCode(
        name=code.name + "-qc",
        N=N,
        K=K,
        classes=tuple(classes),
        class_idx=tuple(class_idx),
        Z=z,
        layers=tuple(layers),
        col_perm=old_of_new,
    )

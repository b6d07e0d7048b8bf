"""Runtime code registry (the port's counterpart of
``ldpcgputegra_tpu/codes/registry.py``).

The code definitions are read from the JAX package's data directory,
``ldpcgputegra_tpu/codes/data/``, by path, so both packages share one copy
of every matrix.  Reading a data file imports nothing from that package.
"""

from __future__ import annotations

import functools
import json
import os
import re
from typing import Optional

import numpy as np

from .code import DegreeClass, LdpcCode

DATA_DIR = os.path.normpath(os.path.join(
    os.path.dirname(__file__), "..", "..", "ldpcgputegra_tpu", "codes", "data"
))

__all__ = ["DATA_DIR", "list_codes", "load_code", "make_qc_code",
           "make_random_qc_code", "make_random_regular_code"]


def list_codes() -> list[str]:
    names = []
    for fn in sorted(os.listdir(DATA_DIR)):
        base, ext = os.path.splitext(fn)
        if ext in (".json", ".npz") and not base.startswith("encoder"):
            names.append(base)
    return names


def _load_qc_json(path: str) -> LdpcCode:
    with open(path) as f:
        doc = json.load(f)
    if doc["format"] != "qc-base-v1":
        raise ValueError(f"{path}: unknown format {doc['format']!r}")
    Z = doc["Z"]
    classes = tuple(DegreeClass(d, c) for d, c in doc["classes"])
    rows = iter(doc["rows"])
    # rows are stored in reference schedule order; degree classes are
    # contiguous runs of rows
    class_idx = []
    z = np.arange(Z, dtype=np.int64)[:, None]
    for dc in classes:
        if dc.count % Z:
            raise ValueError(f"{path}: class size {dc.count} not a multiple of Z")
        blocks = []
        for _ in range(dc.count // Z):
            r = next(rows)
            cols = np.asarray(r["cols"], dtype=np.int64)
            shifts = np.asarray(r["shifts"], dtype=np.int64)
            blocks.append(cols[None, :] * Z + (shifts[None, :] + z) % Z)
        class_idx.append(np.concatenate(blocks, axis=0).astype(np.int32))
    n_checks = sum(dc.count for dc in classes)
    return LdpcCode(
        name=doc["name"],
        N=doc["N"],
        # stored "K" is the reference's check count; the info length is
        # N - checks (CTrame.cpp:65-67)
        K=doc["N"] - n_checks,
        classes=classes,
        class_idx=tuple(class_idx),
        Z=Z,
    )


def _load_npz(path: str, name: str) -> LdpcCode:
    d = np.load(path)
    classes = [(int(a), int(b)) for a, b in d["classes"]]
    return LdpcCode.from_edges(
        name, int(d["N"]), None, classes, d["edges"],
        detect_qc=bool(int(d["Z"])),
    )


@functools.lru_cache(maxsize=None)
def load_code(name: str) -> LdpcCode:
    """Load a named code: a registry name ("1944x972"), a path to a
    .json/.npz/.alist file, or ``synthqc-<nbcols>x<nbrows>x<deg>-z<Z>[-s<seed>]``."""
    if name.startswith("synthqc-"):
        m = re.match(r"synthqc-(\d+)x(\d+)x(\d+)-z(\d+)(?:-s(\d+))?$", name)
        if not m:
            raise KeyError(f"bad synthetic QC code name {name!r}")
        nc, nr, deg, z, seed = (int(g) if g else 0 for g in m.groups())
        return make_random_qc_code(nc, nr, deg, z, seed, name=name)
    if os.path.sep in name or name.endswith((".json", ".npz", ".alist")):
        path = name
        base = os.path.splitext(os.path.basename(name))[0]
    else:
        base = name
        for ext in (".json", ".npz"):
            path = os.path.join(DATA_DIR, name + ext)
            if os.path.exists(path):
                break
        else:
            raise KeyError(f"unknown code {name!r}; available: {list_codes()}")
    if path.endswith(".json"):
        return _load_qc_json(path)
    if path.endswith(".alist"):
        from .alist import load_alist

        return load_alist(path)
    return _load_npz(path, base)


def make_qc_code(
    name: str,
    base: np.ndarray,
    Z: int,
    K: Optional[int] = None,
) -> LdpcCode:
    """Expand a QC base matrix ([rows, cols], -1 for absent blocks, else
    the cyclic shift) into an LdpcCode.  Rows are emitted in
    descending-degree order grouped into degree classes."""
    base = np.asarray(base)
    n_rows, n_cols = base.shape
    N = n_cols * Z
    K = K if K is not None else N - n_rows * Z
    rows = []
    for r in range(n_rows):
        cols = np.nonzero(base[r] >= 0)[0]
        shifts = base[r][cols] % Z
        rows.append((cols.astype(np.int64), shifts.astype(np.int64)))
    rows.sort(key=lambda cs: -len(cs[0]))
    z = np.arange(Z, dtype=np.int64)[:, None]
    by_deg: dict[int, list[np.ndarray]] = {}
    for cols, shifts in rows:
        blk = cols[None, :] * Z + (shifts[None, :] + z) % Z
        by_deg.setdefault(len(cols), []).append(blk)
    classes = []
    class_idx = []
    for deg in sorted(by_deg, reverse=True):
        blocks = np.concatenate(by_deg[deg], axis=0).astype(np.int32)
        classes.append(DegreeClass(deg, blocks.shape[0]))
        class_idx.append(blocks)
    return LdpcCode(
        name=name, N=N, K=K, classes=tuple(classes),
        class_idx=tuple(class_idx), Z=Z,
    )


def make_random_regular_code(
    N: int, K: int, deg: int, seed: int = 0, name: Optional[str] = None
) -> LdpcCode:
    """Random (deg_v, deg_c)-regular Gallager-style code (no QC structure),
    by random edge permutation with collision repair.  Same draws as the
    JAX package's generator, so one seed gives one code in both."""
    n_checks = N - K
    M = n_checks * deg
    assert M % N == 0, "variable degree must be integral"
    dv = M // N
    rng = np.random.default_rng(seed)
    stubs = np.repeat(np.arange(N, dtype=np.int32), dv)
    rng.shuffle(stubs)
    idx = stubs.reshape(n_checks, deg)
    # repair duplicate VNs within a check by swapping with random other rows
    for _ in range(100 * n_checks):
        bad = [c for c in range(n_checks) if np.unique(idx[c]).size < deg]
        if not bad:
            return LdpcCode.from_edges(
                name or f"rand{N}x{K}d{deg}s{seed}", N, K,
                [(deg, n_checks)], idx.ravel(), detect_qc=False,
            )
        for c in bad:
            vals, counts = np.unique(idx[c], return_counts=True)
            dup = vals[counts > 1][0]
            j = int(np.nonzero(idx[c] == dup)[0][0])
            c2 = int(rng.integers(n_checks))
            j2 = int(rng.integers(deg))
            if idx[c2, j2] not in idx[c] and dup not in np.delete(idx[c2], j2):
                idx[c, j], idx[c2, j2] = idx[c2, j2], idx[c, j]
    raise RuntimeError("failed to sample a simple regular code")


def make_random_qc_code(
    nb_cols: int, nb_rows: int, deg: int, Z: int, seed: int = 0,
    name: Optional[str] = None,
) -> LdpcCode:
    """Random QC-LDPC code (each block-row: ``deg`` distinct block-columns,
    random shifts), the ``synthqc-*`` family.  Same draws as the JAX
    package's generator, so one name gives one code in both."""
    rng = np.random.default_rng(seed)
    base = np.full((nb_rows, nb_cols), -1, dtype=np.int64)
    for r in range(nb_rows):
        cols = rng.choice(nb_cols, size=deg, replace=False)
        base[r, cols] = rng.integers(0, Z, size=deg)
    # every block-column used at least once (the decode touches all VNs)
    unused = np.nonzero((base >= 0).sum(axis=0) == 0)[0]
    for c in unused:
        r = int(rng.integers(nb_rows))
        base[r, c] = int(rng.integers(Z))
    return make_qc_code(
        name or f"synthqc-{nb_cols}x{nb_rows}x{deg}-z{Z}", base, Z
    )

"""MacKay ``alist`` parity-check matrix loader (the port's copy of
``ldpcgputegra_tpu/codes/alist.py``).

The standard interchange format the reference never supported (its matrices
are compiled C headers); here any alist file loads at runtime into an
`LdpcCode`, grouped into degree classes in descending-degree order (the
reference's DEG_1/DEG_2 convention, ``constantes_gpu.h:17-22``) so the
same decoders apply.
"""

from __future__ import annotations

import os

import numpy as np

from .code import DegreeClass, LdpcCode, detect_Z

__all__ = ["load_alist", "save_alist"]


def load_alist(path: str, name: str | None = None) -> LdpcCode:
    with open(path) as f:
        tok = f.read().split()
    it = iter(tok)

    def nxt() -> int:
        return int(next(it))

    n, m = nxt(), nxt()
    max_dv, max_dc = nxt(), nxt()
    dv = [nxt() for _ in range(n)]
    dc = [nxt() for _ in range(m)]
    # variable-node adjacency (skipped; check lists are authoritative)
    for i in range(n):
        for _ in range(max_dv):
            v = nxt()
            del v
    rows: list[np.ndarray] = []
    for c in range(m):
        vs = []
        for _ in range(max_dc):
            v = nxt()
            if v > 0:
                vs.append(v - 1)  # alist is 1-based
        if len(vs) != dc[c]:
            raise ValueError(f"{path}: check {c}: degree mismatch")
        rows.append(np.asarray(vs, dtype=np.int32))
    del dv, max_dv
    # group into degree classes, descending degree, preserving row order
    by_deg: dict[int, list[np.ndarray]] = {}
    for r in rows:
        by_deg.setdefault(r.size, []).append(r)
    classes = []
    class_idx = []
    for deg in sorted(by_deg, reverse=True):
        blk = np.stack(by_deg[deg]).astype(np.int32)
        classes.append(DegreeClass(deg, blk.shape[0]))
        class_idx.append(blk)
    return LdpcCode(
        name=name or os.path.splitext(os.path.basename(path))[0],
        N=n,
        K=n - m,
        classes=tuple(classes),
        class_idx=tuple(class_idx),
        Z=detect_Z(class_idx, n) if class_idx else None,
    )


def save_alist(code: LdpcCode, path: str) -> None:
    """Write the code out as alist (for interop round-trips)."""
    n, m = code.N, code.n_checks
    cols: list[list[int]] = [[] for _ in range(n)]
    rows: list[list[int]] = []
    for ci in code.class_idx:
        for r in range(ci.shape[0]):
            rows.append([int(v) for v in ci[r]])
            for v in ci[r]:
                cols[int(v)].append(len(rows))
    max_dv = max(len(c) for c in cols)
    max_dc = max(len(r) for r in rows)
    with open(path, "w") as f:
        f.write(f"{n} {m}\n{max_dv} {max_dc}\n")
        f.write(" ".join(str(len(c)) for c in cols) + "\n")
        f.write(" ".join(str(len(r)) for r in rows) + "\n")
        for c in cols:
            pad = c + [0] * (max_dv - len(c))
            f.write(" ".join(str(x) for x in pad) + "\n")
        for r in rows:
            pad = [v + 1 for v in r] + [0] * (max_dc - len(r))
            f.write(" ".join(str(x) for x in pad) + "\n")

"""The 16200x10800 parity-check matrix, derived and checked:
``tools/derive_encoder_matrix.py`` as a check, not a writer.

    python -m ldpcgputegra_tpu_torch.bench.encoder_matrix_check
        [--table PATH] [--npz PATH] [--device cpu]

The reference ships the DVB accumulate encoder's table for N=16200,
K=10800 but no parity-check matrix; the accumulator defines one: check r
holds every info bit whose table line scatters to r, and the staircase
pair (p_{r-1}, p_r).  This derives it from ``--table`` (default the JAX
package's ``codes/data/encoder_16200x10800.json``, read by path) into an
``LdpcCode`` (``codes/code.py::LdpcCode.from_edges``), encodes 4 frames
of ``default_rng(1)`` info bits with the port's ``QCAccumulateEncoder``
on ``--device`` (the card by default), requires every frame to satisfy
every check, and compares ``N``, ``K`` (the check count, as the registry
stores it), ``classes`` and ``edges`` with the committed ``--npz``
(default ``codes/data/16200x10800.npz``).  It exits non-zero on the first
difference and writes nothing.  Without a card it exits non-zero, unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from collections import defaultdict

import numpy as np
import torch

from ..channel.encoder import QCAccumulateEncoder
from ..codes.code import LdpcCode
from ..codes.registry import DATA_DIR
from ..golden.decoder import syndrome_ok

__all__ = ["derive", "check", "main", "TABLE", "NPZ"]

TABLE = os.path.join(DATA_DIR, "encoder_16200x10800.json")
NPZ = os.path.join(DATA_DIR, "16200x10800.npz")


def derive(table_path: str) -> tuple[LdpcCode, dict]:
    """The code the encoder table at ``table_path`` implies, and the
    table; its checks grouped by degree, the highest first."""
    with open(table_path) as f:
        doc = json.load(f)
    N, K, Q, M360 = doc["N"], doc["K"], doc["Q"], doc["M"]
    nmk = N - K
    rows_info: list[list[int]] = [[] for _ in range(nmk)]
    for g, line in enumerate(doc["rows"]):
        p = np.asarray(line, dtype=np.int64)
        for t in range(M360):
            for r in (p + t * Q) % nmk:
                rows_info[int(r)].append(g * M360 + t)
    by_deg = defaultdict(list)
    for r in range(nmk):
        vns = sorted(set(rows_info[r])) + ([K + r - 1] if r > 0 else [])
        by_deg[len(vns) + 1].append(np.asarray(sorted(vns + [K + r]),
                                               dtype=np.int32))
    classes = [(deg, len(by_deg[deg])) for deg in sorted(by_deg, reverse=True)]
    edges = np.concatenate([np.stack(by_deg[deg]).ravel()
                            for deg, _ in classes])
    code = LdpcCode.from_edges(f"{N}x{K}", N, None, classes, edges,
                               detect_qc=False)
    if code.K != K:
        raise SystemExit(f"encoder_matrix_check: the table's K {K} is not N "
                         f"minus its {code.n_checks} checks")
    return code, doc


def check(table_path: str = TABLE, npz_path: str = NPZ, device="cuda",
          log=print) -> None:
    """Derive, encode 4 frames on ``device``, check every frame against
    every check, compare with the committed npz; ``SystemExit`` names the
    first difference."""
    code, doc = derive(table_path)
    enc = QCAccumulateEncoder(doc["N"], doc["K"], doc["Q"], doc["M"],
                              doc["rows"])
    info = np.random.default_rng(1).integers(0, 2, size=(4, code.K)).astype(
        np.int8)
    coded = enc.encode(torch.from_numpy(info).to(device)).cpu().numpy()
    for b, frame in enumerate(coded):
        if not syndrome_ok(code, frame):
            raise SystemExit(f"encoder_matrix_check: encoded frame {b} fails "
                             "a check of the derived matrix")
    derived = {"N": code.N, "K": code.n_checks, "classes": np.asarray(
        [(c.deg, c.count) for c in code.classes]), "edges": code.edges}
    with np.load(npz_path) as ref:
        for key, value in derived.items():
            if not np.array_equal(value, ref[key]):
                raise SystemExit(f"encoder_matrix_check: {key} of the derived "
                                 f"matrix differs from {npz_path}")
    log(f"[encoder_matrix_check] {code.name}: M={code.M} checks="
        f"{code.n_checks}; 4 frames encoded on {device} satisfy every check; "
        f"N, K, classes and edges equal {os.path.basename(npz_path)}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--table", default=TABLE)
    ap.add_argument("--npz", default=NPZ)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device != "cpu" and not torch.cuda.is_available():
        print("encoder_matrix_check: no CUDA device", file=sys.stderr)
        return 1
    check(args.table, args.npz, torch.device(args.device))
    return 0


if __name__ == "__main__":
    sys.exit(main())

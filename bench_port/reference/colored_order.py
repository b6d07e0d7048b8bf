"""The check order of the paper's (4000,2000) code, coloured, written as a
``qc-base-v1`` file with Z = 1 that ``codes.load_schedule`` reads.

The raw matrix file (``ldpcgputegra_tpu/codes/data/4000x2000.npz``) is
neither QC nor a staircase: its checks in file order give 123 runs of
checks with disjoint VNs.  A decoder takes them in colour classes
instead: groups of checks no two of which share a VN.  Layered min-sum in
such a group gives what the same checks one after another give, so a
schedule of colour classes is serial layered decoding in a permuted check
order, and a file that lists the checks one a row (Z = 1: each check its
own block-row, ``cols`` its VNs, ``shifts`` 0) in that order gives the
reference the same decode, one check a layer.

The rule, for each degree class in file order (a layer holds checks of one
degree, so each class opens its own layers), each check of the class in
file order: the check goes into the open layer, none of whose checks
shares a VN with it, that has the fewest checks, the earliest of those on
a tie; where no open layer qualifies it opens a new one.  The layers are
listed in the order they were opened, each layer's checks in the order
they came.  ``layers`` in the file gives each layer's size.

    python3 bench_port/reference/colored_order.py   # writes the file

Reads the matrix file as data; imports nothing of the program.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
MATRIX = "ldpcgputegra_tpu/codes/data/4000x2000.npz"
ORDER = "bench_port/reference/data/paper_4000x2000.order.json"


def checks_by_class(d) -> list:
    """Each degree class's checks in the loaded matrix file ``d``, in file
    order: [count, deg] int64."""
    edges = d["edges"].astype(np.int64)
    out, pos = [], 0
    for deg, count in d["classes"]:
        size = int(deg) * int(count)
        out.append(edges[pos: pos + size].reshape(int(count), int(deg)))
        pos += size
    if pos != edges.size:
        raise ValueError(f"the classes cover {pos} of {edges.size} edges")
    return out


def color(classes: list) -> list:
    """The layers by the rule: a list of layers, each a list of checks
    (each a 1-D array of VNs)."""
    layers = []
    for checks in classes:
        members: list = []
        used: list = []
        for row in checks:
            vns = set(row.tolist())
            best = None
            for i, u in enumerate(used):
                if u.isdisjoint(vns) and (
                        best is None or len(members[i]) < len(members[best])):
                    best = i
            if best is None:
                members.append([])
                used.append(set())
                best = len(members) - 1
            members[best].append(row)
            used[best] |= vns
        layers.extend(members)
    return layers


def document(root: str = ROOT) -> dict:
    """The order file's content for the matrix under ``root``."""
    d = np.load(os.path.join(root, MATRIX))
    layers = color(checks_by_class(d))
    rows = [row for layer in layers for row in layer]
    return {"format": "qc-base-v1", "name": "4000x2000",
            "N": int(d["N"]), "K": int(d["K"]), "Z": 1,
            "source": MATRIX, "layers": [len(layer) for layer in layers],
            "rows": [{"cols": row.tolist(), "shifts": [0] * row.size}
                     for row in rows]}


def dumps(doc: dict) -> str:
    """The file's text: the header on the first line, one row a line."""
    head = {k: v for k, v in doc.items() if k != "rows"}
    lines = [json.dumps(r, separators=(",", ":")) for r in doc["rows"]]
    return (json.dumps(head)[:-1] + ', "rows": [\n'
            + ",\n".join(lines) + "\n]}\n")


def main() -> int:
    doc = document()
    path = os.path.join(ROOT, ORDER)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(dumps(doc))
    print(f"{ORDER}: {len(doc['rows'])} checks in "
          f"{len(doc['layers'])} layers")
    return 0


if __name__ == "__main__":
    sys.exit(main())

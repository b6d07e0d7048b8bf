"""``dryrun_multichip``: the port's counterpart of
``__graft_entry__.py::dryrun_multichip``, and the rank function that runs
a list of decode cases on a group (``decode_cases``, which the tests and
``chip_smoke.py`` drive through ``launch.run_ranks``).

    python -m ldpcgputegra_tpu_torch.parallel.dryrun 4 [--device cpu]

starts n gloo ranks on this machine (all on the card, or on the CPU with
``--device cpu``) and runs on each: the batch-sharded step at 576x288
(its counters against the one-rank decode's), the row-sharded decode of
two codewords bit-exact against the one-rank decode, and the largest
``dp x tp`` mesh with dp > 1, bit-exact.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional

import numpy as np
import torch

from ..codes.registry import load_code
from ..ops.layered import LayeredSpec
from .launch import run_ranks
from .mesh import decode_mesh, decode_mesh_2d

__all__ = ["dryrun_multichip", "decode_cases"]


def decode_cases(rank: int, cases: list, device: str) -> list:
    """Run each case on this rank; returns, for each, a dict of the rank's
    ``bits`` (numpy) and the ``iters``, ``be`` and ``fe`` ints (``be`` and
    ``fe`` None where the step does not count).

    A case is a dict: ``kind`` ("sharded", "rowshard" or "dp_tp"),
    ``code`` (a registry name), ``spec`` (a ``LayeredSpec``), ``llr``
    (the global [B, N] int8 batch), and for "dp_tp" ``dp`` and ``tp``;
    optional ``ref_bits``.  Every rank
    of the world runs every case: "sharded" and "rowshard" over the whole
    world, "dp_tp" over a ``(dp, tp)`` mesh of it.
    """
    from .rowshard import make_dp_tp_decoder, make_rowsharded_decoder
    from .sharded import make_sharded_decoder

    meshes: dict = {}
    out = []
    for case in cases:
        code = load_code(case["code"])
        spec = case["spec"]
        llr = torch.from_numpy(np.asarray(case["llr"], np.int8))
        ref = case.get("ref_bits")
        kind = case["kind"]
        if kind == "dp_tp":
            key = (case["dp"], case["tp"])
            if key not in meshes:
                meshes[key] = decode_mesh_2d(*key)
            res = make_dp_tp_decoder(code, spec, meshes[key],
                                     device=device)(llr, ref)
        elif kind == "sharded":
            res = make_sharded_decoder(code, spec, decode_mesh(),
                                       device=device)(llr, ref)
        elif kind == "rowshard":
            res = make_rowsharded_decoder(code, spec, decode_mesh(),
                                          device=device)(llr.to(device))
        else:
            raise ValueError(f"unknown case kind {kind!r}")
        bits, iters = res[0], res[1]
        be, fe = (int(res[2]), int(res[3])) if len(res) == 4 else (None, None)
        out.append({"bits": bits.cpu().numpy(), "iters": int(iters),
                    "be": be, "fe": fe})
    return out


def _dryrun_rank(rank: int, n: int, device: str) -> Optional[str]:
    from ..decoder import make_decoder
    from .rowshard import rowshard_supported

    code = load_code("576x288")
    spec = LayeredSpec(algo="OMS", iters=3, early_term=True)
    rng = np.random.default_rng(1)
    batch = 2 * n
    llr = np.clip(8.0 * (-1.0 + 0.8 * rng.normal(size=(batch, code.N))),
                  -31, 31).astype(np.int8)
    one = make_decoder(code, spec, device=device)
    ref_bits, _ = one(torch.from_numpy(llr).to(device))
    ref_bits = ref_bits.cpu().numpy()
    cases = [{"kind": "sharded", "code": "576x288", "spec": spec, "llr": llr}]
    if rowshard_supported(code, n):
        cases.append({"kind": "rowshard", "code": "576x288", "spec": spec,
                      "llr": llr[:2]})
    # the largest tp that leaves dp > 1 (8 -> 2x4, 4 -> 2x2)
    tp = max((d for d in (2, 4) if n % d == 0 and n // d > 1), default=1)
    dp = n // tp
    if dp > 1 and tp > 1 and rowshard_supported(code, tp):
        cases.append({"kind": "dp_tp", "code": "576x288", "spec": spec,
                      "llr": llr[:2 * dp], "dp": dp, "tp": tp})
    res = decode_cases(rank, cases, device)
    b = batch // n
    sharded = res[0]
    assert np.array_equal(sharded["bits"], ref_bits[rank * b:(rank + 1) * b])
    err = ref_bits != 0
    assert (sharded["be"], sharded["fe"]) == (int(err.sum()),
                                              int(err.any(1).sum()))
    notes = {"rowshard": "n/a", "dp_tp": "n/a"}
    for case, r in zip(cases[1:], res[1:]):
        if case["kind"] == "rowshard":
            assert np.array_equal(r["bits"], ref_bits[:2]), (
                "the row-sharded decode differs from the one-rank decode")
            notes["rowshard"] = f"bit-exact over {n}-way block-row shards"
        else:
            i = rank // tp  # two codewords a dp rank
            assert np.array_equal(r["bits"], ref_bits[2 * i:2 * i + 2]), (
                "the dp x tp decode differs from the one-rank decode")
            notes["dp_tp"] = f"bit-exact on a {dp}x{tp} mesh (be {r['be']})"
    if rank:
        return None
    return (f"dryrun_multichip ok: {n} ranks on {device}, batch {batch}, "
            f"iters_used {sharded['iters']}, be {sharded['be']}, fe "
            f"{sharded['fe']}; rowshard {notes['rowshard']}; dp x tp "
            f"{notes['dp_tp']}")


def dryrun_multichip(n_devices: int, device=None) -> str:
    """Start ``n_devices`` gloo ranks on ``device`` (default: the card) and
    run the sharded step, the row-sharded decode and the largest dp x tp
    mesh, each checked against the one-rank decode; returns rank 0's
    summary."""
    from ..decoder import default_device

    device = torch.device(device) if device is not None else default_device()
    return run_ranks(_dryrun_rank, n_devices, (n_devices, str(device)))[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", type=int, help="ranks to start")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card, every rank on "
                         "it through gloo; cpu for the plain version)")
    args = ap.parse_args(argv)
    print(dryrun_multichip(args.n, args.device))
    return 0


if __name__ == "__main__":
    sys.exit(main())

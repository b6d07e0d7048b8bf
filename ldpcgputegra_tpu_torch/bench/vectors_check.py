"""The golden vectors, regenerated and checked: ``tools/gen_vectors.py`` as
a check, not a writer.

    python -m ldpcgputegra_tpu_torch.bench.vectors_check
        [--vectors tests/vectors] [--device cpu]

For each of the JAX tool's six ``CASES`` it draws the same int8 LLRs
(``default_rng(20260816)``, 8 frames), decodes them with the port's
golden specification (``golden/decoder.py::decode_golden``, frame by
frame) into a temporary directory, as the JAX tool writes its files, and
compares ``llr``, ``bits`` and ``iters_used`` array by array with the
committed ``--vectors`` files.  It then decodes each case's committed LLRs
through ``make_decoder`` on ``--device`` (the card by default: K1) and
requires the committed bits and ``iters_used``.  It exits non-zero on the
first difference, naming the case and the array.  It never writes into
``--vectors``.  Without a card it exits non-zero, unless ``--device cpu``
(the plain decoder).
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np
import torch

from ..codes.registry import load_code
from ..decoder import make_decoder
from ..golden.decoder import GoldenParams, decode_golden
from ..ops.layered import LayeredSpec

__all__ = ["CASES", "case_file", "regenerate", "check", "main"]

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
VECTORS = os.path.join(_ROOT, "tests", "vectors")
# (code, algo, iters, minclamp, offset): tools/gen_vectors.py:24-31
CASES = [
    ("576x288", "MS", 5, "post", 0),
    ("576x288", "OMS", 10, "pre", 1),
    ("576x288", "NMS", 5, "post", 0),
    ("576x288", "2NMS", 5, "post", 0),
    ("1944x972", "OMS", 10, "pre", 1),
    ("2304x1152", "OMS", 5, "pre", 1),
]
ARRAYS = ("llr", "bits", "iters_used")


def case_file(case) -> str:
    name, algo, iters, minclamp, _ = case
    return f"{name}_{algo}_{iters}_{minclamp}.npz"


def regenerate(case, out_dir: str) -> str:
    """The case's vectors from the golden specification, written to
    ``out_dir`` as the JAX tool writes them; returns the file's path."""
    name, algo, iters, minclamp, offset = case
    code = load_code(name)
    rng = np.random.default_rng(20260816)
    llr = np.clip(8.0 * rng.normal(-1.0, 0.8, size=(8, code.N)), -31,
                  31).astype(np.int8)
    gp = GoldenParams(algo=algo, iters=iters, minclamp=minclamp,
                      offset=offset)
    frames = [decode_golden(code, row, gp) for row in llr]
    bits = np.stack([b for b, _ in frames]).astype(np.int8)
    used = np.asarray([u for _, u in frames], dtype=np.int32)
    path = os.path.join(out_dir, case_file(case))
    np.savez_compressed(path, llr=llr, bits=bits, iters_used=used, algo=algo,
                        iters=iters, minclamp=minclamp, offset=offset,
                        code=name)
    return path


def check(vectors: str = VECTORS, device="cuda", log=print) -> None:
    """Regenerate every case and hold it, then the device's decode of its
    committed LLRs, against ``vectors``; ``SystemExit`` names the first
    case and array that differ."""
    with tempfile.TemporaryDirectory(prefix="ldpc_vectors_") as tmp:
        for case in CASES:
            fn = case_file(case)
            with np.load(os.path.join(vectors, fn)) as ref, \
                    np.load(regenerate(case, tmp)) as new:
                for key in ARRAYS:
                    if not np.array_equal(new[key], ref[key]):
                        raise SystemExit(
                            f"vectors_check: {fn}: {key} differs from the "
                            "golden specification's")
                name, algo, iters, minclamp, offset = case
                spec = LayeredSpec(algo=algo, iters=iters, minclamp=minclamp,
                                   offset=offset)
                bits, used = make_decoder(load_code(name), spec,
                                          device=device)(
                    torch.from_numpy(ref["llr"]).to(device))
                if not np.array_equal(bits.cpu().numpy(),
                                      ref["bits"].astype(np.uint8)):
                    raise SystemExit(f"vectors_check: {fn}: bits differ from "
                                     f"the decode on {device}")
                if int(used) != int(ref["iters_used"].max()):
                    raise SystemExit(f"vectors_check: {fn}: iters_used "
                                     f"differs from the decode on {device}")
            log(f"[vectors_check] {fn}: llr, bits, iters_used equal the "
                f"golden specification's and the decode on {device}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--vectors", default=VECTORS)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device != "cpu" and not torch.cuda.is_available():
        print("vectors_check: no CUDA device", file=sys.stderr)
        return 1
    check(args.vectors, torch.device(args.device))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Two checkouts' decode kernels on one card, timed in turns.

    python -m ldpcgputegra_tpu_torch.bench.ab --other DIR [--rounds 2]
        [--only SUBSTRING]

``DIR`` is the root of another checkout of the repository (for example a
parent commit unpacked with ``git archive``); it needs its
``ldpcgputegra_tpu_torch/`` package and ``ldpcgputegra_tpu/codes/data/``.
Each tree times the QC kernel (``make_cuda_decoder``) at the QC path's
shapes, the gather kernel (``make_gather_decoder``) at those and at the
non-QC codes' (the suite's batches, and 4000x2000 at 1024 and 384, the
batches of two-phase early termination's phase 2), and the streamed
kernel (``make_streamed_decoder``) at the DVB-S2 path's, OMS 10 iterations,
ET off (``measure_call``, CUDA events), in a fresh process of its own
whose kernels are built from that tree's sources, in the order other,
this, this, other (``--rounds`` pairs); ``--only`` keeps the shapes whose
"kernel code B=batch" holds the substring.  Prints each process's times, then
per kernel and shape the best time of each tree and this tree's over the
other's, with the card's name and power limit, and what each tree's decode
kernels compile to (``bench/sass.py``).  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

from . import sass

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

SHAPES = [("layered", "2304x1152", 8192), ("layered", "1944x972", 1024),
          ("layered", "1944x972", 8192), ("layered", "2304x1152", 1024),
          ("gather", "2304x1152", 8192), ("gather", "1944x972", 1024),
          ("gather", "1944x972", 8192), ("gather", "2304x1152", 1024),
          ("gather", "4000x2000", 4096), ("gather", "4000x2000", 1024),
          ("gather", "4000x2000", 384), ("gather", "8000x4000", 2048),
          ("gather", "20000x10000", 1024), ("gather", "2048x384", 8192),
          ("gather", "1024x518", 8192), ("gather", "1200x600", 8192),
          ("streamed", "64800x32400", 512), ("streamed", "64800x32400", 128),
          ("streamed", "64800x6480-dvbs2", 256),
          ("streamed", "16200x7560", 1024),
          ("streamed", "64800x7200-dvbs2", 256),
          ("streamed", "synthqc-256x128x6-z1024", 256)]

# Runs inside each tree: only the entry points that every checkout of the
# port has.
_SNIPPET = r"""
import json, math, sys
import numpy as np, torch
from ldpcgputegra_tpu_torch.bench.harness import measure_call
from ldpcgputegra_tpu_torch.codes.registry import load_code
from ldpcgputegra_tpu_torch.decoder import effective_code
from ldpcgputegra_tpu_torch.kernels import gather, layered, streamed
from ldpcgputegra_tpu_torch.ops.layered import LayeredSpec

make = {"layered": layered.make_cuda_decoder,
        "gather": gather.make_gather_decoder,
        "streamed": streamed.make_streamed_decoder}
out = {}
for kernel, name, B in json.loads(sys.argv[1]):
    code = effective_code(load_code(name))
    sigma = math.sqrt(10 ** (-0.1 * (2.0 + 10 * math.log10(code.rate))) / 2)
    inputs = []
    for s in range(3):
        rng = np.random.default_rng(900 + s)
        y = -1.0 + sigma * rng.standard_normal((B, code.N))
        inputs.append(torch.from_numpy(
            np.clip(8.0 * y, -31, 31).astype(np.int8)).cuda())
    dec = make[kernel](code, LayeredSpec(algo="OMS", iters=10))
    t = measure_call(dec, inputs, k_small=2, k_large=8, repeats=3)
    out[f"{kernel} {name} B={B}"] = t * 1e3
print(json.dumps(out))
"""


def run_tree(root: str, shapes) -> dict:
    """The snippet's times in a fresh process of the tree at ``root``."""
    env = dict(os.environ, PYTHONPATH=root)
    res = subprocess.run([sys.executable, "-c", _SNIPPET, json.dumps(shapes)],
                         cwd=root, env=env, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"{root}: exit {res.returncode}\n{res.stderr}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--only", default="")
    args = ap.parse_args(argv)
    shapes = [s for s in SHAPES if args.only in f"{s[0]} {s[1]} B={s[2]}"]
    import torch

    if not torch.cuda.is_available():
        print("ab: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    other = os.path.abspath(args.other)
    runs = {"other": [], "this": []}
    order = []
    for r in range(args.rounds):
        order += ["other", "this"] if r % 2 == 0 else ["this", "other"]
    for tag in order:
        times = run_tree(other if tag == "other" else _ROOT, shapes)
        runs[tag].append(times)
        print(f"[ab] {tag}: " + ", ".join(f"{k} {v:.4f}" for k, v in
                                          times.items()) + f" | {smi}",
              flush=True)
    for key in runs["this"][0]:
        o = min(r[key] for r in runs["other"])
        t = min(r[key] for r in runs["this"])
        print(f"[ab] {key}: other {o:.4f} ms, this {t:.4f} ms, this/other "
              f"{t / o:.4f} | {smi}")
    for tag, root in (("other", other), ("this", _ROOT)):
        sass.report(root, log=lambda line: print(f"[ab] {tag} {line}"))
    return 0


if __name__ == "__main__":
    sys.exit(main())

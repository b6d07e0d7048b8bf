"""Tile sweep of the streamed kernel (``kernels/streamed.py``) on the card.

    python -m ldpcgputegra_tpu_torch.bench.tiles [--check] [--iters 10]

For each code and batch of the DVB-S2 path (the JAX suite's batches, and
larger ones) and each tile the kernel builds (``streamed.TILES``, codewords
per CTA), prints the kernel's ms per decode at OMS, ET off
(``measure_call``, CUDA events), the card's name and power limit beside
it.  ``--check`` first holds every tile against the plain version on the
card (bits and ``iters_used``, ET on).  Each tile is forced by replacing
``streamed.pick_tile`` for the length of its calls.  ``pick_tile``'s
policy is read from this table (``PERF.md``).  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import math
import subprocess
import sys

import numpy as np
import torch

from ..codes.registry import load_code
from ..decoder import effective_code
from ..kernels import streamed
from ..ops.layered import LayeredSpec, make_layered_decoder
from .harness import measure_call

SHAPES = [("64800x32400", 512), ("64800x32400", 2048), ("16200x7560", 1024),
          ("64800x6480-dvbs2", 256), ("64800x6480-dvbs2", 1024),
          ("synthqc-256x128x6-z1024", 256)]


def llrs(code, B: int, snr_db: float, seed: int) -> torch.Tensor:
    """int8 LLRs of the all-zero codeword at Eb/N0 ``snr_db`` for the
    code's rate, from a numpy seed."""
    sigma = math.sqrt(10 ** (-0.1 * (snr_db + 10 * math.log10(code.rate))) / 2)
    rng = np.random.default_rng(seed)
    y = (-1.0 + sigma * rng.standard_normal((B, code.N))).astype(np.float32)
    return torch.from_numpy(np.clip(8.0 * y, -31, 31).astype(np.int8))


@contextlib.contextmanager
def forced_tile(tile: int):
    """Within the block, every streamed decoder launches ``tile``
    codewords per CTA."""
    picked = streamed.pick_tile
    streamed.pick_tile = lambda code, B, sms=None: tile
    try:
        yield
    finally:
        streamed.pick_tile = picked


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("tiles: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"[tiles] {smi}")
    info = streamed.build()
    print(f"[tiles] built in {info['seconds']:.2f} s")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line:
            print(f"[tiles] {line.strip()}")
    if args.check:
        for name, B, snr in (("16200x10800", 300, 3.0),
                             ("64800x32400", 256, 1.5),
                             ("synthqc-256x128x6-z1024", 64, 2.5)):
            code = effective_code(load_code(name))
            spec = LayeredSpec(iters=6, early_term=True)
            llr = llrs(code, B, snr, seed=1).to(dev)
            pb, pi = make_layered_decoder(code, spec, dev)(llr)
            dec = streamed.make_streamed_decoder(code, spec)
            for tile in streamed.TILES:
                with forced_tile(tile):
                    kb, ki = dec(llr)
                torch.cuda.synchronize()
                ok = torch.equal(kb, pb) and int(ki) == int(pi)
                print(f"[check] {name} B={B} tile {tile}: "
                      f"{'bit-exact' if ok else 'DIFFERS'} iters {int(ki)}")
                if not ok:
                    return 1
    spec = LayeredSpec(algo="OMS", iters=args.iters)
    for name, B in SHAPES:
        code = effective_code(load_code(name))
        dec = streamed.make_streamed_decoder(code, spec)
        inputs = [llrs(code, B, 2.0, seed=s).to(dev) for s in range(2)]
        row = []
        for tile in streamed.TILES:
            with forced_tile(tile):
                t = measure_call(dec, inputs, k_small=2, k_large=6, repeats=2)
            row.append(f"{tile}: {t * 1e3:.4f}")
        print(f"[tiles] {name} B={B} OMS {args.iters} ET off, ms by tile: "
              + ", ".join(row) + f" | {smi}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

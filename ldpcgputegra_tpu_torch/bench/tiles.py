"""Variant sweep of the QC kernel (``kernels/layered.py``), the streamed
kernel (``kernels/streamed.py``) and the gather kernel
(``kernels/gather.py``) on the card.

    python -m ldpcgputegra_tpu_torch.bench.tiles
        [--kernel layered|streamed|gather|all] [--check] [--iters 10]

For each code and batch of a kernel's path and each variant the kernel
builds for that code, prints the kernel's ms per decode at OMS, ET off
(``measure_call``, CUDA events), the variant its pick takes marked with a
``*``, and the card's name and power limit.  The QC kernel's variants are
its tiles (codewords per CTA; four a thread at DMAX 8); the streamed
kernel's are (APP placement, tile, lanes per check); the gather kernel's
(tile, lanes per check), four codewords a thread.  ``--check`` first holds
every variant against the plain version on the card (bits and
``iters_used``, ET on, ragged batches).  Each variant is forced by
replacing the module's ``pick_tile`` for the length of its calls
(``forced_layered``, ``forced_streamed``, ``forced_gather``).  The picks'
policies are read from these tables (``PERF.md`` §6).  Needs a CUDA
device.
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
from ..kernels import _lib, gather, layered, streamed
from ..ops.layered import LayeredSpec, make_layered_decoder
from .harness import measure_call

LAYERED_SHAPES = [("2304x1152", 1024), ("2304x1152", 8192),
                  ("1944x972", 1024), ("1944x972", 8192)]
SHAPES = [("64800x32400", 512), ("64800x32400", 128), ("64800x32400", 2048),
          ("16200x7560", 1024),
          ("64800x6480-dvbs2", 256), ("64800x6480-dvbs2", 1024),
          ("synthqc-256x128x6-z1024", 256)]
# the gather kernel's non-QC codes at the suite's batches, and at smaller
# ones: 4000x2000 at those of two-phase early termination's phase 2
GATHER_SHAPES = [("4000x2000", 4096), ("4000x2000", 1024), ("4000x2000", 384),
                 ("4000x2000", 128), ("8000x4000", 2048),
                 ("20000x10000", 1024), ("9972x4986", 2048),
                 ("4896x2448", 4096), ("2640x1320", 4096), ("2048x384", 8192),
                 ("1024x518", 8192), ("1200x600", 8192), ("816x408", 8192),
                 ("200x100", 16384), ("2640x1320", 1024), ("1200x600", 1024)]
LAYERED_CHECKS = [("576x288", 300, 2.5), ("1944x972", 1000, 2.0),
                  ("155x93", 77, 3.0)]
# ragged batches at each DMAX (8, 16, 32), and tile 4 where only 8 and 4 fit
GATHER_CHECKS = [("200x100", 77, 3.0), ("4000x2000", 301, 2.5),
                 ("816x408", 99, 3.0), ("2048x384", 45, 4.0),
                 ("20000x10000", 37, 2.5)]
CHECKS = [("16200x10800", 300, 3.0), ("64800x32400", 256, 1.5),
          ("64800x6480-dvbs2", 64, 7.0), ("synthqc-256x128x6-z1024", 64, 2.5)]


KERNELS = ("layered", "streamed", "gather")


def llrs(code, B: int, snr_db: float, seed: int) -> torch.Tensor:
    """int8 LLRs of the all-zero codeword at Eb/N0 ``snr_db`` for the
    code's rate, from a numpy seed."""
    sigma = math.sqrt(10 ** (-0.1 * (snr_db + 10 * math.log10(code.rate))) / 2)
    rng = np.random.default_rng(seed)
    y = (-1.0 + sigma * rng.standard_normal((B, code.N))).astype(np.float32)
    return torch.from_numpy(np.clip(8.0 * y, -31, 31).astype(np.int8))


def layered_variants(code) -> list[int]:
    """The QC kernel's tiles whose APP fits shared memory for this code."""
    return [t for t in layered.TILES
            if layered.smem_bytes(code, t) <= _lib.SMEM_MAX]


@contextlib.contextmanager
def forced_layered(tile: int):
    """Within the block, every QC decoder launches ``tile`` codewords per
    CTA."""
    picked = layered.pick_tile
    layered.pick_tile = lambda *args, **kwargs: tile
    try:
        yield
    finally:
        layered.pick_tile = picked


@contextlib.contextmanager
def forced_streamed(variant: streamed.Variant):
    """Within the block, every streamed decoder launches ``variant``."""
    picked = streamed.pick_tile
    streamed.pick_tile = lambda *args, **kwargs: variant
    try:
        yield
    finally:
        streamed.pick_tile = picked


@contextlib.contextmanager
def forced_gather(variant: gather.Variant):
    """Within the block, every gather decoder launches ``variant``."""
    picked = gather.pick_tile
    gather.pick_tile = lambda *args, **kwargs: variant
    try:
        yield
    finally:
        gather.pick_tile = picked


def variant_label(v) -> str:
    """A variant as the tables print it: (placement/)tile/k, or the QC
    kernel's tile."""
    if isinstance(v, streamed.Variant):
        return f"{v.placement}/{v.tile}/k{v.k}"
    if isinstance(v, gather.Variant):
        return f"{v.tile}/k{v.k}"
    return str(v)


def _cases(kernel: str, check: bool):
    """(code, B, snr, decoder maker, variants, forcing, the pick at B)."""
    shapes = {"layered": LAYERED_CHECKS if check else LAYERED_SHAPES,
              "streamed": CHECKS if check else SHAPES,
              "gather": GATHER_CHECKS if check else GATHER_SHAPES}[kernel]
    for row in shapes:
        name, B = row[0], row[1]
        snr = row[2] if check else 2.0
        code = effective_code(load_code(name))
        sms = _lib.sm_count(torch.device("cuda", 0))
        if kernel == "layered":
            yield (code, B, snr, layered.make_cuda_decoder,
                   layered_variants(code), forced_layered,
                   layered.pick_tile(code, B, sms))
        elif kernel == "streamed":
            yield (code, B, snr, streamed.make_streamed_decoder,
                   streamed.variants(code), forced_streamed,
                   streamed.pick_tile(code, B, sms))
        else:
            yield (code, B, snr, gather.make_gather_decoder,
                   gather.variants(code), forced_gather,
                   gather.pick_tile(code, B, sms))


def check(kernel: str, dev, log=print) -> int:
    """Hold every variant of ``kernel`` ("layered", "streamed" or
    "gather") against the plain version on the card at the check shapes
    (bits and ``iters_used``, ET on, ragged batches); returns the largest
    |bit difference| (0), raises on a disagreement."""
    for code, B, snr, make, vs, force, _ in _cases(kernel, True):
        spec = LayeredSpec(iters=6, early_term=True)
        llr = llrs(code, B, snr, seed=1).to(dev)
        pb, pi = make_layered_decoder(code, spec, dev)(llr)
        dec = make(code, spec)
        for v in vs:
            with force(v):
                kb, ki = dec(llr)
            torch.cuda.synchronize()
            ok = torch.equal(kb, pb) and int(ki) == int(pi)
            log(f"[check] {kernel} {code.name} B={B} {variant_label(v)}: "
                f"{'bit-exact' if ok else 'DIFFERS'} iters {int(ki)} "
                f"(plain {int(pi)})")
            if not ok:
                raise AssertionError(
                    f"{kernel} {variant_label(v)} disagrees with the plain "
                    f"version on {code.name}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=KERNELS + ("all",), default="all")
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
    kernels = KERNELS if args.kernel == "all" else (args.kernel,)
    # the checks' spec and this one share the (algorithm, minclamp) pair
    spec = LayeredSpec(algo="OMS", iters=args.iters)
    for kernel in kernels:
        info = {"layered": layered, "streamed": streamed,
                "gather": gather}[kernel].build(*_lib.pair(spec))
        print(f"[tiles] {kernel} built in {info['seconds']:.2f} s")
    for kernel in kernels if args.check else ():
        check(kernel, dev)
    for kernel in kernels:
        for code, B, _, make, vs, force, pick in _cases(kernel, False):
            dec = make(code, spec)
            inputs = [llrs(code, B, 2.0, seed=s).to(dev) for s in range(2)]
            row = []
            for v in vs:
                with force(v):
                    t = measure_call(dec, inputs, k_small=2, k_large=6,
                                     repeats=2)
                row.append(f"{variant_label(v)}{'*' if v == pick else ''}: "
                           f"{t * 1e3:.4f}")
            print(f"[tiles] {kernel} {code.name} B={B} OMS {args.iters} ET "
                  "off, ms by variant (* the pick): " + ", ".join(row)
                  + f" | {smi}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

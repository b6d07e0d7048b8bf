"""Does a converged tile skip its iterations on the card?  The port of
``tools/et_skip_diag.py``.

    python -m ldpcgputegra_tpu_torch.bench.et_skip_diag [--quick]
        [--out benchmarks_torch/ET.md]

Each decode kernel ends a CTA's iteration loop once ``__syncthreads_or``
finds no active codeword in its tile (``csrc/layered_minsum.cu``,
``streamed_minsum.cu``, ``gather_minsum.cu``), and freezes a converged
codeword before that.  Inputs at the two extremes tell "the body is skipped
but convergence comes late" from "the skip does not pay":

* ``clean``: noiseless all-zero frames, LLR -26..-30 (a magnitude that
  varies with the column and the input): every codeword's parity clears
  in iteration 1, so every tile should stop there and ET land near
  ``fixed1``.  ``fixed1`` and both ET variants must give the all-zero
  word, ET with ``iters_used`` 1 (else the run fails).  ``fixed10`` need
  not: with minclamp post a message reaches 111 while the APP saturates at
  127, so from iteration 3 a contribution (APP minus the old message) can
  turn positive, and 10 iterations of 2NMS leave ones in the output (the
  golden specification, the JAX package and the port alike); its
  ``_ones`` are recorded;
* ``noisy``: 0 dB frames from ``AwgnChannel``: almost no codeword
  converges within 10 iterations, so ET pays 10 iterations and its own
  accounting, which bounds what ET costs an iteration.

Variants, 2NMS with minclamp post (the reference's production
configuration): ``fixed10``, ``fixed1``, ``et_pick`` (ET at the tile the
kernel's pick takes) and ``et_small`` (ET at the smallest tile of the
pick's kind, forced with ``bench/tiles.py``: 4 codewords a CTA for K1 and
the gather kernel, 1 for K2).  ``CONFIGS``: the JAX tool's two K1 codes,
64800x32400 on K2 and 4000x2000 on the gather kernel.  Each variant's ms
(``measure_call``, CUDA events, 6 distinct inputs), its ``iters_used``
(the maximum over the batch, as in JAX) and ``fixed10_ms / et_ms``; the
records go to standard output and, as a section, to ``--out``, with the
card's name and power limit.  Needs a CUDA device: without one it exits
non-zero and writes nothing.  ``--quick``: 576x288 only, 2 inputs.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

from ..codes.registry import load_code
from ..decoder import backend_for, effective_code, make_decoder
from ..kernels import _lib, gather, layered, streamed
from ..ops.layered import LayeredSpec
from .ber_curves import BENCH_DIR, card_name
from .harness import awgn_batches, measure_call
from .tiles import (
    forced_gather,
    forced_layered,
    forced_streamed,
    variant_label,
)

__all__ = ["CONFIGS", "BASE", "clean_inputs", "et_variants", "write_section",
           "diagnose", "main"]

# (code, batch): K1's two (the JAX tool's), K2's and the gather kernel's
CONFIGS = [("576x288", 16384), ("2304x1152", 8192), ("64800x32400", 512),
           ("4000x2000", 4096)]
BASE = LayeredSpec(algo="2NMS", iters=10, minclamp="post")
OUT = os.path.join(BENCH_DIR, "ET.md")
KERNEL = {"cuda": "K1", "cuda-streamed": "K2", "cuda-gather": "gather"}


def clean_inputs(code, batch: int, n: int, device) -> list[torch.Tensor]:
    """``n`` distinct noiseless all-zero-codeword batches: LLR -(26 + (j +
    i) % 5) at column j of input i, so every codeword converges in
    iteration 1."""
    out = []
    for i in range(n):
        mag = 26 + (np.arange(code.N) + i) % 5
        row = torch.from_numpy((-mag).astype(np.int8))
        out.append(row.expand(batch, code.N).contiguous().to(device))
    return out


def et_variants(code, spec: LayeredSpec, B: int, sms: int) -> list[tuple]:
    """The kernel ``auto`` picks for ``code`` and its two ET tiles:
    [(label, tile text, forcing context)] for the pick's variant
    (``et_pick``, no forcing) and the smallest tile of the pick's kind
    (``et_small``: K1's ``TILES[-1]``; for K2 the pick's APP placement and
    lanes a check; for the gather kernel the pick's lanes a check)."""
    eff = effective_code(code)
    backend = backend_for(code, spec, "cuda")
    if backend == "cuda":
        pick = layered.pick_tile(eff, B, sms)
        small = layered.TILES[-1]
        return [("et_pick", f"tile {pick}", contextlib.nullcontext),
                ("et_small", f"tile {small}", lambda: forced_layered(small))]
    if backend == "cuda-streamed":
        pick = streamed.pick_tile(eff, B, sms)
        small = min((v for v in streamed.variants(eff)
                     if (v.placement, v.k) == (pick.placement, pick.k)),
                    key=lambda v: v.tile)
        return [("et_pick", variant_label(pick), contextlib.nullcontext),
                ("et_small", variant_label(small),
                 lambda: forced_streamed(small))]
    pick = gather.pick_tile(eff, B, sms)
    small = min((v for v in gather.variants(eff) if v.k == pick.k),
                key=lambda v: v.tile)
    return [("et_pick", variant_label(pick), contextlib.nullcontext),
            ("et_small", variant_label(small), lambda: forced_gather(small))]


def write_section(path: str, heading: str, body: str) -> None:
    """Put ``## heading`` and ``body`` into the Markdown file at ``path``:
    in place of that section where the file has it, else at its end."""
    text = ""
    if os.path.exists(path):
        with open(path) as f:
            text = f.read()
    section = f"## {heading}\n\n{body.rstrip()}\n"
    lines = text.splitlines(keepends=True)
    start = next((i for i, ln in enumerate(lines)
                  if ln.rstrip("\n") == f"## {heading}"), None)
    if start is None:
        if not text:
            text = "# Early termination on the card\n"
        text = text.rstrip("\n") + "\n\n" + section
    else:
        end = next((i for i in range(start + 1, len(lines))
                    if lines[i].startswith("## ")), len(lines))
        tail = "".join(lines[end:])
        text = "".join(lines[:start]) + section + ("\n" + tail if tail else "")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(text)


def diagnose(name: str, B: int, dev, smi: str, n_inputs: int = 6) -> list:
    """The clean and the noisy record of one configuration."""
    code = load_code(name)
    sms = _lib.sm_count(dev)
    et = dataclasses.replace(BASE, early_term=True)
    runs = [("fixed10", BASE, "pick", contextlib.nullcontext),
            ("fixed1", dataclasses.replace(BASE, iters=1), "pick",
             contextlib.nullcontext)]
    runs += [(label, et, tile, force)
             for label, tile, force in et_variants(code, BASE, B, sms)]
    backend = backend_for(code, BASE, "cuda")
    recs = []
    for kind, inputs in (("clean", clean_inputs(code, B, n_inputs, dev)),
                         ("noisy", awgn_batches(code, B, n_inputs, dev,
                                                snr=0.0, seed0=9100))):
        rec = {"code": name, "batch": B, "kind": kind, "algo": BASE.algo,
               "minclamp": BASE.minclamp, "kernel": KERNEL[backend]}
        for label, spec, tile, force in runs:
            dec = make_decoder(code, spec, backend=backend, device=dev)
            with force():
                bits, iters = dec(inputs[0])
                ones = int(bits.sum())
                # all but fixed10 stop after iteration 1 at the all-zero word
                if kind == "clean" and label != "fixed10" and (
                        ones or int(iters) != 1):
                    raise SystemExit(
                        f"et_skip_diag: {name} {label}: a clean input did not "
                        "decode to the all-zero codeword in iteration 1 "
                        f"({ones} ones, iters_used {int(iters)})")
                rec[label + "_iters"] = int(iters)
                rec[label + "_ones"] = ones
                rec[label + "_ms"] = measure_call(dec, inputs) * 1e3
            rec[label + "_tile"] = tile
        for label in ("et_pick", "et_small"):
            rec[f"fixed10_over_{label}"] = (rec["fixed10_ms"]
                                           / rec[label + "_ms"])
        rec["card"] = smi
        print(json.dumps(rec), flush=True)
        recs.append(rec)
    return recs


def _markdown(recs: list[dict], smi: str) -> str:
    lines = [
        f"Written by `python -m ldpcgputegra_tpu_torch.bench.et_skip_diag` on "
        f"{smi}, {time.strftime('%Y-%m-%d')}.  2NMS, minclamp post, ms a "
        "call by CUDA events over 6 distinct inputs; `iters` is the "
        "`iters_used` of the first input (the maximum over its batch).  "
        "`clean`: noiseless all-zero LLRs -26..-30, every codeword "
        "converges in iteration 1 (`fixed1` and ET give the all-zero word, "
        "ET in 1 iteration: asserted); `noisy`: 0 dB.  A skip that works "
        "puts `clean` ET near `fixed1`.  `fixed10 ones`: the ones in "
        "`fixed10`'s output of the first input (on `clean`, minclamp "
        "post's saturated APP turns contributions positive from iteration "
        "3; the golden specification and the JAX package give the same).",
        "",
        "| code | batch | kernel | inputs | fixed10 ms (ones) | fixed1 ms | "
        "ET at the pick ms (tile; iters) | ET at the smallest tile ms (tile; "
        "iters) | fixed10 / ET pick | fixed10 / ET smallest |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        lines.append(
            f"| {r['code']} | {r['batch']} | {r['kernel']} | {r['kind']} "
            f"| {r['fixed10_ms']:.4f} ({r['fixed10_ones']}) "
            f"| {r['fixed1_ms']:.4f} "
            f"| {r['et_pick_ms']:.4f} ({r['et_pick_tile']}; "
            f"{r['et_pick_iters']}) | {r['et_small_ms']:.4f} "
            f"({r['et_small_tile']}; {r['et_small_iters']}) "
            f"| {r['fixed10_over_et_pick']:.2f} "
            f"| {r['fixed10_over_et_small']:.2f} |")
    lines += ["", "```json"] + [json.dumps(r) for r in recs] + ["```"]
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("et_skip_diag: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = card_name(dev)
    print(f"[et_skip_diag] {smi}", flush=True)
    recs = []
    for name, B in CONFIGS[:1] if args.quick else CONFIGS:
        recs += diagnose(name, B, dev, smi, 2 if args.quick else 6)
    write_section(args.out, "Does a converged tile skip its iterations?",
                  _markdown(recs, smi))
    print(f"[et_skip_diag] wrote {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

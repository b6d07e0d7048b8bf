"""Where does the kernels' own early termination pay?  The port of
``tools/run_kernel_et.py``.

    python -m ldpcgputegra_tpu_torch.bench.kernel_et [--quick]
        [--out benchmarks_torch/ET.md]

A CTA of each decode kernel leaves its iteration loop once every codeword
of its tile has converged, so ET can beat fixed iterations only where
whole tiles converge early: at high SNR and at small tiles.  At each point
of ``CONFIGS`` (the JAX tool's 13, 2NMS with minclamp post, and two each
for K2 at 64800x32400 B=512 and for the gather kernel at 4000x2000 B=4096,
OMS as the port's BER book's curves are, at SNRs where that book's FER is
below 1e-3 or, for 64800x32400, whose book stops at 2.0 dB, past its end)
it decodes 6 distinct batches from ``AwgnChannel`` at fixed 10
iterations, and at 10 with ET at the tile the kernel's pick takes and at
the smallest tile of the pick's kind (``bench/et_skip_diag.py::
et_variants``).  Coded Mbit/s from ``measure_call`` (CUDA events), the
``iters_used`` of each batch (the maximum over it), and the best ET's rate
over fixed 10's; and, on the first batch, the point's convergence
fractions (``bench/et_study.py::convergence_stats``: the output satisfies
every check) beside the iteration at which the kernel's own criterion
(the parity of the contributions) stops each of its first ``STOP_FRAMES``
frames, decoded one at a time: an ET that cannot pay because the frames
converge late, or because that criterion lags the syndrome.  The records go
to standard output and, as a section, to
``--out``, with the card's name and power limit.  Needs a CUDA device:
without one it exits non-zero and writes nothing.  ``--quick``: the first
point, 2 inputs.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time

import torch

from ..codes.registry import load_code
from ..decoder import backend_for, make_decoder
from ..kernels import _lib
from ..ops.layered import LayeredSpec
from .ber_curves import card_name
from .et_skip_diag import KERNEL, OUT, et_variants, write_section
from .et_study import CONV_KS, convergence_stats
from .harness import awgn_batches, measure_call

__all__ = ["CONFIGS", "point", "main"]

STOP_FRAMES = 64
# (code, batch, Eb/N0 dB, algo)
CONFIGS = [
    ("576x288", 16384, 3.5, "2NMS"),
    ("576x288", 16384, 4.0, "2NMS"),
    ("576x288", 16384, 4.5, "2NMS"),
    ("576x288", 16384, 5.5, "2NMS"),
    ("576x288", 16384, 6.5, "2NMS"),
    ("2304x1152", 8192, 3.5, "2NMS"),
    ("2304x1152", 8192, 4.0, "2NMS"),
    ("2304x1152", 8192, 5.0, "2NMS"),
    ("2304x1152", 8192, 6.0, "2NMS"),
    ("1944x972", 8192, 3.5, "2NMS"),
    ("1944x972", 8192, 4.0, "2NMS"),
    ("1944x972", 8192, 5.0, "2NMS"),
    ("1944x972", 8192, 6.0, "2NMS"),
    # K2: the book's 64800x32400 curve ends at 2.0 dB with FER 2.6e-3
    ("64800x32400", 512, 2.25, "OMS"),
    ("64800x32400", 512, 2.5, "OMS"),
    # the gather kernel: the book's FER 2.5e-5 and 5.7e-7
    ("4000x2000", 4096, 2.25, "OMS"),
    ("4000x2000", 4096, 2.5, "OMS"),
]


def point(name: str, B: int, snr: float, algo: str, dev, smi: str,
          n_inputs: int = 6) -> dict:
    """Fixed 10 against ET at the pick's tile and at the smallest tile."""
    code = load_code(name)
    base = LayeredSpec(algo=algo, iters=10,
                       minclamp="pre" if algo == "OMS" else "post")
    et = dataclasses.replace(base, early_term=True)
    inputs = awgn_batches(code, B, n_inputs, dev, snr, seed0=7000)
    runs = [("fixed10", base, "pick", contextlib.nullcontext)]
    runs += [(label, et, tile, force) for label, tile, force in
             et_variants(code, base, B, _lib.sm_count(dev))]
    backend = backend_for(code, base, "cuda")
    rec = {"code": name, "algo": algo, "snr_db": snr, "batch": B,
           "kernel": KERNEL[backend]}
    for label, spec, tile, force in runs:
        dec = make_decoder(code, spec, backend=backend, device=dev)
        with force():
            its = [int(dec(x)[1]) for x in inputs]
            sec = measure_call(dec, inputs)
        rec[label + "_mbps"] = B * code.N / sec / 1e6
        rec[label + "_iters"] = its
        rec[label + "_tile"] = tile
    # when the frames converge, and when the kernel's own criterion (the
    # parity of the contributions, on the fly) lets each of the first
    # STOP_FRAMES frames stop, one frame a decode: the two tell an ET that
    # cannot pay because the frames converge late from one whose criterion
    # lags the syndrome
    rec["frac_converged"] = convergence_stats(code, algo, base.minclamp,
                                              inputs[0], dev)
    dec = make_decoder(code, et, backend=backend, device=dev)
    stops = [int(dec(inputs[0][i:i + 1])[1]) for i in range(STOP_FRAMES)]
    rec["et_stop_mean"] = sum(stops) / len(stops)
    rec["et_stop_max"] = max(stops)
    rec["best_et_over_fixed10"] = max(
        rec["et_pick_mbps"], rec["et_small_mbps"]) / rec["fixed10_mbps"]
    rec["card"] = smi
    print(json.dumps(rec), flush=True)
    return rec


def _markdown(recs: list[dict], smi: str) -> str:
    def its(r, label):
        v = r[label + "_iters"]
        return f"{min(v)}-{max(v)}" if min(v) != max(v) else str(v[0])

    lines = [
        f"Written by `python -m ldpcgputegra_tpu_torch.bench.kernel_et` on "
        f"{smi}, {time.strftime('%Y-%m-%d')}.  Coded Mbit/s by CUDA events "
        "over 6 distinct `AwgnChannel` batches; `iters` the range of "
        "their `iters_used` (each the maximum over its batch).  ET ends a "
        "CTA once every codeword of its tile has converged.  P(<=k): the "
        "share of the first batch's frames whose output satisfies every "
        "check within k iterations (`bench/et_study.py::convergence_stats`)"
        "; stop: the mean (max) iteration at which the kernel's own "
        f"criterion, the contributions' parity, stops each of its first "
        f"{STOP_FRAMES} frames decoded one at a time.",
        "",
        "| code | algo | SNR dB | batch | kernel | fixed 10 Mbit/s | ET at "
        "the pick Mbit/s (tile; iters) | ET at the smallest tile Mbit/s "
        "(tile; iters) | best ET / fixed 10 | "
        + " | ".join(f"P(<={k})" for k in CONV_KS) + " | stop |",
        "|---|---|---|---|---|---|---|---|---|" + "---|" * (len(CONV_KS) + 1),
    ]
    for r in recs:
        lines.append(
            f"| {r['code']} | {r['algo']} | {r['snr_db']} | {r['batch']} "
            f"| {r['kernel']} | {r['fixed10_mbps']:.1f} "
            f"| {r['et_pick_mbps']:.1f} ({r['et_pick_tile']}; "
            f"{its(r, 'et_pick')}) | {r['et_small_mbps']:.1f} "
            f"({r['et_small_tile']}; {its(r, 'et_small')}) "
            f"| {r['best_et_over_fixed10']:.3f} | "
            + " | ".join(f"{r['frac_converged'][k]:.4f}" for k in CONV_KS)
            + f" | {r['et_stop_mean']:.2f} ({r['et_stop_max']}) |")
    lines += ["", "```json"] + [json.dumps(r) for r in recs] + ["```"]
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_et: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = card_name(dev)
    print(f"[kernel_et] {smi}", flush=True)
    recs = [point(*cfg, dev, smi, 2 if args.quick else 6)
            for cfg in (CONFIGS[:1] if args.quick else CONFIGS)]
    write_section(args.out, "Kernel ET against fixed 10 iterations",
                  _markdown(recs, smi))
    print(f"[kernel_et] wrote {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

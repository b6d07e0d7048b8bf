"""Cross-kernel validation on the card: the port of ``tools/hw_validate.py``.

    python -m ldpcgputegra_tpu_torch.bench.hw_validate
        [--which compile,qc,streamed,gather,tail] [--quick]
        [--out benchmarks_torch/HWVALIDATE.md]

Decodes the same batches (``AwgnChannel`` at 2.0 dB, OMS 10, ET off)
through two decoders and requires identical bits and ``iters_used``; a
mismatch ends the run with a non-zero exit, naming the pair.  The pairs
(``pairs``), by ``--which`` key:

* ``qc``: the QC kernel (K1, backend ``cuda``) against the plain version
  (``torch`` on the card) at the JAX tool's ``QC`` codes and batches;
* ``streamed``: K1 against the streamed kernel (K2, ``cuda-streamed``,
  forced) on K1's own codes (``K1K2``), K2 at the variant its pick takes
  and at every variant ``bench/tiles.py::forced_streamed`` can force for
  the code, each held against K1's bits; then K2 against the plain version
  at the JAX tool's ``STREAMED`` and ``STREAMED_ONLY`` rows, since K1
  refuses a QC view;
* ``tail``: each code of the JAX tool's ``TAIL`` through the kernel
  ``auto`` picks, against the plain version;
* ``gather``: the gather kernel (``cuda-gather``) at its pick against the
  plain version at the JAX tool's ``GATHER`` codes;
* ``compile``: each ``csrc/*.cu`` built cold by ``kernels/_lib.py::
  build_library`` into a temporary directory (never ``_build/``), its nvcc
  seconds; then, with the libraries in ``_build/``, a fresh decoder's first
  call against its second, by the host clock.

Kernels are timed by ``bench/harness.py::measure_call`` (CUDA events); the
plain version decodes 2 inputs for the bit check and is not timed.  Writes
the Markdown table and the JSON records to ``--out`` (the records also go to
standard output), with the card's name and power limit.  Needs a CUDA
device: without one it exits non-zero and writes nothing.  ``--quick``: 2
inputs, no forced variants, K1 against K2 at 2304x1152 B=8192 and 1944x972
B=1024, the gather kernel at 4000x2000 and the first ``TAIL`` code.

Left out from the JAX tool: its gather compile pricing of the unrolled
against the chunked Pallas kernel (a Mosaic compile-service cost; the card
has one gather kernel, whose nvcc time ``compile`` records) and its
``safe()`` wrapper, which forgave compile-service failures: here a failed
build or launch fails the run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import torch

from ..codes.registry import load_code
from ..decoder import backend_for, effective_code, make_decoder
from ..kernels import _lib, gather, layered, streamed
from ..ops.layered import LayeredSpec
from . import profile_1944, vpu_probe
from .ber_curves import BENCH_DIR, card_name
from .harness import awgn_batches, measure_call, throughput_report
from .tiles import variant_label, forced_streamed

__all__ = ["pairs", "check_pair", "price_compiles", "main", "QC", "K1K2",
           "STREAMED", "STREAMED_ONLY", "GATHER", "TAIL", "SPEC"]

SPEC = LayeredSpec(algo="OMS", iters=10, early_term=False)
QC = [("576x288", 4096), ("1944x972", 2048), ("2304x1152", 2048)]
# K1 against K2 on K1's own codes: does Hopper need the split?
K1K2 = [("2304x1152", 8192), ("1944x972", 1024), ("576x288", 16384)]
STREAMED = [("16200x7560", 1024), ("64800x32400", 256)]
STREAMED_ONLY = [("synthqc-256x128x6-z1024", 256)]
GATHER = [("4000x2000", 4096), ("8000x4000", 2048), ("9972x4986", 2048),
          ("20000x10000", 1024)]
TAIL = [
    ("155x93", 4096), ("200x100", 4096), ("816x408", 2048),
    ("1024x518", 2048), ("1200x600", 2048), ("1248x624", 2048),
    ("2640x1320", 1024), ("802_11e_576x288", 4096),
    ("802_11e_1920x960", 2048), ("802_11e_2304x1152", 2048),
    ("802_11n-1944x972", 2048), ("16200x10800", 512),
    ("64800x32400-dvbs2", 256), ("64800x6480-dvbs2", 256),
    ("64800x7200-dvbs2", 256),
]
# first call against second: K1, K2 and the gather kernel at their codes
FIRST_CALL = [("2304x1152", 2048), ("64800x32400", 256), ("4000x2000", 1024),
              ("8000x4000", 1024), ("9972x4986", 1024), ("20000x10000", 1024)]
SOURCES = {"layered_minsum": layered.SOURCE, "gather_minsum": gather.SOURCE,
           "streamed_minsum": streamed.SOURCE, "probes": vpu_probe.SOURCE,
           "roll_probe": profile_1944.SOURCE}
PLAIN_INPUTS = 2  # the plain version's bit check
OUT = os.path.join(BENCH_DIR, "HWVALIDATE.md")


def pairs(which, quick: bool = False) -> list[tuple]:
    """The pairs of ``which`` (a set of ``--which`` keys), in order:
    (key, code, batch, backend a, backend b).  ``torch`` is the plain
    version; a tail row's kernel is the one ``auto`` picks on a card."""
    out = []
    if "qc" in which:
        out += [("qc", n, b, "cuda", "torch") for n, b in QC]
    if "streamed" in which:
        out += [("streamed", n, b, "cuda", "cuda-streamed")
                for n, b in (K1K2[:2] if quick else K1K2)]
        if not quick:
            out += [("streamed", n, b, "cuda-streamed", "torch")
                    for n, b in STREAMED + STREAMED_ONLY]
    if "tail" in which:
        out += [("tail", n, b, backend_for(load_code(n), SPEC, "cuda"),
                 "torch") for n, b in (TAIL[:1] if quick else TAIL)]
    if "gather" in which:
        out += [("gather", n, b, "cuda-gather", "torch")
                for n, b in (GATHER[:1] if quick else GATHER)]
    return out


def _inputs(code, batch: int, n: int, dev) -> list:
    return awgn_batches(code, batch, n, dev, snr=2.0, seed0=1000)


def check_pair(name: str, label_a: str, dec_a, label_b: str, dec_b,
               inputs) -> int:
    """Decode each input through both decoders; the bits and ``iters_used``
    must be identical.  Returns the number of inputs compared; a mismatch
    raises ``SystemExit`` naming the pair and the input."""
    for i, x in enumerate(inputs):
        bits_a, it_a = dec_a(x)[:2]
        bits_b, it_b = dec_b(x)[:2]
        if not torch.equal(bits_a, bits_b) or int(it_a) != int(it_b):
            n_bits = int((bits_a != bits_b).sum())
            raise SystemExit(
                f"hw_validate: {name}: {label_a} and {label_b} differ on "
                f"input {i}: {n_bits} bits, iters_used {int(it_a)} against "
                f"{int(it_b)}")
    return len(inputs)


def _kernel_of(backend: str, code, B: int, sms: int) -> tuple[str, str]:
    """(kernel, the variant its pick launches at ``B`` on ``sms`` SMs) of a
    kernel backend."""
    eff = effective_code(code)
    if backend == "cuda":
        return "K1 layered_minsum", f"tile {layered.pick_tile(eff, B, sms)}"
    if backend == "cuda-streamed":
        return "K2 streamed_minsum", variant_label(
            streamed.pick_tile(eff, B, sms))
    return "gather_minsum", variant_label(gather.pick_tile(eff, B, sms))


def _row(code, B, backend, variant, sec, pick, smi) -> dict:
    rep = throughput_report(sec, B, code.N)
    return {"backend": backend, "variant": variant, "pick": pick,
            "ms": rep["ms_per_call"], "coded_mbps": rep["coded_mbps"],
            "card": smi}


def _validate(key, name, B, back_a, back_b, quick, dev, smi) -> dict:
    """One pair: the bit check, then each kernel side's time."""
    code = load_code(name)
    sms = _lib.sm_count(dev)
    decs = {b: make_decoder(code, SPEC, backend=b, device=dev)
            for b in (back_a, back_b)}
    n_in = 2 if quick else 4
    inputs = _inputs(code, B, n_in, dev)
    plain = "torch" in (back_a, back_b)
    checked = check_pair(name, back_a, decs[back_a], back_b, decs[back_b],
                         inputs[:PLAIN_INPUTS] if plain else inputs)
    ks, kl, rep = (2, 6, 2) if quick else (4, 20, 3)
    rows = []
    for b in (back_a, back_b):
        if b == "torch":
            continue
        kernel, variant = _kernel_of(b, code, B, sms)
        sec = measure_call(decs[b], inputs, k_small=ks, k_large=kl,
                           repeats=rep)
        rows.append({"kernel": kernel, **_row(code, B, b, variant, sec, True,
                                                smi)})
    if back_b == "cuda-streamed" and not quick:
        # every variant the streamed kernel builds for this code, each held
        # against K1's bits before it is timed
        eff = effective_code(code)
        picked = streamed.pick_tile(eff, B, sms)
        for v in streamed.variants(eff):
            with forced_streamed(v):
                check_pair(name, back_a, decs[back_a],
                           f"cuda-streamed {variant_label(v)}", decs[back_b],
                           inputs)
                sec = measure_call(decs[back_b], inputs, k_small=ks,
                                   k_large=kl, repeats=rep)
            rows.append({"kernel": "K2 streamed_minsum (forced)",
                         **_row(code, B, back_b, variant_label(v), sec,
                                v == picked, smi)})
    rec = {"key": key, "code": name, "batch": B, "iters": SPEC.iters,
           "algo": SPEC.algo, "a": back_a, "b": back_b, "inputs": checked,
           "bit_exact": True, "rows": rows, "card": smi}
    print(json.dumps(rec), flush=True)
    return rec


def price_compiles(dev, smi) -> list[dict]:
    """Each kernel library built cold into a temporary directory (nvcc
    seconds), one after another; then a fresh decoder's first call against
    its second at ``FIRST_CALL``, the libraries already in ``_build/``."""
    recs = []
    with tempfile.TemporaryDirectory(prefix="ldpc_cold_build_") as tmp:
        for name, source in SOURCES.items():
            info = _lib.build_library(source, os.path.join(tmp, name))
            recs.append({"key": "compile", "library": name,
                         "nvcc_s": info["seconds"], "card": smi})
            print(json.dumps(recs[-1]), flush=True)
    for mod in (layered, gather, streamed):
        mod.build()  # the warm cache the first calls below load from
    for name, B in FIRST_CALL:
        code = load_code(name)
        x = _inputs(code, B, 1, dev)[0]
        dec = make_decoder(code, SPEC, device=dev)
        times = []
        for _ in range(2):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            dec(x)
            torch.cuda.synchronize(dev)
            times.append(time.perf_counter() - t0)
        recs.append({"key": "first_call", "code": name, "batch": B,
                     "backend": backend_for(code, SPEC, dev),
                     "first_call_ms": times[0] * 1e3,
                     "second_call_ms": times[1] * 1e3, "card": smi})
        print(json.dumps(recs[-1]), flush=True)
    return recs


def _markdown(recs: list[dict], smi: str, quick: bool) -> str:
    lines = [
        "# Cross-kernel validation on the card",
        "",
        f"Written by `python -m ldpcgputegra_tpu_torch.bench.hw_validate"
        f"{' --quick' if quick else ''}` on {smi}, "
        f"{time.strftime('%Y-%m-%d')}.  Identical inputs (`AwgnChannel`, "
        "2.0 dB) decoded by two decoders, OMS 10, ET off; bits and "
        "`iters_used` identical (a mismatch fails the run).  Kernel times "
        "by CUDA events (`bench/harness.py::measure_call`); the plain "
        "version (`torch` on the card) decodes 2 inputs for the check and "
        "is not timed.  `*`: the variant the kernel's pick launches.",
        "",
        "| pair | code | batch | kernel | variant | ms/call | coded Mbit/s "
        "| against | bit-exact |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    k1k2 = [r for r in recs if (r.get("a"), r.get("b")) == ("cuda",
                                                            "cuda-streamed")]
    for r in recs:
        if r["key"] in ("compile", "first_call"):
            continue
        for row in r["rows"]:
            other = r["b"] if row["backend"] == r["a"] else r["a"]
            lines.append(
                f"| {r['key']} | {r['code']} | {r['batch']} | {row['kernel']} "
                f"| {row['variant']}{'*' if row['pick'] else ''} "
                f"| {row['ms']:.4f} | {row['coded_mbps']:.1f} | {other} "
                f"| {r['bit_exact']} |")
    if k1k2:
        lines += ["", "K1 against K2 on K1's codes (does Hopper need the "
                  "split?): K2 at its pick and at its fastest forced "
                  "variant, each over K1's time at K1's pick:", "",
                  "| code | batch | K1 ms (variant) | K2 at its pick ms "
                  "(variant) | K2 fastest ms (variant) | pick / K1 | fastest "
                  "/ K1 |", "|---|---|---|---|---|---|---|"]
        for r in k1k2:
            k1, k2 = r["rows"][:2]
            best = min(r["rows"][1:], key=lambda row: row["ms"])
            lines.append(
                f"| {r['code']} | {r['batch']} | {k1['ms']:.4f} "
                f"({k1['variant']}) | {k2['ms']:.4f} ({k2['variant']}) "
                f"| {best['ms']:.4f} ({best['variant']}) "
                f"| {k2['ms'] / k1['ms']:.3f} | {best['ms'] / k1['ms']:.3f} |")
    comp = [r for r in recs if r["key"] == "compile"]
    if comp:
        lines += ["", "Cold builds (`nvcc`, one after another, into a "
                  "temporary directory):", "", "| library | nvcc s |",
                  "|---|---|"]
        lines += [f"| {r['library']} | {r['nvcc_s']:.2f} |" for r in comp]
    first = [r for r in recs if r["key"] == "first_call"]
    if first:
        lines += ["", "A fresh decoder's first call against its second "
                  "(host clock, the card synchronised; the libraries already "
                  "built; the first row also loads its library):", "",
                  "| code | batch | backend | first call ms | second call "
                  "ms |",
                  "|---|---|---|---|---|"]
        lines += [f"| {r['code']} | {r['batch']} | {r['backend']} "
                  f"| {r['first_call_ms']:.2f} | {r['second_call_ms']:.2f} |"
                  for r in first]
    lines += ["", "Raw records:", "", "```json"]
    lines += [json.dumps(r) for r in recs]
    lines += ["```", ""]
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--which", default="compile,qc,streamed,gather,tail")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("hw_validate: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = card_name(dev)
    print(f"[hw_validate] {smi}", flush=True)
    which = set(args.which.split(","))
    recs = price_compiles(dev, smi) if "compile" in which else []
    for key, name, B, a, b in pairs(which, args.quick):
        recs.append(_validate(key, name, B, a, b, args.quick, dev, smi))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(_markdown(recs, smi, args.quick))
    print(f"[hw_validate] wrote {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

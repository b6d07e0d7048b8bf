"""The 16200x7560 profile on the card: the port of ``tools/profile_16200.py``.

    python -m ldpcgputegra_tpu_torch.bench.profile_16200 [--quick]
        [--out benchmarks_torch/PROFILE_16200.md]

16200x7560 decodes through its Z=360 QC view, which carries a column
permutation (``col_perm``), on the streamed kernel (K2).  At B=1024, OMS
10, ET off, 2.5 dB (6 distinct ``AwgnChannel`` batches, ``measure_call``,
CUDA events) it times:

1. the full call at the variant K2's pick takes (``full``);
2. the perm-free twin (``perm_free_twin``: the same view with
   ``col_perm=None``) at the same variant: it decodes a column-scrambled
   code, so its bits mean nothing, but it runs the same edge updates
   without the permutation;
3. the tile A/B: every variant ``bench/tiles.py::forced_streamed`` can
   force for the view, on the full path and on the twin.

The JAX tool's standalone permute rows are left out: K2 applies
``col_perm`` as it loads the LLRs and stores the bits, so no standalone
permute is on the card's path.  Writes the table and the JSON record to
``--out``, with the card's name and power limit.  Needs a CUDA device:
without one it exits non-zero and writes nothing.  ``--quick``: 2 inputs,
the pick's variant only.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import torch

from ..codes.code import LdpcCode
from ..codes.registry import load_code
from ..decoder import effective_code
from ..kernels import _lib, streamed
from ..ops.layered import LayeredSpec
from .ber_curves import BENCH_DIR, card_name
from .harness import awgn_batches, measure_call
from .tiles import variant_label, forced_streamed

__all__ = ["perm_free_twin", "profile", "main", "NAME", "BATCH", "SPEC"]

NAME = "16200x7560"
BATCH = 1024
SNR = 2.5
SPEC = LayeredSpec(algo="OMS", iters=10, early_term=False)
OUT = os.path.join(BENCH_DIR, "PROFILE_16200.md")


def perm_free_twin(view: LdpcCode) -> LdpcCode:
    """The QC view without its column permutation: the same edge updates
    on a column-scrambled code, ``twin(llr[:, perm])[:, inv_perm] ==
    full(llr)``."""
    return dataclasses.replace(view, col_perm=None)


def profile(dev, smi: str, quick: bool = False) -> tuple[dict, str]:
    """The record and the Markdown of the profile on ``dev``."""
    view = effective_code(load_code(NAME))
    twin = perm_free_twin(view)
    inputs = awgn_batches(view, BATCH, 2 if quick else 6, dev, SNR, seed0=100)
    pick = streamed.pick_tile(view, BATCH, _lib.sm_count(dev))
    decs = {"full": streamed.make_streamed_decoder(view, SPEC),
            "twin": streamed.make_streamed_decoder(twin, SPEC)}
    variants = [pick] if quick else streamed.variants(view)
    rows = {}
    for v in variants:
        for path, dec in decs.items():
            with forced_streamed(v):
                sec = measure_call(dec, inputs)
            rows[f"{path} {variant_label(v)}"] = sec * 1e3
            print(f"[profile_16200] {path} {variant_label(v)}"
                  f"{' (the pick)' if v == pick else ''}: {sec * 1e3:.4f} ms, "
                  f"{BATCH * view.N / sec / 1e6:.1f} coded Mbit/s | {smi}",
                  flush=True)
    label = variant_label(pick)
    full, bare = rows[f"full {label}"], rows[f"twin {label}"]
    best = min((k for k in rows if k.startswith("full ")), key=rows.get)
    rec = {"code": NAME, "batch": BATCH, "algo": SPEC.algo,
           "iters": SPEC.iters, "snr_db": SNR, "pick": label, "ms": rows,
           "perm_ms": full - bare, "perm_share": (full - bare) / full,
           "best_full": best, "card": smi}
    print(json.dumps(rec), flush=True)
    lines = [
        "# 16200x7560 on the streamed kernel (K2)",
        "",
        f"Written by `python -m ldpcgputegra_tpu_torch.bench.profile_16200"
        f"{' --quick' if quick else ''}` on {smi}, "
        f"{time.strftime('%Y-%m-%d')}.  Batch {BATCH}, OMS 10, ET off, "
        f"{SNR} dB, ms a call by CUDA events over {len(inputs)} distinct "
        "inputs.  `full`: the QC view, `col_perm` applied by K2 as it loads "
        "the LLRs and stores the bits; `twin`: the same view without "
        "`col_perm` (the same edge updates, bits meaningless).  Variant: "
        "(APP placement / codewords a CTA / lanes a check); `*` the pick.  "
        "No standalone permute is on the card's path, so the JAX tool's "
        "permute rows have no counterpart here.",
        "",
        "| variant | full ms | twin ms | full - twin ms |",
        "|---|---|---|---|",
    ]
    for v in variants:
        vl = variant_label(v)
        f_ms, t_ms = rows[f"full {vl}"], rows[f"twin {vl}"]
        lines.append(f"| {vl}{'*' if v == pick else ''} | {f_ms:.4f} "
                     f"| {t_ms:.4f} | {f_ms - t_ms:.4f} |")
    lines += [
        "",
        f"At the pick ({label}) the permutation costs {full - bare:.4f} ms "
        f"of {full:.4f} ms ({100 * (full - bare) / full:.1f}%); the fastest "
        f"full-path variant is {best.split(' ', 1)[1]} "
        f"({rows[best]:.4f} ms, {full / rows[best]:.3f}x faster than the "
        "pick).",
        "", "```json", json.dumps(rec), "```", ""]
    return rec, "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_16200: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = card_name(dev)
    print(f"[profile_16200] {smi}", flush=True)
    _, md = profile(dev, smi, args.quick)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(md)
    print(f"[profile_16200] wrote {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

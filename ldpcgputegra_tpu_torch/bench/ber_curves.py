"""BER/FER waterfall curves on the card -> ``benchmarks_torch/BER.md``: the
port of the JAX package's ``tools/run_ber_curves.py``.

    python -m ldpcgputegra_tpu_torch.bench.ber_curves [--only ID,ID]
        [--max-fe 100] [--max-frames 3000000] [--timer-s S] [--md-only]
        [--device cuda]

Each curve of ``CURVES`` (the JAX tool's table, verbatim) runs through
``sim/sweep.py::run_sweep`` with early termination and a per-curve
checkpoint, and is saved to ``benchmarks_torch/ber_data/<id>.json`` in the
JAX book's schema with these differences: ``"backend"`` is the device type
(``"cuda"``) or ``"native+<rng>"``, ``"card"`` holds the card's name and
power limit (``nvidia-smi``; null off the card), and each point also
carries ``mbps`` (coded Mbit/s on the point's own clock) and
``runtime_s``.  ``benchmarks_torch/BER.md`` is regenerated from every
saved curve after each one; it ends with each point beside the JAX book's
(``benchmarks/ber_data/``, read by path) and the exact test's p
(``bench/ber_check.py``).  Nothing is written under ``benchmarks/``.

The curves with ``"backend": "native"`` in their spec decode on the host
(``golden/native.py``, the Philox channel: JAX's noise byte for byte),
the first batch of each point cross-checked on the card; every other curve
runs on the card.  On the card the kernel libraries are built before the
first curve, so no point's clock holds a build.  Without a card (and
without ``--device cpu``) it exits non-zero; ``--md-only`` needs none.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import torch

from ..decoder import default_device
from ..sim.sweep import SweepConfig, run_sweep

__all__ = ["CURVES", "BENCH_DIR", "DATA_DIR", "JAX_DATA_DIR", "curve_id",
           "card_name", "build_all", "point_record", "backend_name",
           "run_curve", "load_curves", "write_md", "main"]

# (code, algo, iters, snr_min, snr_max, snr_step, batch[, extra]): the JAX
# tool's table (``tools/run_ber_curves.py:40-114``); extra: more
# SweepConfig fields, its "tag" key (if any) suffixes the curve id and the
# section title instead
CURVES = [
    ("1944x972", "OMS", 10, 0.5, 2.75, 0.25, 8192),
    ("576x288", "OMS", 10, 0.5, 3.5, 0.5, 16384),
    ("2304x1152", "NMS", 10, 0.5, 2.5, 0.25, 8192),
    ("576x288", "2NMS", 10, 1.0, 3.5, 0.5, 16384),
    ("64800x32400", "OMS", 10, 1.0, 2.0, 0.125, 512),
    ("64800x21600", "OMS", 10, 1.75, 2.625, 0.125, 512),
    ("4000x2000", "OMS", 10, 1.0, 2.5, 0.25, 4096),
    ("2048x384", "OMS", 10, 3.25, 4.5, 0.25, 2048),
    ("576x288", "OMS", 10, 3.0, 7.0, 0.5, 8192,
     {"fading": "rayleigh", "tag": "rayleigh"}),
    ("576x288", "OMS", 5, 1.0, 4.0, 0.5, 16384),
    ("8000x4000", "OMS", 10, 1.0, 2.25, 0.25, 2048),
    ("9972x4986", "OMS", 10, 1.0, 2.0, 0.25, 2048),
    ("16200x7560", "OMS", 10, 1.0, 2.2, 0.2, 1024),
    ("4896x2448", "OMS", 10, 1.2, 2.4, 0.2, 2048,
     {"backend": "native", "channel_rng": "philox"}),
    ("20000x10000", "OMS", 10, 1.0, 2.0, 0.2, 512,
     {"backend": "native", "channel_rng": "philox"}),
    ("16200x10800", "OMS", 10, 1.8, 2.8, 0.2, 1024,
     {"tag": "zero-info", "count_bits": "info"}),
    ("16200x10800", "OMS", 10, 1.8, 2.8, 0.2, 1024,
     {"tag": "coded-info", "encoder": "table", "random_bits": True,
      "count_bits": "info"}),
    ("576x288", "OMS", 10, 3.51, 6.51, 0.5, 16384,
     {"tag": "qpsk-coded", "qpsk": True, "encoder": "gf2",
      "random_bits": True, "backend": "native",
      "channel_rng": "philox"}),
]

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH_DIR = os.path.join(_ROOT, "benchmarks_torch")
DATA_DIR = os.path.join(BENCH_DIR, "ber_data")
# the JAX book, read by path and never written
JAX_DATA_DIR = os.path.join(_ROOT, "benchmarks", "ber_data")

_TAG_TITLES = {
    "rayleigh": ", Rayleigh fading (perfect CSI)",
    "zero-info": ", all-zero codeword, info-bit counting",
    "coded-info": ", RANDOM info bits via the DVB table encoder, "
                  "info-bit counting",
    "qpsk-coded": ", QPSK, random GF(2)-encoded bits "
                  "(grid = BPSK grid + 3.01 dB)",
}


def curve_id(code: str, algo: str, iters: int, tag: str = "") -> str:
    base = f"{code}_{algo}_{iters}"
    return base + ("_" + tag if tag else "")


def card_name(device) -> Optional[str]:
    """``nvidia-smi``'s name and power limit of the card a run used, or
    None for a run on the CPU."""
    if torch.device(device).type != "cuda":
        return None
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def build_all() -> None:
    """Build the three decode kernels' libraries (one nvcc each, started
    together) and the native library, before any point's clock starts."""
    from ..golden import native
    from ..kernels import gather, layered, streamed

    with ThreadPoolExecutor(4) as pool:
        futures = [pool.submit(f) for f in (layered.build, gather.build,
                                            streamed.build, native.build)]
        for f in futures:
            f.result()


def point_record(p) -> dict:
    """A ``SnrPoint`` in the book's schema, with its rate and clock."""
    return {"snr_db": p.snr_db, "ber": p.ber, "fer": p.fer,
            "frames": p.frames, "fe": p.fe, "be": p.be, "mbps": p.mbps,
            "runtime_s": p.runtime_s}


def backend_name(cfg: SweepConfig, device) -> str:
    return (f"native+{cfg.channel_rng}" if cfg.backend == "native"
            else torch.device(device).type)


def run_curve(code, algo, iters, lo, hi, step, batch, max_fe, max_frames,
              timer_s=None, extra=None, device=None) -> dict:
    """One curve through ``run_sweep`` (early termination on, resumable
    from ``DATA_DIR/ckpt_<id>.json``, which ``main`` deletes once the
    curve is saved); returns its record in the book's schema."""
    device = torch.device(device) if device is not None else default_device()
    extra = dict(extra or {})
    tag = extra.pop("tag", "")
    ckpt_path = os.path.join(
        DATA_DIR, "ckpt_" + curve_id(code, algo, iters, tag) + ".json")
    cfg = SweepConfig(
        code=code, algo=algo, iters=iters, snr_min=lo, snr_max=hi,
        snr_step=step, batch=batch, max_fe=max_fe, max_frames=max_frames,
        timer_s=timer_s, early_term=True, checkpoint=ckpt_path,
        device=str(device), **extra,
    )
    print(f"== {code} {algo} {iters}it ==", flush=True)
    res = run_sweep(cfg, progress=True)
    return {
        "code": code, "algo": algo, "iters": iters, "tag": tag,
        "backend": backend_name(cfg, device),
        "card": card_name(device),
        "points": [point_record(p) for p in res.points],
    }


def load_curves(data_dir: str) -> list[dict]:
    curves = []
    if os.path.isdir(data_dir):
        for fn in sorted(os.listdir(data_dir)):
            if fn.endswith(".json") and not fn.startswith("ckpt_"):
                with open(os.path.join(data_dir, fn)) as f:
                    curves.append(json.load(f))
    order = {}
    for k, ent in enumerate(CURVES):
        tag = ent[7].get("tag", "") if len(ent) > 7 else ""
        order[curve_id(*ent[:3], tag)] = k
    curves.sort(key=lambda d: order.get(
        curve_id(d["code"], d["algo"], d["iters"], d.get("tag", "")), 99))
    return curves


def write_md() -> str:
    """Regenerate ``BENCH_DIR/BER.md`` from every curve in ``DATA_DIR``:
    one section a curve, its rows as the JAX book's, then the book held
    against the JAX book (``ber_check.compare_book``)."""
    from .ber_check import book_markdown

    curves = load_curves(DATA_DIR)
    cards = sorted({c["card"] for c in curves if c.get("card")})
    lines = [
        "# BER/FER waterfalls of the PyTorch + CUDA port\n",
        "\nMeasured on " + (" and ".join(cards) if cards else "no card")
        + " (`nvidia-smi` name, power limit), by "
        "`python -m ldpcgputegra_tpu_torch.bench.ber_curves` (the curves), "
        "`bench.ber_tail` (the tail anchors) and `bench.ber_topup` (deep "
        "points to a hard FE target).  AWGN, BPSK, all-zero codeword, "
        "factor-8 int8 LLRs (+/-31), adaptive FE limit, early termination "
        "on, except where a curve's title says otherwise.  The port's "
        "channel draws from PyTorch generators, not threefry, so the curves "
        "on the card agree with the JAX book (`benchmarks/BER.md`) "
        "statistically; the `native+philox` curves draw JAX's Philox noise "
        "byte for byte and decode on the host.  The last section holds each "
        "point against the JAX book's by an exact test "
        "(`bench.ber_check --book`).  The JAX book's analysis notes: "
        "[BER_NOTES.md](../benchmarks/BER_NOTES.md).\n",
    ]
    for cur in curves:
        title = f"{cur['code']} — {cur['algo']}, {cur['iters']} iterations"
        if cur.get("tag") in _TAG_TITLES:
            title += _TAG_TITLES[cur["tag"]]
        elif cur.get("tag"):
            title += f", {cur['tag']}"
        lines.append(f"\n## {title}\n\n")
        wall = sum(p.get("runtime_s", 0.0) for p in cur["points"])
        mbit = sum(p.get("mbps", 0.0) * p.get("runtime_s", 0.0)
                   for p in cur["points"])
        lines.append(
            f"`{cur.get('backend')}` on {cur.get('card') or 'no card'}: "
            f"{sum(p['frames'] for p in cur['points'])} frames in {wall:.1f} "
            "s of the points' clocks"
            + (f", {mbit / wall:.1f} coded Mbit/s" if wall else "") + ".\n\n")
        lines.append("| Eb/N0 (dB) | BER | FER | frames | FE |\n")
        lines.append("|---|---|---|---|---|\n")
        for p in cur["points"]:
            lines.append(
                f"| {p['snr_db']:.2f} | {p['ber']:.3e} | {p['fer']:.3e} "
                f"| {p['frames']} | {p['fe']} |\n")
    lines.append(book_markdown())
    os.makedirs(BENCH_DIR, exist_ok=True)
    out = os.path.join(BENCH_DIR, "BER.md")
    with open(out, "w") as f:
        f.writelines(lines)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default="", help="comma-separated curve ids")
    ap.add_argument("--max-fe", type=int, default=100)
    ap.add_argument("--max-frames", type=int, default=3_000_000)
    ap.add_argument("--timer-s", type=float, default=None,
                    help="per-point wall budget (default none: the FE and "
                    "frame limits rule)")
    ap.add_argument("--md-only", action="store_true",
                    help="regenerate BER.md from saved data, no decoding")
    ap.add_argument("--device", default=None,
                    help="default: the card (exits non-zero without one)")
    args = ap.parse_args(argv)

    os.makedirs(DATA_DIR, exist_ok=True)
    if not args.md_only:
        if args.device is None and not torch.cuda.is_available():
            print("ber_curves: no CUDA device", file=sys.stderr)
            return 1
        device = torch.device(args.device) if args.device else default_device()
        if device.type == "cuda":
            build_all()
        only = {s for s in args.only.split(",") if s}
        for ent in CURVES:
            extra = ent[7] if len(ent) > 7 else {}
            cid = curve_id(*ent[:3], extra.get("tag", ""))
            if only and cid not in only:
                continue
            t0 = time.perf_counter()
            data = run_curve(*ent[:7], args.max_fe, args.max_frames,
                             args.timer_s, extra=extra, device=device)
            wall = time.perf_counter() - t0
            with open(os.path.join(DATA_DIR, cid + ".json"), "w") as f:
                json.dump(data, f, indent=1)
            ckpt = os.path.join(DATA_DIR, "ckpt_" + cid + ".json")
            if os.path.exists(ckpt):  # the curve is saved; its ckpt is moot
                os.remove(ckpt)
            clocks = sum(p["runtime_s"] for p in data["points"])
            print(f"(PERF) {cid}: {wall:.1f} s wall, {clocks:.1f} s of the "
                  f"points' clocks | {data['card']}", flush=True)
            write_md()
    print(f"wrote {write_md()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The BER book on the card held against the JAX book: the port of the JAX
package's ``tools/ber_spotcheck.py``, with ``--book``.

    python -m ldpcgputegra_tpu_torch.bench.ber_check [--only CODE] [--device D]
    python -m ldpcgputegra_tpu_torch.bench.ber_check --book

For each of the four ``SPOTS`` (the JAX tool's table, verbatim; one point
of a flagship curve each):

1. **decoder**: batch 0's LLRs (the channel on the card, the sweep's
   generator for point 0, batch 0) go through the card's kernel (the
   ``auto`` backend) and through the plain PyTorch decoder on the card.
   Their bits and (BE, FE) counters must be identical, or the run aborts.
2. **channel across backends** is not ported: PyTorch's CPU and CUDA
   generators are different streams, so there is no pair of backends
   drawing the same noise to compare; and the native Philox channel
   (``golden/native.py``) is already JAX's byte for byte
   (``tests/test_torch_native.py``).
3. **end to end**: ``run_sweep`` on the card at the spot (one point, a
   frame budget of ``nb`` batches, no FE stop) is tested against the JAX
   book's stored point (``benchmarks/ber_data/``, read by path).

The test (``exact_p``) is an exact two-sided conditional test on the two
frame-error counts: if both FERs are equal, then given FE1 + FE2,
FE1 ~ Binomial(FE1 + FE2, n1 / (n1 + n2)); p sums the probabilities of the
outcomes no likelier than the observed one (``scipy.stats.binomtest``'s
rule, written here with ``math.lgamma``).  It is valid at any counts, 0 on
either side included.  A point fails at p < ``P_FAIL`` (1e-4, about 4
sigma two-sided).  BER is reported as a ratio and not tested: bit errors
come in clusters a frame, so they are not binomial.

The sweep keys its noise by the point's index in the grid, so a spot run
as a one-point sweep draws other noise than the same SNR inside a curve:
the test is statistical for that reason.

``--book`` tests every point of ``benchmarks_torch/ber_data/`` against the
JAX book's point with the same curve id and SNR, and the 16200x10800
``coded-info`` twin against its ``zero-info`` twin point by point (the JAX
book has no file for them); lists the points without a counterpart (a tail
anchor on the card may land on another SNR than JAX's: its ladder walks
other noise); prints how many points fall below p = 0.01 (about 1% are
expected there if the test is calibrated) and below ``P_FAIL``; rewrites
``benchmarks_torch/BER.md``, whose last section is this table.  Any
failing point, or a spot's mismatch, exits 1.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

import torch

from . import ber_curves
from .ber_curves import card_name, curve_id

__all__ = ["SPOTS", "TWINS", "P_FAIL", "P_WATCH", "exact_p", "stored_point",
           "compare_book", "book_markdown", "decoder_stage", "sweep_stage",
           "check_spot", "main"]

# (code, algo, iters, snr, batch, n_batches): the JAX tool's table
# (``tools/ber_spotcheck.py:41-46``); each SNR sits on its stored curve's grid
SPOTS = [
    ("1944x972", "OMS", 10, 2.0, 8192, 2),
    ("576x288", "OMS", 10, 2.5, 16384, 2),
    ("4000x2000", "OMS", 10, 2.0, 4096, 2),
    ("64800x32400", "OMS", 10, 1.625, 512, 4),
]
# a curve held against another curve of the port's book, not the JAX book's
TWINS = {"16200x10800_OMS_10_coded-info": "16200x10800_OMS_10_zero-info"}
P_FAIL = 1e-4
P_WATCH = 0.01


def exact_p(fe1: int, n1: int, fe2: int, n2: int) -> float:
    """Two-sided p of FE1 errors in n1 frames against FE2 in n2 under one
    FER: FE1 ~ Binomial(FE1 + FE2, n1 / (n1 + n2)) given the sum, p the
    sum of the outcomes' probabilities that are at most the observed one's
    (with ``binomtest``'s relative slack of 1e-7)."""
    if n1 <= 0 or n2 <= 0:
        raise ValueError(f"frame counts must be positive: {n1}, {n2}")
    m = fe1 + fe2
    if m == 0:
        return 1.0
    q = n1 / (n1 + n2)
    lq, lr, c = math.log(q), math.log1p(-q), math.lgamma(m + 1)

    def logpmf(i: int) -> float:
        return (c - math.lgamma(i + 1) - math.lgamma(m - i + 1)
                + i * lq + (m - i) * lr)

    lim = logpmf(fe1) + math.log1p(1e-7)
    total = 0.0
    for i in range(m + 1):
        lp = logpmf(i)
        if lp <= lim:
            total += math.exp(lp)
    return min(1.0, total)


def _point_at(points: list[dict], snr: float):
    for p in points:
        if abs(p["snr_db"] - snr) < 1e-9:
            return p
    return None


def stored_point(code, algo, iters, snr):
    """The JAX book's point of a curve at ``snr``, or None."""
    path = os.path.join(ber_curves.JAX_DATA_DIR,
                        curve_id(code, algo, iters) + ".json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return _point_at(json.load(f)["points"], snr)


def compare_book() -> tuple[list[dict], list[str]]:
    """Every point of the port's book (``ber_curves.DATA_DIR``) beside its
    counterpart: (rows, the points that have none)."""
    curves = {curve_id(c["code"], c["algo"], c["iters"], c.get("tag", "")): c
              for c in ber_curves.load_curves(ber_curves.DATA_DIR)}
    twin_refs = set(TWINS.values())
    rows, unmatched = [], []
    for cid, cur in curves.items():
        if cid in twin_refs:
            continue  # held as the reference of its twin below
        if cid in TWINS:
            ref_id, ref_pts = TWINS[cid], curves.get(TWINS[cid], {}).get(
                "points", [])
        else:
            ref_id = "JAX"
            path = os.path.join(ber_curves.JAX_DATA_DIR, cid + ".json")
            ref_pts = []
            if os.path.exists(path):
                with open(path) as f:
                    ref_pts = json.load(f)["points"]
        for p in cur["points"]:
            ref = _point_at(ref_pts, p["snr_db"])
            if ref is None:
                unmatched.append(f"{cid} @ {p['snr_db']:g} dB")
                continue
            rows.append({
                "curve": cid, "snr_db": p["snr_db"], "frames": p["frames"],
                "fe": p["fe"], "fer": p["fer"], "ber": p["ber"],
                "mbps": p.get("mbps"), "runtime_s": p.get("runtime_s"),
                "backend": p.get("backend", cur.get("backend")),
                "against": ref_id, "ref_frames": ref["frames"],
                "ref_fe": ref["fe"], "ref_fer": ref["fer"],
                "ber_ratio": (p["ber"] / ref["ber"] if ref["ber"] > 0
                              else None),
                "p": exact_p(p["fe"], p["frames"], ref["fe"], ref["frames"]),
            })
    for cid in twin_refs & curves.keys():
        twin = next(t for t, r in TWINS.items() if r == cid)
        twin_pts = curves.get(twin, {}).get("points", [])
        unmatched += [f"{cid} @ {p['snr_db']:g} dB"
                      for p in curves[cid]["points"]
                      if _point_at(twin_pts, p["snr_db"]) is None]
    return rows, unmatched


def _summary(rows) -> str:
    return (f"{len(rows)} points tested: "
            f"{sum(r['p'] < P_WATCH for r in rows)} below p = {P_WATCH}, "
            f"{sum(r['p'] < P_FAIL for r in rows)} below p = {P_FAIL} "
            "(failing)")


def book_markdown() -> str:
    """The section of ``BER.md`` that holds the book against the JAX
    book."""
    rows, unmatched = compare_book()
    out = [
        "\n## Against the JAX book\n\n",
        "Each point of this book beside the JAX book's point of the same "
        "curve and SNR (`benchmarks/ber_data/`; for the 16200x10800 "
        "`coded-info` curve, its `zero-info` twin), with the exact "
        "two-sided conditional test's p on the two frame-error counts "
        f"(`bench/ber_check.py`; a point fails at p < {P_FAIL}).  BER is "
        "shown as a ratio, untested.  The `coded-info` twin's BER runs "
        "above its `zero-info` twin's at equal FER by the hard decision's "
        "tie: an APP of 0 decides bit 0, an error at a codeword 1 that the "
        "all-zero twin does not make; min-sum is otherwise sign-symmetric, "
        "and those positions are the whole gap in both packages "
        "(`tests/test_torch_coded_info_jax.py`): the reference's "
        "convention, not a fault.  Coded Mbit/s and seconds are the "
        "point's own clock (on the host for `native+philox`).  "
        f"{_summary(rows)}.\n\n",
        "| curve | Eb/N0 | backend | frames | FE | FER | Mbit/s | s | against "
        "| frames | FE | FER | BER ratio | p |\n",
        "|---|---|---|---|---|---|---|---|---|---|---|---|---|---|\n",
    ]
    for r in rows:
        mbps = "—" if r["mbps"] is None else f"{r['mbps']:.1f}"
        sec = "—" if r["runtime_s"] is None else f"{r['runtime_s']:.1f}"
        ratio = "—" if r["ber_ratio"] is None else f"{r['ber_ratio']:.3f}"
        flag = " **fails**" if r["p"] < P_FAIL else ""
        out.append(
            f"| {r['curve']} | {r['snr_db']:g} | {r['backend']} "
            f"| {r['frames']} | {r['fe']} | {r['fer']:.3e} | {mbps} | {sec} "
            f"| {r['against']} | {r['ref_frames']} | {r['ref_fe']} "
            f"| {r['ref_fer']:.3e} | {ratio} | {r['p']:.3g}{flag} |\n")
    if unmatched:
        out.append("\nPoints without a counterpart: "
                   + "; ".join(unmatched) + ".\n")
    return "".join(out)


def _counts(bits: torch.Tensor) -> tuple[int, int]:
    from ..sim.analyzer import count_errors_async

    be, fe = count_errors_async(bits)
    return int(be), int(fe)


def decoder_stage(code_name, algo, iters, snr, batch, device) -> dict:
    """Stage 1: batch 0's LLRs through the ``auto`` backend's kernel and
    the plain decoder on ``device``; raises ``SystemExit`` unless bits and
    counters agree."""
    from ..channel.awgn import AwgnChannel
    from ..codes.registry import load_code
    from ..decoder import backend_for, make_decoder
    from ..ops.layered import LayeredSpec
    from ..sim.sweep import SweepConfig, batch_seed

    code = load_code(code_name)
    spec = LayeredSpec(algo=algo, iters=iters, early_term=True)
    chan = AwgnChannel(code.N, code.K, device=device)
    chan.configure(snr)
    llr = chan.generate_zero_int8(
        chan.generator(batch_seed(SweepConfig.seed, 0, 0)), batch)
    kbits, _ = make_decoder(code, spec, device=device)(llr)
    pbits, _ = make_decoder(code, spec, backend="torch", device=device)(llr)
    kernel, plain = _counts(kbits), _counts(pbits)
    if kernel != plain or not torch.equal(kbits, pbits):
        raise SystemExit(f"{code_name} {snr} dB: the kernel's counters "
                         f"{kernel} differ from the plain decoder's {plain} "
                         "on the same LLRs")
    return {"backend": backend_for(code, spec, device), "be": kernel[0],
            "fe": kernel[1]}


def sweep_stage(spot, device) -> dict:
    """Stage 3 of one spot: ``run_sweep`` at the spot, its record with
    ``p`` against the JAX book's point (None where the book has none)."""
    from ..sim.sweep import SweepConfig, run_sweep

    code, algo, iters, snr, batch, nb = spot
    cfg = SweepConfig(code=code, algo=algo, iters=iters, snr_min=snr,
                      snr_max=snr, snr_step=1.0, batch=batch,
                      max_frames=nb * batch, max_fe=10**9, auto_fe=False,
                      early_term=True, device=str(device))
    (p,) = run_sweep(cfg, progress=False).points
    rec = {"code": code, "algo": algo, "iters": iters, "snr_db": snr,
           "batch": batch, "frames": p.frames, "be": p.be, "fe": p.fe,
           "fer": p.fer, "mbps": p.mbps, "stored_frames": None,
           "stored_fe": None, "stored_fer": None, "p": None}
    st = stored_point(code, algo, iters, snr)
    if st is not None:
        rec.update(stored_frames=st["frames"], stored_fe=st["fe"],
                   stored_fer=st["fer"],
                   p=exact_p(p.fe, p.frames, st["fe"], st["frames"]))
    return rec


def check_spot(spot, device) -> dict:
    """Stages 1 and 3 of one spot: ``sweep_stage``'s record with stage
    1's counters under ``decoder_batch0``."""
    code, algo, iters, snr, batch, _ = spot
    dec = decoder_stage(code, algo, iters, snr, batch, device)
    return {**sweep_stage(spot, device), "decoder_batch0": dec}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=None,
                    help="substring filter on a spot's code name")
    ap.add_argument("--book", action="store_true",
                    help="test the whole book against the JAX book")
    ap.add_argument("--device", default=None,
                    help="default: the card (exits non-zero without one)")
    args = ap.parse_args(argv)

    if args.book:
        rows, unmatched = compare_book()
        for r in rows:
            print(f"(BOOK) {r['curve']} {r['snr_db']:g} dB: {r['fe']}/"
                  f"{r['frames']} against {r['against']} {r['ref_fe']}/"
                  f"{r['ref_frames']}: p = {r['p']:.4g}"
                  + (" FAILS" if r["p"] < P_FAIL else ""))
        for u in unmatched:
            print(f"(BOOK) no counterpart: {u}")
        print(f"(BOOK) {_summary(rows)}; {len(unmatched)} without a "
              "counterpart")
        print(f"wrote {ber_curves.write_md()}")
        return 1 if any(r["p"] < P_FAIL for r in rows) else 0

    if args.device is None and not torch.cuda.is_available():
        print("ber_check: no CUDA device", file=sys.stderr)
        return 1
    from ..decoder import default_device

    device = torch.device(args.device) if args.device else default_device()
    card = card_name(device)
    failed = False
    for spot in SPOTS:
        if args.only and args.only not in spot[0]:
            continue
        rec = check_spot(spot, device)
        print("(SPOT) " + json.dumps({**rec, "card": card}), flush=True)
        failed |= rec["p"] is not None and rec["p"] < P_FAIL
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())

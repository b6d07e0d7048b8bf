"""Measure chosen points of a saved curve again to a hard FE target and
merge them into ``benchmarks_torch/ber_data/<id>.json``, then regenerate
``BER.md``: the port of the JAX package's ``tools/topup_points.py``.

    python -m ldpcgputegra_tpu_torch.bench.ber_topup --curve 1944x972_OMS_10 \\
        --snr 2.5 --snr 2.75 [--max-fe 100] [--max-frames 40000000] \\
        [--batch 8192] [--backend auto] [--channel-rng threefry] [--device D]

The curves' adaptive FE limit (``auto_fe``) stops deep points at 6-50
frame errors; a top-up runs with ``auto_fe=False`` and no wall budget, so
``--max-fe`` is the stopping rule and ``--max-frames`` the budget.  Each
point keeps its own checkpoint until it is merged.  A merged point carries
its own ``"backend"`` (the device type, or ``native+<rng>``) and the
card's name and power limit.  Without a card (and without ``--device
cpu``) it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from . import ber_curves
from ..decoder import default_device
from ..sim.sweep import SweepConfig, run_sweep

__all__ = ["merge_point", "main"]


def merge_point(points: list[dict], rec: dict) -> bool:
    """Merge ``rec`` into the curve's point list, in place.

    A point at the same SNR is replaced only if ``rec`` saw at least as
    many frame errors (ties broken by frame count): a truncated or
    interrupted run never replaces better statistics.  Returns True if
    ``rec`` was inserted or replaced a point, False if the old point won.
    """
    for i, old in enumerate(points):
        if abs(old["snr_db"] - rec["snr_db"]) < 1e-9:
            if (rec["fe"], rec["frames"]) >= (old["fe"], old["frames"]):
                points[i] = rec
                points.sort(key=lambda r: r["snr_db"])
                return True
            return False
    points.append(rec)
    points.sort(key=lambda r: r["snr_db"])
    return True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--curve", required=True,
                    help="curve id, e.g. 1944x972_OMS_10")
    ap.add_argument("--snr", action="append", type=float, required=True,
                    help="SNR point to measure again (repeatable)")
    ap.add_argument("--max-fe", type=int, default=100)
    ap.add_argument("--max-frames", type=int, default=40_000_000)
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--backend", default="auto",
                    help="auto | native (the AVX-512 host decoder)")
    ap.add_argument("--channel-rng", default="threefry",
                    choices=["threefry", "philox"],
                    help="with --backend native: philox = the native "
                    "counter-based channel")
    ap.add_argument("--device", default=None,
                    help="default: the card (exits non-zero without one)")
    args = ap.parse_args(argv)
    if args.device is None and not torch.cuda.is_available():
        print("ber_topup: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device(args.device) if args.device else default_device()
    code, algo, iters = args.curve.rsplit("_", 2)
    path = os.path.join(ber_curves.DATA_DIR, args.curve + ".json")
    with open(path) as f:
        data = json.load(f)
    if device.type == "cuda":
        ber_curves.build_all()
    for snr in args.snr:
        ckpt_path = os.path.join(ber_curves.DATA_DIR,
                                 f"ckpt_topup_{args.curve}_{snr}.json")
        cfg = SweepConfig(
            code=code, algo=algo, iters=int(iters), snr_min=snr, snr_max=snr,
            snr_step=1.0, batch=args.batch, max_fe=args.max_fe,
            auto_fe=False, max_frames=args.max_frames, early_term=True,
            checkpoint=ckpt_path, backend=args.backend,
            channel_rng=args.channel_rng, device=str(device),
        )
        (p,) = run_sweep(cfg, progress=True).points
        rec = {**ber_curves.point_record(p),
               "backend": ber_curves.backend_name(cfg, device),
               "card": ber_curves.card_name(device)}
        if not merge_point(data["points"], rec):
            print(f"(WW) keeping the old point at {p.snr_db} dB (it saw "
                  "more frame errors than this run)")
        with open(path, "w") as f:  # saved after every point
            json.dump(data, f, indent=1)
        if os.path.exists(ckpt_path):  # merged: the checkpoint is moot
            os.remove(ckpt_path)
        print(f"(II) {p.snr_db} dB: BER {p.ber:.3e} on {p.fe} FE / "
              f"{p.frames} frames, {p.mbps:.1f} coded Mbit/s in "
              f"{p.runtime_s:.1f} s | {rec['card']}", flush=True)
    print(f"wrote {ber_curves.write_md()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

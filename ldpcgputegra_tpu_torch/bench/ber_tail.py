"""One waterfall anchor point for each registry code that no curve of the
book covers: the port of the JAX package's ``tools/tail_ber_points.py``.

    python -m ldpcgputegra_tpu_torch.bench.ber_tail [--only NAME,NAME]
        [--max-fe 100] [--max-frames 500000] [--device cuda]

For each code of ``TAIL`` (the JAX tool's table, verbatim):

1. walk up a 0.5 dB ladder from its start with 4 batches a probe until
   the FER lands in the waterfall (at most 0.3; a probe below 0.02 with
   fewer than 5 frame errors overshot the cliff and steps 0.25 dB back);
2. measure that point to ``--max-fe`` frame errors (no adaptive FE limit;
   ``--max-frames`` caps it, 50,000 frames for the 64800-bit codes);
3. save it as a one-point curve, tag ``tail-anchor``, to
   ``benchmarks_torch/ber_data/`` and regenerate ``BER.md``.

The native host decoder with the Philox channel (JAX's noise byte for
byte) takes every code it accepts, the first batch of each point checked
on the card; the staircase codes, whose QC views it refuses, decode on the
card (K2).  A failed build of the native library raises.  Without a card
(and without ``--device cpu``) it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import traceback

import torch

from . import ber_curves
from ..decoder import default_device
from ..sim.sweep import SweepConfig, run_sweep

__all__ = ["TAIL", "anchor", "main"]

# (name, batch, snr_start_db): the JAX tool's table
# (``tools/tail_ber_points.py:39-54``); start below the expected waterfall
TAIL = [
    ("155x93", 4096, 2.5),
    ("200x100", 4096, 2.5),
    ("816x408", 4096, 1.5),
    ("1024x518", 4096, 1.5),
    ("1200x600", 4096, 1.5),
    ("1248x624", 4096, 1.5),
    ("2640x1320", 2048, 1.0),
    ("802_11e_576x288", 8192, 2.0),
    ("802_11e_1920x960", 4096, 1.5),
    ("802_11e_2304x1152", 4096, 1.5),
    ("802_11n-1944x972", 4096, 1.5),
    ("64800x32400-dvbs2", 256, 1.0),
    ("64800x7200-dvbs2", 256, 3.0),
    ("64800x6480-dvbs2", 256, 3.5),
]


def _point(name, batch, snr, max_fe, max_frames, backend, device, ckpt=None):
    cfg = SweepConfig(
        code=name, algo="OMS", iters=10, early_term=True,
        snr_min=snr, snr_max=snr, snr_step=0.5, batch=batch,
        max_fe=max_fe, auto_fe=False, max_frames=max_frames,
        backend=backend,
        channel_rng="philox" if backend == "native" else "threefry",
        checkpoint=ckpt, device=str(device),
    )
    return run_sweep(cfg, progress=False).points[0]


def _backend_for(name: str, device) -> str:
    """``native`` where the native decoder takes the code, else ``auto``
    (the card).  Only the sweep's refusal of a staircase code's QC view
    (``NotImplementedError``) is caught: a failed build raises."""
    try:
        _point(name, 128, 10.0, 1_000_000, 128, "native", device)
        return "native"
    except NotImplementedError as e:
        print(f"(II) {name}: the native decoder refuses it ({e}); decoding "
              "on the device", flush=True)
        return "auto"


def anchor(name: str, batch: int, snr0: float, max_fe: int, max_frames: int,
           device=None) -> dict | None:
    """The anchor of one code, saved; None if no waterfall was found in
    6 dB above ``snr0``."""
    device = torch.device(device) if device is not None else default_device()
    backend = _backend_for(name, device)
    snr = snr0
    probe_frames = 4 * batch
    chosen = None
    for _ in range(12):
        p = _point(name, batch, snr, 10**9, probe_frames, backend, device)
        print(f"(II) {name} probe {snr:.2f} dB: FER {p.fer:.3g} "
              f"({p.fe}/{p.frames})", flush=True)
        if p.fer <= 0.3:
            if p.fer >= 0.02 or p.fe >= 5:
                chosen = snr
            else:
                chosen = snr - 0.25  # overshot the cliff: step half back
            break
        snr += 0.5
    if chosen is None:
        print(f"(EE) {name}: no waterfall found in 6 dB above {snr0}",
              flush=True)
        return None
    cid = f"{name}_OMS_10_tail-anchor"
    ckpt = os.path.join(ber_curves.DATA_DIR, "ckpt_" + cid + ".json")
    p = _point(name, batch, chosen, max_fe, max_frames, backend, device, ckpt)
    rec = {
        "code": name, "algo": "OMS", "iters": 10, "tag": "tail-anchor",
        "backend": ("native+philox" if backend == "native"
                    else torch.device(device).type),
        "card": ber_curves.card_name(device),
        "points": [ber_curves.point_record(p)],
    }
    with open(os.path.join(ber_curves.DATA_DIR, cid + ".json"), "w") as f:
        json.dump(rec, f, indent=1)
    if os.path.exists(ckpt):
        os.remove(ckpt)
    print(f"(PERF) {json.dumps(rec)}", flush=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default="", help="comma-separated code names")
    ap.add_argument("--max-fe", type=int, default=100)
    ap.add_argument("--max-frames", type=int, default=500_000)
    ap.add_argument("--device", default=None,
                    help="default: the card (exits non-zero without one)")
    args = ap.parse_args(argv)
    if args.device is None and not torch.cuda.is_available():
        print("ber_tail: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device(args.device) if args.device else default_device()
    if device.type == "cuda":
        ber_curves.build_all()
    os.makedirs(ber_curves.DATA_DIR, exist_ok=True)
    only = {s for s in args.only.split(",") if s}
    failed = []
    for name, batch, snr0 in TAIL:
        if only and name not in only:
            continue
        cap = args.max_frames if "64800" not in name else 50_000
        try:
            if anchor(name, batch, snr0, args.max_fe, cap, device) is None:
                failed.append(name)
        except Exception:  # noqa: BLE001 - the other anchors still run
            traceback.print_exc()
            failed.append(name)
    print(f"wrote {ber_curves.write_md()}")
    if failed:
        print(f"(EE) no anchor for: {', '.join(failed)}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Wall-clock rate, host-loop spans and device busy share of one SNR point
of ``run_sweep`` on the card.

    python -m ldpcgputegra_tpu_torch.bench.sweep_trace --code 64800x32400 \\
        --batch 512 --snr 2.0 --frames 8192 [--scan-steps 8] [--encoder gf2]

Runs the point once to warm up, then twice untraced (host clock around
``run_sweep``, which ends in a host fetch of the counts: frames and coded
Mbit/s per wall-clock second, and the sweep's window spans: the host time
spent dispatching and waiting on the fetch of the counts, summed over the
point's windows, with the batches a window), then once under
``torch.profiler``: the device time summed over the device's own events
(kernels, copies, sets), its share of the traced wall time, and the share
of each kernel.  Prints the card's name and power limit beside the
numbers.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time

import torch

from ..codes.registry import load_code
from ..sim.sweep import SweepConfig, run_sweep
from .harness import device_time_by_kernel


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--code", default="64800x32400")
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--snr", type=float, default=2.0)
    ap.add_argument("--frames", type=int, default=8192)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--scan-steps", type=int, default=1,
                    help="fake-encoder batches a dispatch (a CUDA graph)")
    ap.add_argument("--encoder", default="fake",
                    choices=["fake", "table", "staircase", "gf2", "auto"])
    ap.add_argument("--schedule", default="auto",
                    choices=["auto", "reference", "colored", "flooding"])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sweep_trace: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    cfg = SweepConfig(code=args.code, iters=args.iters, early_term=True,
                      batch=args.batch, snr_min=args.snr, snr_max=args.snr,
                      max_fe=10**9, max_frames=args.frames, device="cuda",
                      scan_steps=args.scan_steps, encoder=args.encoder,
                      schedule=args.schedule)
    n = load_code(args.code).N
    tag = (f"{args.code} B={args.batch} OMS {args.iters} ET on "
           f"{args.snr} dB, scan_steps {args.scan_steps}, encoder "
           f"{args.encoder}, schedule {args.schedule}")

    def point():
        spans = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (p,) = run_sweep(cfg, progress=False,
                         on_window=lambda *w: spans.append(w)).points
        torch.cuda.synchronize()
        return p, time.perf_counter() - t0, spans

    point()  # warm-up: kernel build and load, allocator pools
    for _ in range(2):
        p, wall, spans = point()
        disp = sum(w[0] for w in spans)
        fetch = sum(w[1] for w in spans)
        print(f"[sweep] {tag}: {p.frames} frames ({p.batches} batches) in "
              f"{wall:.4f} s untraced, {p.frames / wall:.1f} frames/s, "
              f"{p.frames * n / wall / 1e6:.1f} coded "
              f"Mbit/s ({p.mbps:.1f} by the point's own clock, without the "
              f"set-up), FER {p.fer:.4e}, BER {p.ber:.4e} | {smi}")
        print(f"[spans] {tag}: {len(spans)} windows, "
              f"{p.batches / max(len(spans), 1):.2f} batches a window; "
              f"dispatch {disp * 1e3:.3f} ms ({disp / wall:.3f} of the wall, "
              f"{disp * 1e3 / p.batches:.4f} ms a batch), fetch wait "
              f"{fetch * 1e3:.3f} ms ({fetch / wall:.3f}, "
              f"{fetch * 1e3 / p.batches:.4f} ms a batch) | {smi}")
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act) as prof:
        p, wall, _ = point()
    dev_us = device_time_by_kernel(prof)
    total = sum(dev_us.values())
    print(f"[trace] {tag}: traced wall {wall:.4f} s, device time "
          f"{total / 1e3:.3f} ms, device busy {total / 1e6 / wall:.3f} of the "
          f"traced wall | {smi}")
    for key, us in sorted(dev_us.items(), key=lambda kv: -kv[1])[:8]:
        print(f"[trace]   {us / max(total, 1e-9):7.2%} {us / 1e3:10.3f} ms "
              f"{key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

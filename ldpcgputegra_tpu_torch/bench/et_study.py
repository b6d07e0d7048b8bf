"""Two-phase early termination against the kernels' own early termination,
on the card: the port of ``tools/run_et_pipelined.py`` with the
``kernel_et`` row of ``tools/run_et_study.py``.

    python -m ldpcgputegra_tpu_torch.bench.et_study [--only SUBSTRING]
        [--out bench_results/et_study.jsonl] [--trace]

For each of the 13 operating points in ``CONFIGS`` (code, batch, Eb/N0,
algorithm, k1), four ways of decoding a window of ``N_BATCH`` batches at a
budget of 10 iterations, each timed by the host clock from a synchronised
card to a synchronised card, every batch queued before the one wait, the
fastest of ``REPEATS`` windows of disjoint inputs:

* ``fixed10``: 10 iterations, no early termination;
* ``kernel_et``: 10 iterations with ``early_term=True`` (a codeword
  freezes once its parity clears, a CTA ends once its tile has), with the
  ``iters_used`` of its batches;
* ``twophase`` pipelined (``decode.pipelined``: every phase 1 queued, one
  read of the counts, then each batch's phase 2 at its bucket);
* ``twophase`` fused (``decode.pipelined_fused``: phase 2 at a fixed tail,
  1.5 x the warm window's mean unconverged count rounded up to 128, the
  overflowing batches decoded again after the window's read).

Rates are coded Mbit/s per wall-clock second (frames x N / window).  The
channel is ``AwgnChannel`` with a generator seeded per (point, window,
batch).  One JSON line a point goes to standard output and is appended to
``--out`` (git-ignored), with the card's name and power limit.  Needs a
CUDA device; without one it exits non-zero and writes nothing.
``--trace`` then runs one more pipelined two-phase window of each point
under ``torch.profiler`` and prints its device time by kernel and the
device's busy share of the traced wall.  Nothing
is routed from these numbers: ``run_sweep`` keeps the kernels' early
termination.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import torch

from ..channel.awgn import AwgnChannel
from ..codes.registry import load_code
from ..decoder import backend_for, make_decoder
from ..decoder.twophase import make_twophase_decoder
from ..ops.layered import LayeredSpec
from .harness import device_time_by_kernel

# (code, batch, Eb/N0 dB, algo, k1): the JAX study's operating points; the
# second SNR of a code is its P(converged within 5 iterations) >= 0.99
# point, and the k1 = 6, 7 rows its fat-tail points
CONFIGS = [
    ("576x288", 16384, 3.0, "2NMS", 5),
    ("576x288", 16384, 3.5, "2NMS", 5),
    ("1944x972", 8192, 2.75, "2NMS", 5),
    ("1944x972", 8192, 3.25, "2NMS", 5),
    ("1944x972", 8192, 3.5, "2NMS", 5),
    ("2304x1152", 8192, 2.5, "2NMS", 5),
    ("2304x1152", 8192, 2.5, "2NMS", 6),
    ("2304x1152", 8192, 3.0, "2NMS", 5),
    ("2304x1152", 8192, 3.5, "2NMS", 5),
    ("4000x2000", 4096, 2.25, "2NMS", 5),
    ("4000x2000", 4096, 2.25, "2NMS", 6),
    ("4000x2000", 4096, 2.25, "2NMS", 7),
    ("576x288", 16384, 3.0, "OMS", 5),
]
N_BATCH = 96
REPEATS = 3
OUT = os.path.join("bench_results", "et_study.jsonl")


def _timed(fn, dev):
    """(seconds, result) of ``fn()`` from a synchronised card to a
    synchronised card."""
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize(dev)
    return time.perf_counter() - t0, out


def study_one(ci: int, name: str, batch: int, snr: float, algo: str, k1: int,
              dev, trace: bool = False) -> dict:
    """The four rows at one operating point (``ci`` its index in
    ``CONFIGS``, which seeds its windows)."""
    code = load_code(name)
    spec = LayeredSpec(algo=algo, iters=10,
                       minclamp="pre" if algo == "OMS" else "post")
    spec_et = dataclasses.replace(spec, early_term=True)
    d10 = make_decoder(code, spec, device=dev)
    det = make_decoder(code, spec_et, device=dev)
    tp = make_twophase_decoder(code, spec, k1=k1, device=dev)
    chan = AwgnChannel(code.N, code.K, device=dev)
    chan.configure(snr)

    def window(r: int):
        seed0 = (ci * (4 * REPEATS + 1) + r) * N_BATCH
        return [chan.generate_zero_int8(chan.generator(seed0 + i), batch)
                for i in range(N_BATCH)]

    # warm-up window: builds, allocator pools, and the fused tail from the
    # mean unconverged count
    w = window(0)
    tp.warm_buckets(w[0])
    _, warm_agg = tp.pipelined(w)
    for x in w:
        d10(x)
        det(x)
    mean_bad = warm_agg["phase2_frames"] / len(w)
    ftail = max(128, -(-int(1.5 * mean_bad + 1) // 128) * 128)
    tp.warm_fused(w[0], ftail)
    del w

    def best(r0: int, run):
        """The fastest of REPEATS windows r0 .. r0 + REPEATS - 1:
        (seconds, what ``run`` returned for it)."""
        out = (float("inf"), None)
        for r in range(r0, r0 + REPEATS):
            llrs = window(r)
            sec, res = _timed(lambda: run(llrs), dev)
            if sec < out[0]:
                out = (sec, res)
            del llrs
        return out

    p_sec, p_agg = best(1, lambda llrs: tp.pipelined(llrs)[1])
    f_sec, _ = best(REPEATS + 1, lambda llrs: [d10(x)[0] for x in llrs])
    e_sec, e_its = best(2 * REPEATS + 1,
                        lambda llrs: torch.stack([det(x)[1] for x in llrs]))
    u_sec, u_agg = best(3 * REPEATS + 1,
                        lambda llrs: tp.pipelined_fused(llrs, ftail)[1])
    e_its = e_its.tolist()
    mbit = N_BATCH * batch * code.N / 1e6
    rec = {
        "code": name, "algo": algo, "snr_db": snr, "k1": k1, "batch": batch,
        "n_batches": N_BATCH, "backend": backend_for(code, spec, dev),
        "fixed10_mbps": mbit / f_sec,
        "kernel_et_mbps": mbit / e_sec,
        "kernel_et_iters_mean": sum(e_its) / len(e_its),
        "kernel_et_iters_max": max(e_its),
        "pipelined_twophase_mbps": mbit / p_sec,
        "fused_twophase_mbps": mbit / u_sec,
        "fused_tail": ftail,
        "fused_overflows": u_agg["overflows"],
        "eff_iters_per_frame": p_agg["eff_iters_per_frame"],
        "eff_iters_fused": u_agg["eff_iters_per_frame"],
        "phase2_frac": p_agg["phase2_frames"] / p_agg["frames"],
        "wall_s": {"fixed10": f_sec, "kernel_et": e_sec,
                   "pipelined": p_sec, "fused": u_sec},
    }
    twophase = max(rec["pipelined_twophase_mbps"], rec["fused_twophase_mbps"])
    rec["twophase_vs_kernel_et"] = twophase / rec["kernel_et_mbps"]
    rec["twophase_vs_fixed10"] = twophase / rec["fixed10_mbps"]
    if trace:
        llrs = window(4 * REPEATS + 1)
        act = [torch.profiler.ProfilerActivity.CPU,
               torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=act) as prof:
            wall, _ = _timed(lambda: tp.pipelined(llrs), dev)
        share: dict[str, float] = {}  # by the name's first 60 characters
        total = 0.0
        for key, us in device_time_by_kernel(prof).items():
            share[key[:60]] = share.get(key[:60], 0.0) + us
            total += us
        rec["trace"] = {"wall_s": wall, "device_s": total / 1e6,
                        "busy": total / 1e6 / wall,
                        "top": {k: us / total for k, us in sorted(
                            share.items(), key=lambda kv: -kv[1])[:8]}}
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=None,
                    help="substring filter on 'code@snr/algo/kK'")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--trace", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("et_study: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"[et_study] {smi}", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    for ci, (name, batch, snr, algo, k1) in enumerate(CONFIGS):
        if args.only and args.only not in f"{name}@{snr}/{algo}/k{k1}":
            continue
        rec = {**study_one(ci, name, batch, snr, algo, k1, dev, args.trace),
               "device": smi}
        line = json.dumps(rec)
        print(line, flush=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

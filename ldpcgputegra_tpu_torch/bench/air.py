"""The whole simulation loop's rate on the card ("air throughput"), by
pipeline depth, with a per-stage breakdown: the port of the JAX package's
``tools/run_air_bench.py``.

    python -m ldpcgputegra_tpu_torch.bench.air [--quick] [--out PATH]

The reference's headline metric is the full loop (noise generation,
decode, error count; ``code/gpu_fixed/main.cpp:305-318``), with a
per-stage breakdown (``paper/ldpcGpuTegra.tex:298``).  For each of the
four ``CONFIGS`` (one per decode kernel family, the JAX tool's table),
OMS 10 iterations, no early termination, at ``SNR_DB``:

* the stage table: the channel (the all-zero codeword to int8 LLRs), the
  decode, the count and the whole step, each timed on the card by
  ``bench/harness.py::measure_call`` (CUDA events, slope over two call
  counts);
* the depth table: ``run_loop`` keeps ``depth`` batches in flight (each
  batch the whole step, from a generator of its own seed, as ``run_sweep``
  draws them) over at least 128 batches, and fetches the counters of a
  window in one stacked copy, queued before the host waits on the previous
  window's; the rate is coded Mbit/s per wall-clock second;
* the graphed rows: ``run_loop_scan`` dispatches ``SCAN_STEPS`` batches a
  call as one CUDA graph replay (``sim/scan.py::ScanSteps``, the JAX
  tool's ``lax.scan`` executable) at depths 1, 2 and 4.  The graph's
  channel, decoder and generators are its own, built after the eager
  parts have run, so a replay never reads state that the stage callables
  advanced.

Writes ``benchmarks_torch/AIR.md`` with the card's name and power limit
beside every table.  Needs a CUDA device; without one it exits non-zero
and writes nothing.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from ..channel.awgn import AwgnChannel
from ..codes.registry import load_code
from ..decoder import backend_for, default_device, make_decoder
from ..ops.layered import LayeredSpec
from ..sim.analyzer import count_errors_async
from ..sim.scan import ScanSteps
from .ber_curves import BENCH_DIR, card_name
from .harness import measure_call

__all__ = ["CONFIGS", "DEPTHS", "SNR_DB", "SCAN_STEPS", "build_parts",
           "run_loop", "build_scan_step", "run_loop_scan", "bench_one",
           "main"]

# flagship codes, one per kernel family, at the suite's batches: the JAX
# tool's table (``tools/run_air_bench.py:55-62``)
CONFIGS = [
    ("576x288", 16384),
    ("2304x1152", 8192),
    ("4000x2000", 4096),
    ("64800x32400", 512),
]
DEPTHS = [1, 2, 4, 8, 16]
SNR_DB = 2.5
SCAN_STEPS = 8
SCAN_DEPTHS = (1, 2, 4)
OUT = os.path.join(BENCH_DIR, "AIR.md")


def build_parts(code, spec, batch, device=None):
    """The whole step and its three stages as separate callables, on
    ``device`` (default: the card).  Returns ``(step, chan, chan_fn,
    dec_fn, cnt_fn, step_x)``: ``step(gen)`` is one batch from ``gen`` to
    its ``[2]`` (BE, FE) counts, as ``run_sweep`` runs it; ``chan_fn(tx)``
    (a ``[B, N]`` int8 codeword to LLRs, drawing from the parts' own
    generator, whose state advances each call), ``dec_fn(llr)`` and
    ``cnt_fn(bits)`` are its stages, and ``step_x(tx)`` the three in one
    call, for ``measure_call`` (the breakdown only)."""
    device = torch.device(device) if device is not None else default_device()
    chan = AwgnChannel(code.N, code.K, device=device)
    chan.configure(SNR_DB)
    decoder = make_decoder(code, spec, device=device)
    gen = chan.generator(3)

    def chan_fn(tx):
        return chan.generate_int8(gen, tx)

    def dec_fn(llr):
        return decoder(llr)[0]

    def cnt_fn(bits):
        return torch.stack(count_errors_async(bits))

    def step(g):
        return cnt_fn(dec_fn(chan.generate_zero_int8(g, batch)))

    def step_x(tx):
        return cnt_fn(dec_fn(chan_fn(tx)))

    return step, chan, chan_fn, dec_fn, cnt_fn, step_x


def _drive(dispatch, depth: int, n: int) -> float:
    """Wall seconds for ``dispatch(0 .. n-1)`` with ``depth`` dispatches in
    flight: each window's counts are stacked and their copy to the host is
    queued (pinned memory, an event) before the host waits on the previous
    window's copy, so the wait overlaps the next window's work."""
    inflight: list = []
    pending = None
    next_k = 0
    t0 = time.perf_counter()
    while next_k < n or inflight or pending is not None:
        while next_k < n and len(inflight) < depth:
            inflight.append(dispatch(next_k))
            next_k += 1
        stacked = None
        if inflight:
            counts = torch.stack(inflight)
            inflight = []
            event = None
            host = counts.to("cpu", non_blocking=True)
            if counts.is_cuda:
                event = torch.cuda.Event()
                event.record()
            stacked = (host, event)
        if pending is not None:
            if pending[1] is not None:
                pending[1].synchronize()
            pending[0].tolist()
        pending = stacked
    return time.perf_counter() - t0


def run_loop(step, chan, depth: int, n_batches: int, seed0: int) -> float:
    """Wall seconds for ``n_batches`` whole steps, ``depth`` in flight,
    batch k from a generator seeded with ``seed0 + k``."""
    return _drive(lambda k: step(chan.generator(seed0 + k)), depth, n_batches)


def build_scan_step(code, spec, batch, scan_steps: int, device=None):
    """``scan_steps`` whole steps a dispatch (one CUDA graph replay on the
    card) over a channel and decoder of their own; returns ``(scan,
    chan)``."""
    step, chan, *_ = build_parts(code, spec, batch, device)
    return ScanSteps(step, scan_steps, chan.device), chan


def run_loop_scan(scan, depth: int, n_calls: int, seed0: int) -> float:
    """Wall seconds for ``n_calls`` graphed dispatches, ``depth`` in
    flight; batch j of call k from the seed ``seed0 + k * S + j``."""
    S = scan.S
    return _drive(lambda k: scan([seed0 + k * S + j for j in range(S)]),
                  depth, n_calls)


def bench_one(name: str, batch: int, quick: bool, device) -> dict:
    """The stage table's row, the depth rows and the graphed rows of one
    configuration."""
    code = load_code(name)
    spec = LayeredSpec(algo="OMS", iters=10, early_term=False)
    backend = backend_for(code, spec, device)
    step, chan, chan_fn, dec_fn, cnt_fn, step_x = build_parts(
        code, spec, batch, device)
    n_batches = 16 if quick else 128
    tx = [torch.zeros((batch, code.N), dtype=torch.int8, device=device)]
    llrs = [chan_fn(tx[0]) for _ in range(8)]
    bitss = [dec_fn(x) for x in llrs]
    torch.cuda.synchronize(device)
    stages = {
        "chan_ms": measure_call(chan_fn, tx) * 1e3,
        "decode_ms": measure_call(dec_fn, llrs) * 1e3,
        "count_ms": measure_call(cnt_fn, bitss) * 1e3,
        "fused_step_ms": measure_call(step_x, tx) * 1e3,
    }
    decode_mbps = batch * code.N / stages["decode_ms"] / 1e3
    print(f"(II) {name} B={batch} stages: {json.dumps(stages)} (decode "
          f"alone {decode_mbps:.1f} coded Mbit/s)", flush=True)
    base = dict(code=name, backend=backend, iters=spec.iters, batch=batch)
    rows, base_mbps = [], None
    for depth in DEPTHS:
        run_loop(step, chan, depth, 2 * depth, seed0=10**6 + depth)  # warm
        sec = run_loop(step, chan, depth, n_batches, seed0=depth * 10**5)
        mbps = n_batches * batch * code.N / sec / 1e6
        base_mbps = base_mbps or mbps
        rows.append({**base, "depth": depth, "n_batches": n_batches,
                     "wall_s": sec, "air_mbps": mbps,
                     "gain_vs_depth1": mbps / base_mbps,
                     "air_vs_decode_only": mbps / decode_mbps})
        print("(PERF) " + json.dumps(rows[-1]), flush=True)
    scan, schan = build_scan_step(code, spec, batch, SCAN_STEPS, device)
    n_calls = max(1, n_batches // SCAN_STEPS)
    scan_rows = []
    for depth in SCAN_DEPTHS:
        run_loop_scan(scan, depth, 2 * depth, seed0=10**7 + depth)  # warm
        sec = run_loop_scan(scan, depth, n_calls, seed0=depth * 10**6)
        mbps = n_calls * SCAN_STEPS * batch * code.N / sec / 1e6
        scan_rows.append({**base, "scan_steps": SCAN_STEPS, "depth": depth,
                          "n_batches": n_calls * SCAN_STEPS, "wall_s": sec,
                          "air_mbps": mbps,
                          "air_vs_decode_only": mbps / decode_mbps})
        print("(PERF) " + json.dumps(scan_rows[-1]), flush=True)
    return {**base, **stages, "decode_mbps": decode_mbps, "rows": rows,
            "scan_rows": scan_rows, "capture_s": scan.capture_s}


def _write(path: str, results: list[dict], card: str, quick: bool) -> None:
    stamp = time.strftime("%Y-%m-%d")
    n = 16 if quick else 128
    lines = [
        "# End-to-end air throughput of the PyTorch + CUDA port (one card)\n\n",
        f"Measured {stamp} on {card} (`nvidia-smi` name, power limit) by "
        "`python -m ldpcgputegra_tpu_torch.bench.air`"
        + (" --quick" if quick else "") + ".  The whole loop a batch (the "
        "AWGN channel and quantizer, the decode, the error count; OMS 10 "
        f"iterations, no early termination, {SNR_DB} dB), the reference's "
        "accounting (`main.cpp:305-318`, `paper/ldpcGpuTegra.tex:298`): "
        "coded Mbit/s per wall-clock second.  Every batch draws from a "
        "generator of its own seed; the counters of a window come back in "
        "one stacked copy, queued before the host waits on the previous "
        "window's.  The JAX package's `benchmarks/AIR.md` measured another "
        "device; none of its numbers is quoted here.\n\n",
        f"## Stage breakdown (device ms a batch, `measure_call`) — {card}\n\n",
        "| code | backend | batch | channel | decode | count | whole step "
        "| decode alone, coded Mbit/s |\n|---|---|---|---|---|---|---|---|\n",
    ]
    for r in results:
        lines.append(
            f"| {r['code']} | {r['backend']} | {r['batch']} "
            f"| {r['chan_ms']:.4f} | {r['decode_ms']:.4f} "
            f"| {r['count_ms']:.4f} | {r['fused_step_ms']:.4f} "
            f"| {r['decode_mbps']:.1f} |\n")
    lines += [
        f"\n## Air throughput by pipeline depth ({n} batches) — {card}\n\n",
        "| code | batch | depth | wall s | air Mbit/s | gain vs depth 1 "
        "| vs decode alone |\n|---|---|---|---|---|---|---|\n",
    ]
    for res in results:
        for r in res["rows"]:
            lines.append(
                f"| {r['code']} | {r['batch']} | {r['depth']} "
                f"| {r['wall_s']:.4f} | {r['air_mbps']:.1f} "
                f"| {r['gain_vs_depth1']:.3f} "
                f"| {r['air_vs_decode_only']:.3f} |\n")
    lines += [
        f"\n## Graphed dispatch: {SCAN_STEPS} batches a CUDA graph replay "
        f"(`sim/scan.py`) — {card}\n\n",
        "| code | batch | S | depth | batches | wall s | air Mbit/s "
        "| vs decode alone |\n|---|---|---|---|---|---|---|---|\n",
    ]
    for res in results:
        for r in res["scan_rows"]:
            lines.append(
                f"| {r['code']} | {r['batch']} | {r['scan_steps']} "
                f"| {r['depth']} | {r['n_batches']} | {r['wall_s']:.4f} "
                f"| {r['air_mbps']:.1f} | {r['air_vs_decode_only']:.3f} |\n")
    lines.append("\nRaw records:\n\n```json\n")
    for r in results:
        lines.append(json.dumps({**r, "card": card, "measured": stamp})
                     + "\n")
    lines.append("```\n")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.writelines(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="16 batches a depth instead of 128")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("air: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    card = card_name(device)
    print(f"(II) {card}", flush=True)
    results = [bench_one(name, batch, args.quick, device)
               for name, batch in CONFIGS]
    _write(args.out, results, card, args.quick)
    print(f"(II) wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

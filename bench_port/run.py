"""Run one cell of ``BENCHMARK.json`` once and print its result.

    python3 bench_port/run.py --workload <config>.<traffic> --seed <n> \
        --seconds <s> --trace <0|1>

Set-up (imports, the decoder, the inputs, warm-up) runs from the process's
start to the window's open (``setup_s``); the window measures for
``--seconds``; then the program's state is freed and the reference checks
what the window produced.  Standard error ends with each number compared
beside its limit; the last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (with ``--trace 0`` the
cell's end-to-end metrics, with ``--trace 1`` its per-layer ones, read from
the profiler's timeline), ``device``, with ``--trace 1`` ``breakdown``, and
``compared`` last.  Without a CUDA device, or with fewer than the cell
asks for, it prints no result and exits 2; if jax or the JAX package is
loaded by the time the result is due (after the window, the check and the
readers), it prints no result and exits 3.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "ldpcgputegra_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted({m.split(".", 1)[0] for m in sys.modules}
                  & set(FORBIDDEN))


def card(device) -> dict:
    """The card's name, SMs, maximum SM clock and power limit."""
    import torch

    hw = {"name": torch.cuda.get_device_name(device),
          "sms": torch.cuda.get_device_properties(device).multi_processor_count,
          "clock_hz": None, "power_limit": "unknown"}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm,power.limit",
             "--format=csv,noheader,nounits", f"--id={device.index or 0}"],
            capture_output=True, text=True, check=True, timeout=30).stdout
        clock, power = [v.strip() for v in out.splitlines()[0].split(",")]
        hw["clock_hz"] = float(clock) * 1e6
        hw["power_limit"] = f"{power} W"
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        pass
    return hw


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from bench_port.window import process_start

    t_start = process_start()
    import torch

    from bench_port import cell

    bench = cell.load_benchmark(ROOT)
    w = cell.workload(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < w["chips"]:
        print(f"run: {args.workload} needs {w['chips']} CUDA device(s); "
              f"this machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    return run_cell(args, bench, w, torch.device("cuda", 0), t_start, ROOT)


def run_cell(args, bench, w, device, t_start, root) -> int:
    """The run after the look for a card: set-up, window, check, readers,
    and the result line, unless a forbidden module is loaded by then."""
    import torch

    from bench_port import cell, trace
    from bench_port.common import passes
    from bench_port.window import Window

    config = cell.load_config(bench, w["config"], root)
    traffic = cell.load_traffic(w["traffic"], root)
    run = cell.load_kind(traffic["kind"], root)(
        config, traffic, args.seed, device, root)
    run.setup()
    win = Window(bool(args.trace), run.window_name)
    run.measure(win, args.seconds)
    setup_s = win.t_open - t_start
    on_card = device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    timeline = trace.read(win.prof, win) if args.trace else None
    run.release()
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = run.check()
    t_check = time.perf_counter() - t_check
    correct = passes(numbers)
    hw = card(device)
    print(f"card: {hw['name']}, power limit {hw['power_limit']}, "
          f"max SM clock {hw['clock_hz']} Hz, {hw['sms']} SMs; backend "
          f"{run.backend}", file=sys.stderr)
    print(f"window: {win.seconds:.6f} s, {run.attempted} attempted, "
          f"{run.checked} checked in {t_check:.3f} s, set-up {setup_s:.3f} s; "
          f"{run.describe()}", file=sys.stderr)

    metrics = {}
    wanted = cell.metrics_of(bench, w["name"], bool(args.trace))
    if args.trace:
        ctx = types.SimpleNamespace(timeline=timeline, layer=run.layer, hw=hw)
        for m in wanted:
            v = cell.load_reader(m["name"], root)(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e = dict(run.end_to_end(), setup_s=setup_s)
        for m in wanted:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    dev = {"platform": "gpu", "kind": hw["name"], "count": 1,
           "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": run.attempted,
              "failed": run.failed, "metrics": metrics, "device": dev}
    if timeline is not None:
        dev["busy_s"] = timeline.busy_s
        dev["window_s"] = timeline.window_s
        result["breakdown"] = timeline.breakdown()
    result["compared"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                          for c in numbers}
    # read last: the check and the readers import modules too
    found = forbidden_modules()
    if found:
        print(f"run: loaded after the window: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for c in numbers:
        print(f"compared {c['name']} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0

if __name__ == "__main__":
    sys.exit(main())

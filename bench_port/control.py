"""The control of a cell's comparison: the reference, computed one bit
below the widths the configuration states (the messages and, where the
program makes the LLRs, the LLRs), put in the program's place, at the
cell's own size, on the card.  It has to come out as not
correct.

    python3 bench_port/control.py --workload <cell> --seed <n> [--seed ...]

For each seed it makes the inputs a run of the cell makes and the answers
a run checks (every input of a decode loop; of a block loop, the blocks
of its sample and the last; of a sweep, two groups of a window of 90),
and prints one JSON line with the numbers compared.  The program does not
run; neither do the benchmark's own runs run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, action="append", required=True)
    args = p.parse_args(argv)

    from bench_port import cell
    from bench_port.common import passes

    bench = cell.load_benchmark(ROOT)
    w = cell.workload(bench, args.workload)
    config = cell.load_config(bench, w["config"], ROOT)
    traffic = cell.load_traffic(w["traffic"], ROOT)
    low = {"msg_bits": config["msg_bits"] - 1,
           "bits_llr": config["bits_llr"] - 1}
    for seed in args.seed:
        t0 = time.perf_counter()
        run = cell.load_kind(traffic["kind"], ROOT)(
            config, traffic, seed, "cuda", ROOT)
        run.prepare_control()
        numbers = run.check(**low)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          **low, "correct": passes(numbers),
                          "seconds": time.perf_counter() - t0,
                          "compared": {c["name"]: c["value"]
                                       for c in numbers}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

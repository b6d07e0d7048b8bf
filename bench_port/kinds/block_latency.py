"""One block in flight: a closed loop that hands the decoder one block of
the traffic's batch, waits for it (``torch.cuda.synchronize()``) and
sends the next.  The blocks, ``n_blocks`` of them at the traffic's
Eb/N0, are made before the window and cycled.  A block's latency runs on
the host's clock from the decode call to the synchronisation's return;
``block_p95_ms`` is the 95th percentile of every block in the window.
Each block runs in a ``bench_port.block`` span, traced or not.

Checked: the blocks drawn from the seed among the first ``check_first``,
and the last; bits and ``iters_used`` against the reference's decode of
the same block, exactly.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from ..common import check_decodes, make_inputs, program_decoder, sync
from ..yardstick import sample_rng


class Run:
    window_name = "bench_port.window"

    def __init__(self, config, traffic, seed, device, root):
        self.config, self.traffic = config, traffic
        self.seed, self.device, self.root = seed, torch.device(device), root
        self.layer = {"batch": traffic["batch"], "n": config["n"],
                      "edge_updates": config["edge_updates"]}

    def setup(self) -> None:
        self.decoder, self.backend = program_decoder(
            self.config, self.traffic["early_term"], self.device)
        self.blocks = make_inputs(self.config, self.traffic, self.seed, 0,
                                  self.traffic["n_blocks"], self.device)
        # as many outputs alive at once as the window keeps (the sample and
        # the last), so that the window allocates nothing new
        outs = []
        for i in range(self.traffic["check_blocks"] + 2):
            outs.append(self.decoder(self.blocks[i % len(self.blocks)]))
            sync(self.device)
        del outs

    def measure(self, win, seconds: float) -> None:
        n_b = len(self.blocks)
        rng = sample_rng(self.seed, 2)
        early = set(rng.choice(self.traffic["check_first"],
                               self.traffic["check_blocks"],
                               replace=False).tolist())
        kept = {}
        lat = []
        clock = time.perf_counter
        i = 0
        win.open()
        deadline = win.t_open + seconds
        while True:
            t0 = clock()
            with record_function("bench_port.block"):
                out = self.decoder(self.blocks[i % n_b])
                sync(self.device)
            t1 = clock()
            lat.append(t1 - t0)
            if i in early:
                kept[i] = out
            i += 1
            if t1 >= deadline:
                break
        win.close()
        kept[i - 1] = out
        self.kept, self.lat, self.window_s = kept, np.asarray(lat), win.seconds
        self.attempted = i

    def end_to_end(self) -> dict:
        return {"block_p95_ms": float(np.percentile(self.lat, 95)) * 1e3}

    def describe(self) -> str:
        q = np.percentile(self.lat, [50, 90, 95, 99]) * 1e3
        return ("block ms: median {:.6f}, p90 {:.6f}, p95 {:.6f}, p99 {:.6f}"
                .format(*q))

    def release(self) -> None:
        del self.decoder

    def prepare_control(self) -> None:
        """The inputs and the checked calls a window leaves, without the
        program: the control puts the reference in its place."""
        self.blocks = make_inputs(self.config, self.traffic, self.seed, 0,
                                  self.traffic["n_blocks"], self.device)
        self.kept = dict.fromkeys(range(self.traffic["n_blocks"]))

    def check(self, **override) -> list:
        """The comparison; ``override`` puts the reference at another
        setting in the program's place (the control)."""
        # the inputs are the benchmark's, made at the configuration's LLR
        # width: the control lowers the decode's alone
        override.pop("bits_llr", None)
        numbers, self.failed, per_frame = check_decodes(
            self.config, self.root, self.traffic["early_term"], self.blocks,
            self.kept, **override)
        self.checked = len(self.kept)
        self.layer["iters_per_frame"] = per_frame
        return numbers

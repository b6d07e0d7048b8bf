"""A closed loop of decode calls back to back on a fixed set of input
batches (``bench/headline.py``'s workload): the traffic's ``n_inputs``
batches at its Eb/N0, cycled, through the decoder that
``ldpcgputegra_tpu_torch.decoder.make_decoder`` returns for the
configuration.  At most two cycles are in flight: the host waits for the
cycle before last.  The rate is frames x N over the window, from its open
to the return of the synchronisation that ends it.  Each call runs in a
``bench_port.decode_call`` span, traced or not (a few microseconds), so
that a traced window does the host work of an untraced one.

Checked: the calls drawn from the seed among the first ``check_first``,
and each input's last call; bits and ``iters_used`` against the
reference's decode of the same input, exactly.
"""

from __future__ import annotations

import collections
import time

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
        self.inputs = make_inputs(self.config, self.traffic, self.seed, 0,
                                  self.traffic["n_inputs"], self.device)
        # as many outputs alive at once as the window keeps (each input's
        # last and the sample), so that the window allocates nothing new
        n_in = len(self.inputs)
        outs = [self.decoder(self.inputs[i % n_in])
                for i in range(n_in + self.traffic["check_calls"] + 1)]
        sync(self.device)
        del outs

    def measure(self, win, seconds: float) -> None:
        n_in = len(self.inputs)
        rng = sample_rng(self.seed, 1)
        early = set(rng.choice(self.traffic["check_first"],
                               self.traffic["check_calls"],
                               replace=False).tolist())
        kept = {}
        last = collections.deque(maxlen=n_in)
        pending = collections.deque()
        on_card = self.device.type == "cuda"
        i = 0
        win.open()
        deadline = win.t_open + seconds
        while True:
            with record_function("bench_port.decode_call"):
                out = self.decoder(self.inputs[i % n_in])
            if i in early:
                kept[i] = out
            last.append((i, out))
            if on_card and i % n_in == n_in - 1:
                ev = torch.cuda.Event()
                ev.record()
                pending.append(ev)
                if len(pending) > 2:
                    pending.popleft().synchronize()
            i += 1
            if time.perf_counter() >= deadline:
                break
        sync(self.device)
        win.close()
        kept.update(last)
        self.calls, self.kept, self.window_s = i, kept, win.seconds
        self.attempted = i

    def end_to_end(self) -> dict:
        frames = self.calls * self.traffic["batch"]
        return {"decode_mbps": frames * self.config["n"] / self.window_s / 1e6}

    def describe(self) -> str:
        return f"{self.calls} calls, backend {self.backend}"

    def release(self) -> None:
        del self.decoder

    def prepare_control(self) -> None:
        """The inputs and the checked calls a window leaves, without the
        program: the control puts the reference in its place."""
        self.inputs = make_inputs(self.config, self.traffic, self.seed, 0,
                                  self.traffic["n_inputs"], self.device)
        self.kept = dict.fromkeys(range(self.traffic["n_inputs"]))

    def check(self, **override) -> list:
        """The comparison; ``override`` puts the reference at another
        setting in the program's place (the control)."""
        # the inputs are the benchmark's, made at the configuration's LLR
        # width: the control lowers the decode's alone
        override.pop("bits_llr", None)
        numbers, self.failed, per_frame = check_decodes(
            self.config, self.root, self.traffic["early_term"], self.inputs,
            self.kept, **override)
        self.checked = len(self.kept)
        self.layer["iters_per_frame"] = per_frame
        return numbers

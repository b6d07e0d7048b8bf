"""S sim steps in one dispatch: the port's counterpart of the JAX sweep's
``sim_step_fake_scan`` (``ldpcgputegra_tpu/sim/sweep.py:261-278``), which
folds ``scan_steps`` batches into one executable.

On a CUDA device the S batches (channel -> quantize -> decode -> count,
each ``step(gen)``; on the coded path the info bits' draw and the encoder
first) are captured once into one ``torch.cuda.CUDAGraph``,
and a dispatch is one replay plus a device-side copy of the graph's
``[S, 2]`` (BE, FE) buffer (``[S, 3]`` with two-phase early termination:
BE, FE and the unconverged count, ``sim/sweep.py``; phase 1, the
compaction, phase 2 at its fixed tail and the merge are all in the
graph), so that several replays can be in flight without one overwriting
another's counts.  Batch j of a dispatch draws
its info bits and noise from the j-th of S generators, each registered
with the graph (``register_generator_state``) and reseeded before each
replay: a replay reads a generator's seed and offset when it starts, so
batch k keeps the draws of its own seed and the counts are the same for
any S.

Before the capture one eager step runs on a side stream: the kernel
wrappers' and the encoder's one-time work (their tables copied to the
card, the library loaded, the variant picked, the kernel's shared-memory
attribute) happens there, not under capture.  The capture calls ``capture_begin`` and
``capture_end`` itself on that stream: ``torch.cuda.graph`` would first
empty the allocator's caches, which cost a sweep that followed other work
on an H100 0.6-0.8 s a capture.  A capture that fails raises; nothing
falls back to eager dispatch.  The kernel wrappers' ``launches`` counters
and the encoders' ``encodes`` count what a capture records once, so they
are taken back after it and each replay adds the graph's counts to them:
the counters keep counting kernels that ran and batches encoded.

On the CPU (when the caller asks for it) the S steps run as a plain loop.
A dispatch's reseeding runs in the span ``ldpc.scan.prepare``
(``utils/profiling.py``), which ends where the replay (on the CPU, the
loop) starts.
"""

from __future__ import annotations

import time
from typing import Callable, Sequence

import torch

from ..utils.profiling import span

__all__ = ["ScanSteps"]


def _launch_counters() -> list[dict]:
    """The kernel wrappers' launch counters (``kernels/*.launches``) and
    the encoders' (``channel/encoder.py::encodes``)."""
    from ..channel import encoder
    from ..kernels import channel, gather, layered, streamed
    from ..kernels import encoder as encoder_kernel

    return [layered.launches, gather.launches, streamed.launches,
            channel.launches, encoder_kernel.launches, encoder.encodes]


class ScanSteps:
    """``S`` steps a dispatch.  ``step(gen)`` queues one batch and returns
    its counts, a ``[C]`` int64 tensor ((BE, FE), or (BE, FE, unconverged));
    ``ScanSteps(step, S, device)(seeds)`` runs S of them, batch j from a
    generator seeded with ``seeds[j]``, and returns their ``[S, C]``
    counts, not fetched."""

    def __init__(self, step: Callable[[torch.Generator], torch.Tensor],
                 S: int, device):
        self.step = step
        self.S = S
        self.device = torch.device(device)
        self.gens = [torch.Generator(device=self.device) for _ in range(S)]
        self.graph = None
        self.replays = 0
        self.per_replay: list[dict] = []  # launches a replay, by counter
        self.capture_s = 0.0  # host seconds of the warm-up and capture

    def _capture(self) -> None:
        t0 = time.perf_counter()
        warm = torch.Generator(device=self.device).manual_seed(0)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self.step(warm)
        side.synchronize()
        counters = _launch_counters()
        before = [dict(c) for c in counters]
        graph = torch.cuda.CUDAGraph()
        for g in self.gens:
            graph.register_generator_state(g)
        with torch.cuda.stream(side):
            graph.capture_begin()
            try:
                self._counts = torch.stack([self.step(g) for g in self.gens])
            finally:
                graph.capture_end()
        torch.cuda.current_stream(self.device).wait_stream(side)
        # the capture launched nothing: take its counts back
        self.per_replay = []
        for c, b in zip(counters, before):
            self.per_replay.append({k: c[k] - b.get(k, 0) for k in c})
            c.update(b)
        self.graph = graph
        self.capture_s = time.perf_counter() - t0

    def replayed(self, counter: dict) -> dict:
        """What a replay adds to ``counter``, one of the launch counters
        (``kernels/*.launches``, ``channel/encoder.py::encodes``)."""
        for c, n in zip(_launch_counters(), self.per_replay):
            if c is counter:
                return n
        raise KeyError("not a launch counter, or nothing captured yet")

    def __call__(self, seeds: Sequence[int]) -> torch.Tensor:
        if len(seeds) != self.S:
            raise ValueError(f"{len(seeds)} seeds for {self.S} steps")
        graphed = self.device.type == "cuda"
        if graphed and self.graph is None:
            self._capture()
        with span("scan.prepare", count=self.S):
            for g, s in zip(self.gens, seeds):
                g.manual_seed(s)
        if not graphed:
            return torch.stack([self.step(g) for g in self.gens])
        self.graph.replay()
        self.replays += 1
        for c, n in zip(_launch_counters(), self.per_replay):
            for k, v in n.items():
                c[k] += v
        return self._counts.clone()

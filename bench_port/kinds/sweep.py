"""A BER sweep held at one SNR point: ``ldpcgputegra_tpu_torch.sim.sweep.
run_sweep`` with the fake (all-zero) encoder, the traffic's batch,
``scan_steps`` and pipeline depth, at one Eb/N0.  The FE limit and the
frame budget are out of reach, so the point's own timer (``timer_s``, the
run's seconds) ends it, and with it the window.

The window opens when the first group's counts come back (set-up: the
code, the decoder, the graph's capture, the first group; a traced run
starts the profiler before the sweep) and closes when
the last fetch returns; the rate is the coded bits of the groups fetched
in between over that time.  ``run_sweep``'s ``on_window(dispatch_s,
fetch_s, batches)`` gives the host loop's spans; the point's running
counts, from which each group's (BE, FE) follow, are read there from its
``ErrorAnalyzer`` (a subclass that makes itself known, put in the sweep
module's name for the window's length).  No checkpoint file: as the CLI
runs by default, nothing is written in the window.

Checked: the last group and one drawn from the seed.  The reference makes
each of their batches' LLRs from the batch's seed (``batch_seed``),
decodes and counts them: each group's BE and FE, which the window
produced, must be the same (``count_mismatch``, the one number of the
timed path; it holds the window's channel and quantizer through the
frames they make fail).  ``llr_mismatch`` holds the program's channel
module (``AwgnChannel``), run again eagerly after the window on the same
seeds, against the reference's LLRs: the channel's code, not the LLRs the
window's graph replays made, which ``run_sweep`` does not hand out.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from ..common import compared, program_decoder, reference_decode, sync
from ..reference.channel import seeded, zero_llrs
from ..yardstick import batch_seed, sample_rng

OUT_OF_REACH = 1 << 62


class Run:
    window_name = "bench_port.sweep_window"

    def __init__(self, config, traffic, seed, device, root):
        self.config, self.traffic = config, traffic
        self.seed, self.device, self.root = seed, torch.device(device), root
        self.layer = {"batch": traffic["batch"], "n": config["n"],
                      "edge_updates": config["edge_updates"]}

    def setup(self) -> None:
        from ldpcgputegra_tpu_torch.sim.sweep import SweepConfig

        c, t = self.config, self.traffic
        # the decode of this shape once: the kernel's build and load and
        # the code's view, which the sweep's own decoder then finds
        dec, self.backend = program_decoder(c, t["early_term"], self.device)
        dec(torch.zeros((t["batch"], c["n"]), dtype=torch.int8,
                        device=self.device))
        sync(self.device)
        del dec
        self.cfg = SweepConfig(
            code=c["code"], algo=c["algo"], iters=c["iters"],
            offset=c["offset"], early_term=t["early_term"],
            minclamp=c["minclamp"], schedule=c["schedule"],
            snr_min=t["ebn0_db"], snr_max=t["ebn0_db"], snr_step=1.0,
            batch=t["batch"], max_fe=OUT_OF_REACH, auto_fe=False,
            max_frames=OUT_OF_REACH, pipeline_depth=t["pipeline_depth"],
            scan_steps=t["scan_steps"], backend=c["backend"],
            encoder=t["encoder"], quant_factor=c["quant_factor"],
            bits_llr=c["bits_llr"], var_bits=c["var_bits"],
            msg_bits=c["msg_bits"], seed=self.seed, device=str(self.device))

    def measure(self, win, seconds: float) -> None:
        import ldpcgputegra_tpu_torch.sim.sweep as sweep

        analyzers = []

        class Counted(sweep.ErrorAnalyzer):
            def __post_init__(self):
                super().__post_init__()
                analyzers.append(self)

        windows = []  # (t, dispatch_s, fetch_s, batches, counts after)
        batch = self.traffic["batch"]

        def on_window(dispatch_s, fetch_s, batches):
            t = time.perf_counter()
            a = analyzers[-1]
            if not windows:
                win.open()
            windows.append((t, dispatch_s, fetch_s, batches, (
                a.frames, a.bit_errors, a.frame_errors, a.frames // batch)))

        win.arm()
        made, sweep.ErrorAnalyzer = sweep.ErrorAnalyzer, Counted
        try:
            res = sweep.run_sweep(dataclasses.replace(self.cfg, timer_s=seconds),
                                  progress=False, on_window=on_window)
        finally:
            sweep.ErrorAnalyzer = made
        sync(self.device)
        win.close(windows[-1][0])
        pt = res.points[0]
        cum = [(0, 0, 0, 0)] + [w[4] for w in windows]
        if cum[-1] != (pt.frames, pt.be, pt.fe, pt.batches):
            raise RuntimeError(f"the running counts {cum[-1]} end short of "
                               f"the point's {pt}")
        self.groups = [tuple(b - a for a, b in zip(cum[w - 1], cum[w]))
                       + (cum[w - 1][3],) for w in range(1, len(cum))]
        inside = windows[1:]
        self.batches = sum(w[3] for w in inside)
        self.window_s = win.seconds
        self.attempted = self.batches
        self.layer["dispatch_ms_per_batch"] = (
            1e3 * sum(w[1] for w in inside) / max(self.batches, 1))
        self.layer["fetch_wait_share"] = (
            100.0 * sum(w[2] for w in inside) / self.window_s)

    def end_to_end(self) -> dict:
        bits = self.batches * self.traffic["batch"] * self.config["n"]
        return {"coded_mbps": bits / self.window_s / 1e6}

    def describe(self) -> str:
        return (f"{len(self.groups)} groups, dispatch "
                f"{self.layer['dispatch_ms_per_batch']:.6f} ms a batch, fetch "
                f"wait {self.layer['fetch_wait_share']:.3f}% of the window")

    def release(self) -> None:
        pass

    def prepare_control(self) -> None:
        """The groups a 10-s window leaves (about 90), without the program:
        the control puts the reference in its place."""
        s = self.traffic["scan_steps"]
        self.groups = [(0, 0, 0, s, s * w) for w in range(90)]

    def _llrs(self, ks, bits_llr=None):
        c, t = self.config, self.traffic
        return [zero_llrs(seeded(batch_seed(self.seed, 0, k), self.device),
                          t["batch"], c["n"], c["k"], t["ebn0_db"],
                          c["quant_factor"], bits_llr or c["bits_llr"],
                          self.device)
                for k in ks]

    def _program_llrs(self, ks):
        from ldpcgputegra_tpu_torch.channel.awgn import AwgnChannel, ChannelSpec
        from ldpcgputegra_tpu_torch.quant import QuantSpec

        c, t = self.config, self.traffic
        chan = AwgnChannel(c["n"], c["k"], ChannelSpec(quant=QuantSpec(
            factor=c["quant_factor"], bits_llr=c["bits_llr"])), self.device)
        chan.configure(t["ebn0_db"])
        return [chan.generate_zero_int8(chan.generator(batch_seed(
            self.seed, 0, k)), t["batch"]) for k in ks]

    def check(self, **override) -> list:
        """The comparison; ``override`` (``msg_bits``, ``bits_llr``) puts
        the reference at those widths in the program's place, its channel
        and its decode (the control)."""
        bits_llr = override.pop("bits_llr", None)
        control = bool(bits_llr or override)
        g = len(self.groups)
        picks = {g - 1}
        if g > 1:
            picks.add(int(sample_rng(self.seed, 3).integers(g - 1)))
        llr_bad = count_bad = 0
        self.failed = 0
        per_frame = []
        for gi in sorted(picks):
            _, be, fe, batches, first = self.groups[gi]
            ks = range(first, first + batches)
            ref_llr = self._llrs(ks)
            got = (self._llrs(ks, bits_llr) if control
                   else self._program_llrs(ks))
            n_bad = sum(int((a != b).sum()) for a, b in zip(got, ref_llr))
            block = torch.cat(ref_llr)
            bits, _, frame_iters = reference_decode(
                self.config, self.root, [block], True)[0]
            err = bits != 0
            r_be, r_fe = int(err.sum()), int(err.any(1).sum())
            if control:
                bits, _, _ = reference_decode(
                    self.config, self.root, [torch.cat(got)], True,
                    **override)[0]
                err = bits != 0
                be, fe = int(err.sum()), int(err.any(1).sum())
            bad = abs(be - r_be) + abs(fe - r_fe)
            llr_bad += n_bad
            count_bad += bad
            self.failed += int(n_bad > 0 or bad > 0)
            per_frame.append(frame_iters.float())
        self.checked = len(picks)
        self.layer["iters_per_frame"] = float(torch.cat(per_frame).mean())
        return [compared("llr_mismatch", llr_bad, 0),
                compared("count_mismatch", count_bad, 0)]

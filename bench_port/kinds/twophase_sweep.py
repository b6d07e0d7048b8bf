"""A BER sweep held at one SNR point with two-phase early termination:
``run_sweep`` with ``et="twophase"`` (the configuration's ``k1`` and
``tail``), the fake (all-zero) encoder, the traffic's batch,
``scan_steps`` and pipeline depth.  As in the ``sweep`` kind
(``kinds/sweep.py``), the point's own timer ends it, the window opens
when the first group's counts come back and closes when the last fetch
returns, and the rate is the coded bits of the groups fetched in between
over that time.  ``run_sweep``'s ``on_counts`` gives each group's final
counts, a row (BE, FE, unconverged) a batch, after any repair;
``twophase.stats``, read at the window's open and close, gives the
window's batches, tail frames and repairs (``layer["twophase"]``).

Checked, each batch on its own: the last group, one drawn from the seed,
and one batch drawn from the seed among those the sweep repaired (a
count above the tail), where there is one.  The reference
(``reference/twophase.py``) makes each batch's LLRs from its seed
(``batch_seed``), decodes them at ``k1`` iterations, holds each frame to
every check of the raw matrix, decodes the frames that fail at the full
budget and counts: ``count_mismatch`` (|dBE| + |dFE| of each batch),
``unconverged_mismatch`` (|d unconverged| of each batch) and
``llr_mismatch`` (the program's ``AwgnChannel``, rerun eagerly on the same
seeds, against the reference's LLRs), every one exact.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from ..common import compared, program_spec, sync
from ..reference.codes import schedule_for
from ..reference.decoder import Fixed
from ..reference.twophase import decode_twophase
from ..yardstick import sample_rng
from .sweep import OUT_OF_REACH
from .sweep import Run as SweepRun


class Run(SweepRun):
    def __init__(self, config, traffic, seed, device, root):
        super().__init__(config, traffic, seed, device, root)
        self.tail = min(config["tail"], traffic["batch"])
        self.layer.update(k1=config["k1"], iters=config["iters"],
                          tail=self.tail)

    def setup(self) -> None:
        from ldpcgputegra_tpu_torch.codes.registry import load_code
        from ldpcgputegra_tpu_torch.decoder import backend_for
        from ldpcgputegra_tpu_torch.sim.sweep import SweepConfig

        c, t = self.config, self.traffic
        self.backend = backend_for(load_code(c["code"]),
                                   program_spec(c, False), self.device,
                                   c["backend"])
        self.cfg = SweepConfig(
            code=c["code"], algo=c["algo"], iters=c["iters"],
            offset=c["offset"], early_term=False, minclamp=c["minclamp"],
            schedule=c["schedule"], et=c["et"], twophase_k1=c["k1"],
            twophase_tail=c["tail"], snr_min=t["ebn0_db"],
            snr_max=t["ebn0_db"], snr_step=1.0, batch=t["batch"],
            max_fe=OUT_OF_REACH, auto_fe=False, max_frames=OUT_OF_REACH,
            pipeline_depth=t["pipeline_depth"], scan_steps=t["scan_steps"],
            backend=c["backend"], encoder=t["encoder"],
            quant_factor=c["quant_factor"], bits_llr=c["bits_llr"],
            var_bits=c["var_bits"], msg_bits=c["msg_bits"], seed=self.seed,
            device=str(self.device))
        self.layer["phase2_tile"] = self._tile(self.tail)
        self.layer["phase1_tile"] = self._tile(t["batch"])

    def _tile(self, batch: int):
        """The QC kernel's tile at ``batch`` on this card (its kernels'
        names carry it), None off the QC kernel."""
        if self.backend != "cuda" or self.device.type != "cuda":
            return None
        from ldpcgputegra_tpu_torch.codes.registry import load_code
        from ldpcgputegra_tpu_torch.kernels import layered

        sms = torch.cuda.get_device_properties(
            self.device).multi_processor_count
        return layered.pick_tile(load_code(self.config["code"]), batch, sms)

    def measure(self, win, seconds: float) -> None:
        import ldpcgputegra_tpu_torch.sim.sweep as sweep
        from ldpcgputegra_tpu_torch.decoder import twophase

        windows = []  # (t, dispatch_s, fetch_s, batches)
        groups = []  # (first batch, [(BE, FE, unconverged) a batch])
        at_open = {}

        def on_counts(point, first, rows):
            groups.append((first, [tuple(int(v) for v in r) for r in rows]))

        def on_window(dispatch_s, fetch_s, batches):
            t = time.perf_counter()
            if not windows:
                win.open()
                at_open.update(twophase.stats)
            windows.append((t, dispatch_s, fetch_s, batches))

        win.arm()
        res = sweep.run_sweep(dataclasses.replace(self.cfg, timer_s=seconds),
                              progress=False, on_window=on_window,
                              on_counts=on_counts)
        sync(self.device)
        win.close(windows[-1][0])
        pt = res.points[0]
        rows = [r for _, rs in groups for r in rs]
        got = (len(rows), sum(r[0] for r in rows), sum(r[1] for r in rows))
        if got != (pt.batches, pt.be, pt.fe):
            raise RuntimeError(f"the groups' counts {got} are not the "
                               f"point's {pt}")
        self.groups = groups
        inside = windows[1:]
        self.batches = sum(w[3] for w in inside)
        self.window_s = win.seconds
        self.attempted = self.batches
        self.layer["twophase"] = {k: twophase.stats[k] - at_open[k]
                                  for k in at_open}
        self.layer["dispatch_ms_per_batch"] = (
            1e3 * sum(w[1] for w in inside) / max(self.batches, 1))
        self.layer["fetch_wait_share"] = (
            100.0 * sum(w[2] for w in inside) / self.window_s)

    def describe(self) -> str:
        tp = self.layer.get("twophase", {})
        return (f"{super().describe()}; two-phase in the window: "
                f"{tp.get('unconverged')} unconverged frames over "
                f"{tp.get('batches')} batches, {tp.get('repairs')} repairs")

    def prepare_control(self) -> None:
        """The groups a 10-s window leaves (about 550), without the
        program: the control puts the reference in its place."""
        s = self.traffic["scan_steps"]
        self.groups = [(s * w, [(0, 0, 0)] * s) for w in range(550)]

    def _checked(self) -> list:
        """The batches checked, in runs of consecutive ones: [(first
        batch, rows)]."""
        g = len(self.groups)
        picks = {g - 1}
        if g > 1:
            picks.add(int(sample_rng(self.seed, 3).integers(g - 1)))
        runs = [self.groups[i] for i in sorted(picks)]
        seen = {k0 + j for k0, rows in runs for j in range(len(rows))}
        over = [(k0 + j, r) for k0, rows in self.groups
                for j, r in enumerate(rows)
                if r[2] > self.tail and k0 + j not in seen]
        if over:
            k, r = over[int(sample_rng(self.seed, 4).integers(len(over)))]
            runs.append((k, [r]))
        return runs

    def _reference(self, llrs: list, **override) -> list:
        """[(BE, FE, unconverged)] of each of ``llrs`` by the reference's
        two-phase decode, its frames decoded together."""
        c = self.config
        bits, bad = decode_twophase(schedule_for(c, self.root),
                                    torch.cat(llrs), Fixed.of(c, False,
                                                              **override),
                                    c["k1"])
        out = []
        for b, u in zip(bits.split([x.shape[0] for x in llrs]),
                        bad.split([x.shape[0] for x in llrs])):
            err = b != 0
            out.append((int(err.sum()), int(err.any(1).sum()), int(u.sum())))
        return out

    def check(self, **override) -> list:
        """The comparison; ``override`` (``msg_bits``, ``bits_llr``) puts
        the reference at those widths in the program's place, its channel
        and its decode (the control)."""
        bits_llr = override.pop("bits_llr", None)
        control = bool(bits_llr or override)
        llr_bad = count_bad = unconv_bad = 0
        self.failed = 0
        runs = self._checked()
        for k0, rows in runs:
            ks = range(k0, k0 + len(rows))
            ref_llr = self._llrs(ks)
            got_llr = (self._llrs(ks, bits_llr) if control
                       else self._program_llrs(ks))
            n_llr = [int((a != b).sum()) for a, b in zip(got_llr, ref_llr)]
            ref = self._reference(ref_llr)
            del ref_llr
            if control:
                rows = self._reference(got_llr, **override)
            del got_llr
            for n, (be, fe, un), (r_be, r_fe, r_un) in zip(n_llr, rows, ref):
                bad = abs(be - r_be) + abs(fe - r_fe)
                llr_bad += n
                count_bad += bad
                unconv_bad += abs(un - r_un)
                self.failed += int(n > 0 or bad > 0 or un != r_un)
        self.checked = sum(len(rows) for _, rows in runs)
        return [compared("llr_mismatch", llr_bad, 0),
                compared("count_mismatch", count_bad, 0),
                compared("unconverged_mismatch", unconv_bad, 0)]

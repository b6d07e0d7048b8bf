"""A BER sweep of coded frames held at one SNR point: the ``sweep`` kind
(``kinds/sweep.py``: its window, its groups, ``coded_mbps`` and the host
loop's spans) with the traffic's ``encoder``, ``random_bits`` and
``count_bits``: each batch draws its info bits, then its noise, from the
batch's seed; the program encodes them, sends the codewords through its
channel, decodes and counts the errors against the bits sent (with
``count_bits`` "info", the first k columns only).

Checked: the same two groups as the sweep's (the last one, and one drawn
from the seed).  The reference (``reference/coded.py``) draws each of
their batches' info bits from the batch's seed, encodes them by the
standard's parity address table (the configuration's ``encoder_file``),
makes the LLRs of the codewords, decodes and counts them.  Three numbers,
each with limit 0: ``codeword_mismatch``, the program's bit draw and
``encoder.encode``, run again eagerly after the window on the same seeds,
against the reference's codewords; ``llr_mismatch``, the program's
``AwgnChannel.generate_int8`` on those codewords, against the reference's
LLRs; ``count_mismatch``, |dBE| + |dFE| of each group's counts, which
the window produced, against the reference's decode.
"""

from __future__ import annotations

import dataclasses

import torch

from ..common import compared, reference_decode
from ..reference.channel import seeded
from ..reference.coded import coded_frames
from ..yardstick import batch_seed, sample_rng
from .sweep import Run as SweepRun


class Run(SweepRun):
    def __init__(self, config, traffic, seed, device, root):
        super().__init__(config, traffic, seed, device, root)
        self.counted = config["k"] if traffic["count_bits"] == "info" \
            else config["n"]
        self.layer["counted_cols"] = self.counted

    def setup(self) -> None:
        super().setup()
        t = self.traffic
        self.cfg = dataclasses.replace(self.cfg, random_bits=t["random_bits"],
                                       count_bits=t["count_bits"])

    def _reference(self, ks, bits_llr=None) -> list:
        """(codewords, LLRs) of batches ``ks`` by the reference."""
        c, t = self.config, self.traffic
        return [coded_frames(seeded(batch_seed(self.seed, 0, k), self.device),
                             c, self.root, t["batch"], t["ebn0_db"], bits_llr)
                for k in ks]

    def _program(self, ks) -> list:
        """(codewords, LLRs) of batches ``ks`` by the program's bit draw,
        encoder and channel, run eagerly."""
        from ldpcgputegra_tpu_torch.channel.awgn import AwgnChannel, ChannelSpec
        from ldpcgputegra_tpu_torch.channel.bitgen import generate_info_bits
        from ldpcgputegra_tpu_torch.channel.encoder import make_encoder
        from ldpcgputegra_tpu_torch.codes.registry import load_code
        from ldpcgputegra_tpu_torch.quant import QuantSpec

        c, t = self.config, self.traffic
        enc = make_encoder(load_code(c["code"]), t["encoder"])
        chan = AwgnChannel(c["n"], c["k"], ChannelSpec(quant=QuantSpec(
            factor=c["quant_factor"], bits_llr=c["bits_llr"])), self.device)
        chan.configure(t["ebn0_db"])
        out = []
        for k in ks:
            gen = chan.generator(batch_seed(self.seed, 0, k))
            cw = enc.encode(generate_info_bits(gen, t["batch"], c["k"],
                                               t["random_bits"]))
            out.append((cw, chan.generate_int8(gen, cw)))
        return out

    def _counts(self, bits, codewords):
        err = bits[:, :self.counted] != codewords[:, :self.counted]
        return int(err.sum()), int(err.any(1).sum())

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
        cw_bad = llr_bad = count_bad = 0
        self.failed = 0
        per_frame = []
        for gi in sorted(picks):
            _, be, fe, batches, first = self.groups[gi]
            ks = range(first, first + batches)
            ref = self._reference(ks)
            got = (self._reference(ks, bits_llr) if control
                   else self._program(ks))
            n_cw = sum(int((a[0] != b[0]).sum()) for a, b in zip(got, ref))
            n_llr = sum(int((a[1] != b[1]).sum()) for a, b in zip(got, ref))
            sent = torch.cat([cw for cw, _ in ref])
            bits, _, frame_iters = reference_decode(
                self.config, self.root, [torch.cat([x for _, x in ref])],
                True)[0]
            r_be, r_fe = self._counts(bits, sent)
            del bits, ref
            if control:
                bits, _, _ = reference_decode(
                    self.config, self.root, [torch.cat([x for _, x in got])],
                    True, **override)[0]
                be, fe = self._counts(bits, sent)
            bad = abs(be - r_be) + abs(fe - r_fe)
            cw_bad += n_cw
            llr_bad += n_llr
            count_bad += bad
            self.failed += int(n_cw > 0 or n_llr > 0 or bad > 0)
            per_frame.append(frame_iters.float())
        self.checked = len(picks)
        self.layer["iters_per_frame"] = float(torch.cat(per_frame).mean())
        return [compared("codeword_mismatch", cw_bad, 0),
                compared("llr_mismatch", llr_bad, 0),
                compared("count_mismatch", count_bad, 0)]

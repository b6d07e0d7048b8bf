"""Two-phase (compaction) early termination, the port's counterpart of
``ldpcgputegra_tpu/decoder/twophase.py``.

* Phase 1 decodes the whole batch at a fixed ``k1`` iterations and gets
  ``ok[B]``, the true syndrome of each output codeword, from the decoder's
  ``emit_mask`` output (the QC kernel's own syndrome pass, or
  ``syndrome_fn`` appended on the device).
* The host reads one number a batch, the unconverged count, to size
  phase 2.
* Phase 2 re-decodes only the unconverged frames at the full budget, at a
  batch of the next power-of-two multiple of ``tail_pad``; compaction and
  merge run on the device.

Output: a frame whose ``k1``-iteration hard decisions already satisfy every
check returns them (a valid codeword, as a per-frame early exit would); the
other frames return their full-budget decode.  Cost per frame: ``k1 +
iters x (phase-2 batch) / B`` iterations instead of the slowest frame's.

The JAX version's TPU workarounds have no counterpart here: the tail is
gathered with ``index_select`` (not a one-hot bf16 matmul), the compaction
is a stable sort of the mask (the unconverged frames first, in frame
order; not a 2-D cumsum and searchsorted), the merge an ``index_copy_``
(not a scatter that drops out-of-range rows), and there is no executable
per bucket: ``warm_buckets`` and ``warm_fused`` keep their names and return
values and build the kernels and fill the allocator's pools outside a
timed window.  The merge writes into phase 1's bits in place.

``decode.step(llr, tail)`` is one batch with phase 2 at a fixed ``tail``
and no host read (the merged bits and the unconverged count, both on the
device), so that a CUDA graph can capture it: the sweep's two-phase mode
(``sim/sweep.py``, ``SweepConfig.et = "twophase"``) runs it S batches a
replay.  A batch whose count exceeds the tail kept some unconverged
frames' k1-iteration bits; ``decode.repair(llr, n_bad)`` decodes it again
exactly (phase 1, then phase 2 on all ``n_bad`` unconverged frames), as
``decode.pipelined_fused`` does after its one read of a window's counts.

While a profiler runs, phase 1 records the span ``ldpc.twophase.phase1``
(count: frames) and phase 2 ``ldpc.twophase.phase2`` (count: its batch),
``utils/profiling.py``; under a graph's capture they are recorded once.
``stats`` counts what the sweep's fetches read: ``batches``, ``frames``,
``unconverged`` (frames phase 1 left), ``tail_frames`` (phase 2's batch,
summed), ``repairs`` (batches decoded again) and ``repaired_frames`` (the
frames those repairs decoded at the full budget).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..codes.code import LdpcCode
from ..ops.layered import LayeredSpec
from ..utils.profiling import span

__all__ = ["make_twophase_decoder", "syndrome_fn", "stats", "tally"]

# The two-phase sweep's counters, added to on the host from each fetched
# group's counts (``tally``), with no synchronisation of their own.
stats = {"batches": 0, "frames": 0, "unconverged": 0, "tail_frames": 0,
         "repairs": 0, "repaired_frames": 0}


def tally(batch: int, tail: int, unconverged, repaired) -> None:
    """Add a fetched group to ``stats``: ``unconverged``, each batch's
    unconverged count; ``repaired``, the counts of the batches decoded
    again (those above ``tail``, phase 2's batch)."""
    stats["batches"] += len(unconverged)
    stats["frames"] += batch * len(unconverged)
    stats["unconverged"] += sum(unconverged)
    stats["tail_frames"] += tail * len(unconverged)
    stats["repairs"] += len(repaired)
    stats["repaired_frames"] += sum(repaired)


def syndrome_fn(code: LdpcCode, device=None):
    """``ok(bits[B, N] uint8) -> ok[B] bool``: every check of ``code`` is
    satisfied.  On the code's own edge table and column order (for a
    staircase code, the original code, not its QC view), on ``device``
    (default: ``decoder.default_device()``, the card, raising without
    one)."""
    from . import default_device

    device = torch.device(device) if device is not None else default_device()
    # per degree class, [deg, count]: the VN of edge j of each check
    tables = [torch.as_tensor(np.ascontiguousarray(ci.T, dtype=np.int64),
                              device=device) for ci in code.class_idx]

    def ok(bits: torch.Tensor) -> torch.Tensor:
        good = None
        for idx in tables:
            # the parity of each check as the XOR of its edges' bits
            # (bits are 0 or 1), one [B, count] gather an edge
            par = bits.index_select(1, idx[0])
            for j in range(1, idx.shape[0]):
                par ^= bits.index_select(1, idx[j])
            unsat = par.any(1).bool()  # any() of uint8 is uint8
            good = ~unsat if good is None else good & ~unsat
        return good

    return ok


def make_twophase_decoder(
    code: LdpcCode,
    spec: LayeredSpec,
    k1: int = 5,
    backend: str = "auto",
    tail_pad: int = 128,
    device=None,
):
    """Build ``decode(llr[B, N] int8) -> (bits[B, N] uint8, stats dict)`` on
    ``device`` (default: the card where there is one).

    ``spec.iters`` is the full budget; ``spec.early_term`` is ignored (the
    two phases are the early termination).  ``decode.pipelined``,
    ``decode.pipelined_fused``, ``decode.warm_buckets`` and
    ``decode.warm_fused`` are as in the JAX package; ``decode.step`` and
    ``decode.repair`` are the module docstring's.
    """
    from . import default_device, make_decoder

    device = torch.device(device) if device is not None else default_device()
    base = dataclasses.replace(spec, early_term=False)
    dec1 = make_decoder(code, dataclasses.replace(base, iters=k1), backend,
                        device, emit_mask=True)
    dec2 = make_decoder(code, base, backend, device)

    def _sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def phase1(llr):
        """The k1-iteration decode, its mask and the unconverged count (on
        the device)."""
        with span("twophase.phase1", count=llr.shape[0]):
            bits, _, ok = dec1(llr)
            return bits, ok, (~ok).sum()

    def phase2(llr, bits, ok, te: int):
        """Decode the first ``te`` frames of the unconverged-first order at
        the full budget and write the unconverged ones into ``bits``; rows
        past the count are converged frames, which keep their bits."""
        with span("twophase.phase2", count=te):
            gat = torch.sort(ok.to(torch.uint8), stable=True).indices[:te]
            tail_bits, _ = dec2(llr.index_select(0, gat))
            keep = ok.index_select(0, gat)[:, None]
            bits.index_copy_(0, gat, torch.where(
                keep, bits.index_select(0, gat), tail_bits))
            return bits

    def step(llr, tail: int):
        """One batch, phase 2 at the fixed ``tail`` (at most the batch):
        (bits, the unconverged count), both on the device, with no host
        read.  Where the count exceeds the tail, some unconverged frames
        keep their k1-iteration bits: ``repair`` gives the exact bits."""
        bits, ok, cnt = phase1(llr)
        return phase2(llr, bits, ok, min(tail, llr.shape[0])), cnt

    def repair(llr, n_bad: int):
        """The exact two-phase bits of a batch whose unconverged count
        ``n_bad`` (what ``step`` returned for it) is known: phase 1 again,
        then phase 2 on all ``n_bad`` unconverged frames."""
        bits, ok, _ = phase1(llr)
        return phase2(llr, bits, ok, n_bad) if n_bad else bits

    def _cap(b: int) -> int:
        return -(-b // tail_pad) * tail_pad

    def _bucket(n: int, b: int) -> int:
        """Phase 2's batch: the next power-of-two multiple of ``tail_pad``
        at or above ``n``, at most the padded full batch."""
        t = tail_pad
        while t < n:
            t *= 2
        return min(t, _cap(b))

    def _stats(n_bad: int, tail: int, b: int) -> dict:
        return {
            "phase2_frames": int(n_bad),
            "phase2_batch": int(tail),
            "eff_iters_per_frame": k1 + spec.iters * tail / max(b, 1),
            "eff_iters_per_frame_ideal": k1 + spec.iters * n_bad / max(b, 1),
        }

    def decode(llr):
        b = llr.shape[0]
        bits, ok, cnt = phase1(llr)
        n_bad = int(cnt)  # the one host read
        tail = _bucket(n_bad, b) if n_bad else 0
        if n_bad:
            phase2(llr, bits, ok, min(tail, b))
        return bits, _stats(n_bad, tail, b)

    def warm_buckets(llr) -> list[int]:
        """Run phase 1 and phase 2 at every bucket this batch size can take
        (results discarded); returns the bucket sizes."""
        b = llr.shape[0]
        bits, ok, _ = phase1(llr)
        sizes = []
        t = tail_pad
        while t < _cap(b):
            sizes.append(t)
            t *= 2
        sizes.append(_cap(b))
        for t in sizes:
            phase2(llr, bits.clone(), ok, min(t, b))
        _sync()
        return sizes

    def decode_pipelined(llrs):
        """Decode a sequence of batches: every phase 1 queued first, one
        host read of the stacked counts, then each batch's phase 2.
        Returns (list of bits, aggregate stats)."""
        staged = [phase1(x) for x in llrs]
        cnts = torch.stack([c for _, _, c in staged]).tolist()
        outs = []
        agg = {"phase2_frames": 0, "phase2_batch": 0, "frames": 0}
        for x, (bits, ok, _), n_bad in zip(llrs, staged, cnts):
            b = x.shape[0]
            tail = _bucket(n_bad, b) if n_bad else 0
            agg["phase2_frames"] += n_bad
            agg["phase2_batch"] += tail
            agg["frames"] += b
            outs.append(phase2(x, bits, ok, min(tail, b)) if n_bad else bits)
        agg["eff_iters_per_frame"] = (
            k1 + spec.iters * agg["phase2_batch"] / max(agg["frames"], 1))
        return outs, agg

    def decode_pipelined_fused(llrs, tail: int = None):
        """Like ``pipelined``, but each batch is a ``step`` at the fixed
        tail ``tail`` (default ``tail_pad``), queued with no host read;
        after the window's one read of the counts, a batch whose count
        overflowed the tail is repaired (``repair``).  Returns (outs,
        aggregate stats); the stats charge a repair as the JAX package
        does, the whole batch at the full budget."""
        t = tail if tail is not None else tail_pad
        staged = [step(x, t) for x in llrs]
        cnts = torch.stack([c for _, c in staged]).tolist()
        outs = []
        agg = {"phase2_frames": 0, "phase2_batch": 0, "frames": 0,
               "overflows": 0}
        extra_full = 0
        for x, (out, _), n_bad in zip(llrs, staged, cnts):
            b = x.shape[0]
            te = min(t, b)
            agg["phase2_frames"] += n_bad
            agg["phase2_batch"] += te
            agg["frames"] += b
            if n_bad > te:  # the tail overflowed: decode again
                agg["overflows"] += 1
                extra_full += b
                outs.append(repair(x, n_bad))
            else:
                outs.append(out)
        agg["eff_iters_per_frame"] = (
            k1 + spec.iters * (agg["phase2_batch"] + extra_full)
            / max(agg["frames"], 1))
        return outs, agg

    def warm_fused(llr, tail: int = None) -> None:
        decode_pipelined_fused([llr], tail)
        _sync()

    decode.step = step
    decode.repair = repair
    decode.warm_buckets = warm_buckets
    decode.pipelined = decode_pipelined
    decode.pipelined_fused = decode_pipelined_fused
    decode.warm_fused = warm_fused
    return decode

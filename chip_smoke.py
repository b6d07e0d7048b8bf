#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``ldpcgputegra_tpu_torch/csrc/``
(all at once): the decode kernels, one library per (algorithm, minclamp)
pair each, which are the QC kernel (``layered_minsum``), the gather kernel
for non-QC codes (``gather_minsum``) and the streamed kernel for the
DVB-S2 QC views and synthqc (``streamed_minsum``); the probes of the
card's ceilings (``probes.cu``: ``probe_mix``, ``probe_peak``,
``probe_copy``), the roll probe (``roll_probe.cu``: ``probe_roll``) and
the channel's and the count's kernels (``channel_count.cu``:
``awgn_quantize``, ``count_errors``) and the accumulate encoders' kernel
(``encoder.cu``: ``accumulate_encode``).
Prints what the decode kernels compile to (SASS instructions per edge
update, registers, stack, spills).  Holds the QC kernel against the
committed golden vectors, and each kernel against its plain PyTorch
version on the card, in every variant their picks can launch
(``bench/tiles.py::check``), the gather kernel also at all 8 (algorithm,
minclamp) pairs; times both (the gather kernel also at 4000x2000 B=1024
and 384, the batches of two-phase phase 2); then drives
each kernel's path and checks that it went through the kernel: the
decoders through ``run_sweep`` and the CLI (1944x972, 4000x2000,
64800x32400), the probes through the benchmark suite
(``bench/suite.py --quick``, which measures the ceilings and times all 40
suite rows and 4 latency rows) and the odd-Z profile
(``bench/profile_1944.py``), whose outputs go to ``bench_results/smoke/``;
then the two-phase early-termination path (``decoder/twophase.py``): the
QC kernel's convergence mask against the plain decode and its syndrome in
every build, the kernel's time with and without the mask, and the
two-phase decoder at 2304x1152 over a short window, each frame checked
against the k1 and full decodes, with the kernel's launches on that path;
then the graphed sweep (``sim/scan.py``: a graphed batch's LLRs and bits
against the eager batch's, ``scan_steps`` 1 and 8 over the same batches,
K1's launches counted over the replays, both rates and their window
spans), the coded sweep on 64800x32400 (staircase, K2), 4000x2000 (GF(2),
the gather kernel) and 16200x10800 (accumulate table, K2), flooding at
4000x2000 on the card against the CPU and against the gather kernel's
time, and ``DecodeStream`` over K1; then (phase 21) the multi-device path
with every rank a process on the one card (``parallel/``,
``sim/distributed.py``): 2 gloo ranks run ``run_distributed_point`` at
1944x972 (counters equal to a one-process ``run_sweep`` over the same
seeds, K1's launches counted in the ranks) and the row-sharded decode of
2304x1152 and of 64800x32400's QC view (bits and iters_used equal to K1's
and K2's, ET on and off, with the decode's and the all-reduce's ms a
layer), 4 gloo ranks run dp x tp = 2x2 on 64800x32400 against K2, and one
NCCL rank the sharded step against K1; (phase 22) the native host library
(``golden/native.py``: its build, the host's CPU, the AVX-512 decoder at
1944x972 B=1024 against K1 and its rate beside K1's, a
``backend='native'`` Philox sweep point checked against K1, the hybrid
decoder at host fractions 0, 0.05 and 0.25 against the device's bits);
(phase 23) the plain decoder's node-major option on the card against its
frame-major decode; (phase 24) the BER spot check (``bench/ber_check.py``:
four points of the book, batch 0 through each kernel and the plain
decoder with identical counters, the sweep at each point held against the
JAX book's stored point by an exact test), with the three decode kernels'
launches in its sweeps; (phase 25) the ported JAX tools: ``bench/
hw_validate.py --quick`` (K1 against K2 at 2304x1152 B=8192 and 1944x972
B=1024, the gather kernel against the plain version at 4000x2000, the
first tail code), ``bench/et_skip_diag.py --quick`` (576x288),
``bench/vectors_check.py`` and ``bench/encoder_matrix_check.py``, with the
decode kernels' launches in them; (phase 26) the system's two root entry
points: ``python -m ldpcgputegra_tpu_torch.bench.headline`` in a process
of its own (one JSON line, its ms per call within 10% of K1's time at
2304x1152 B=8192 in this run) and ``entry.py::entry()``'s flagship step
(1944x972 B=128) bit for bit against the plain decoder, each with K1's
launches; (phase 27) the channel's and the count's kernels at the two
sweep cells' shapes (64800x32400 B=512, 4000x2000 B=4096) against the
chain of PyTorch operations they replace, byte for byte, with their
times beside their bounds and the chain's, and 16 launches of each a
graph replay of 16 sweep batches; their coded forms and the accumulate
encoders' kernel (``encoder.cu``: ``accumulate_encode``) the same at the
coded cell's shape (16200x10800 B=512), with one launch of each a batch
of a coded sweep; (phase 28) the two-phase sweep (``SweepConfig.et =
"twophase"``) at 2304x1152 B=8192, 3.0 dB, k1 5, 16 batches a graph
replay: each batch's (BE, FE, unconverged) against the eager two-phase
decoder's on the same seeds, at a tail of 256 and at a tail of 16 that
every batch overflows (each repaired at its fetch), with K1's launches
and its masked launches counted.
Imports nothing of JAX.  Exits non-zero, before printing any result, when
there is no CUDA device or the package is not beside this script; any
failing phase exits non-zero.  The last line of standard output is
``{"ok": true, "device": {...}}``; the line before it lists each kernel
with its launches on its path, its largest disagreement with the plain
version, its time, the plain version's, the library call's and its bound
(the least time the card could take, at the data sheet's rates).
"""

from __future__ import annotations

import glob
import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))


def _llrs(N: int, B: int, snr_db: float, seed: int, rate: float = 0.5):
    """int8 LLRs of the all-zero codeword at Eb/N0 ``snr_db`` for a code of
    ``rate``, from a numpy seed: clamp(8*y, +-31) truncated toward zero."""
    import numpy as np

    sigma = math.sqrt(10 ** (-0.1 * (snr_db + 10 * math.log10(rate))) / 2)
    rng = np.random.default_rng(seed)
    y = (-1.0 + sigma * rng.standard_normal((B, N))).astype(np.float32)
    return np.clip(8.0 * y, -31, 31).astype(np.int8)


def _hold(make_kernel_decoder, tag, cases, dev, seed0=100, pick=None) -> int:
    """Decode each case with the kernel and with the plain version on the
    card; both must give the same bits and ``iters_used``.  A case is
    (code, B, algo, minclamp, early_term, Eb/N0 dB[, schedule]); a staircase
    code decodes through its QC view, as ``make_decoder`` does; ``pick(code,
    B)`` names the variant the kernel's pick launches.  Returns the largest
    |bit difference| (0); fails unless early termination ended some decode
    early."""
    import torch

    from ldpcgputegra_tpu_torch.codes.registry import load_code
    from ldpcgputegra_tpu_torch.decoder import effective_code
    from ldpcgputegra_tpu_torch.ops.layered import (
        LayeredSpec,
        make_layered_decoder,
    )

    max_err = 0
    et_iters = []
    for i, (name, B, algo, mc, et, snr, *sched) in enumerate(cases):
        code = effective_code(load_code(name))
        schedule = sched[0] if sched else "auto"
        spec = LayeredSpec(algo=algo, iters=10, minclamp=mc, early_term=et,
                           schedule=schedule)
        llr = torch.from_numpy(_llrs(code.N, B, snr, seed=seed0 + i,
                                     rate=code.rate)).to(dev)
        kb, ki = make_kernel_decoder(code, spec)(llr)
        pb, pi = make_layered_decoder(code, spec, dev)(llr)
        torch.cuda.synchronize()
        err = int((kb.to(torch.int16) - pb.to(torch.int16)).abs().max())
        max_err = max(max_err, err)
        ch_err = int((llr > 0).sum())
        via = f" ({pick(code, B)})" if pick else ""
        print(f"[{tag}] {name} B={B}{via} {algo}/{mc} ET={et} {schedule} {snr} dB: "
              f"max|bits diff|={err} iters kernel={int(ki)} plain={int(pi)} "
              f"channel bit errors={ch_err} decoded={int(kb.sum())}")
        assert err == 0 and int(ki) == int(pi), "kernel disagrees with plain"
        assert et or int(ki) == 10, "fixed iterations must report iters"
        if et:
            et_iters.append(int(ki))
    assert min(et_iters) < 10, "early termination never ended a decode early"
    return max_err


def _throughput(kdec, pdec, name, B, smi, dev, seed0):
    """Kernel and plain ms per call at OMS 10, ET off (``measure_call``)."""
    import torch

    from ldpcgputegra_tpu_torch.bench import measure_call, throughput_report
    from ldpcgputegra_tpu_torch.codes.registry import load_code

    code = load_code(name)
    N = code.N
    inputs = [torch.from_numpy(_llrs(N, B, 2.0, seed=seed0 + s,
                                     rate=code.rate)).to(dev)
              for s in range(3)]
    t_k = measure_call(kdec, inputs)
    t_p = measure_call(pdec, inputs, k_small=2, k_large=6, repeats=2)
    for label, t in (("kernel", t_k), ("plain", t_p)):
        r = throughput_report(t, B, N)
        print(f"[throughput] {name} B={B} OMS 10it ET off {label}: "
              f"{r['ms_per_call']:.4f} ms/call, {r['coded_mbps']:.1f} coded "
              f"Mbit/s | {smi}")
    return t_k, t_p


def _main_path(code_name, batch, snr, cli_snr, max_frames, dev, counter, key):
    """``run_sweep`` at two SNR points and the CLI at one, on the card;
    returns the decode kernel's launches they made and the channel's and
    the count's kernels' (``kernels/channel.py``), by name.  FER must fall
    with SNR and the decoded BER must be below the raw channel BER."""
    import torch

    from ldpcgputegra_tpu_torch.channel.awgn import AwgnChannel
    from ldpcgputegra_tpu_torch.codes.registry import load_code
    from ldpcgputegra_tpu_torch.kernels import channel as C
    from ldpcgputegra_tpu_torch.sim import cli
    from ldpcgputegra_tpu_torch.sim.sweep import SweepConfig, run_sweep

    code = load_code(code_name)
    counter[key] = 0
    for name in C.launches:
        C.launches[name] = 0
    res = run_sweep(SweepConfig(
        code=code_name, algo="OMS", iters=10, early_term=True, batch=batch,
        snr_min=snr[0], snr_max=snr[1], snr_step=snr[1] - snr[0], max_fe=50,
        max_frames=max_frames, device="cuda",
    ), progress=False)
    cli.main(["--code", code_name, "--min", str(cli_snr), "--max", str(cli_snr),
              "--fer", "20", "--batch", str(batch), "--max-frames",
              str(8 * batch), "--quiet", "--device", "cuda"])
    torch.cuda.synchronize()
    n_launch = counter[key]
    c_launch = dict(C.launches)
    print(f"[main-path] {code_name}: {key} launches: {n_launch}; channel "
          f"and count launches: {c_launch}")
    assert n_launch > 0, "the main path did not run the kernel"
    zero = ("awgn_quantize", "count_errors")  # the all-zero codeword's forms
    assert all(c_launch[k] for k in zero), "the main path did not run the channel"
    assert not any(n for k, n in c_launch.items() if k not in zero), c_launch
    p_lo, p_hi = res.points
    assert p_hi.fer < p_lo.fer, "FER does not fall with SNR"
    for p in res.points:
        ch = AwgnChannel(code.N, code.K, device=dev)
        ch.configure(p.snr_db)
        raw = float((ch.generate_zero_int8(ch.generator(7), 4096) > 0)
                    .float().mean())
        print(f"[main-path] {code_name} {p.snr_db} dB: frames={p.frames} "
              f"FE={p.fe} FER={p.fer:.4e} BER={p.ber:.4e} raw channel "
              f"BER={raw:.4e} ({p.mbps:.1f} coded Mbit/s wall clock)")
        assert p.ber < raw, "decoding did not lower the BER"
    return n_launch, c_launch


def _ints(dev, n, seed, low=-31, high=32):
    """int32 [n] on ``dev``, uniform in [low, high), from a numpy seed."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(low, high, n, dtype=np.int32)).to(dev)


def _hold_probes(dev, sms):
    """Each probe kernel against its plain version on the card, exact in
    int32: the mix and the peak at a few (CTAs an SM, chains, reps), the
    int8x4 mix, the copy on 16 MiB and 256 MiB, the roll at every Z in both
    index forms.  Returns the largest |difference| by kernel (0)."""
    import torch

    from ldpcgputegra_tpu_torch.bench import profile_1944 as P
    from ldpcgputegra_tpu_torch.bench import vpu_probe as V

    def diff(a, b):
        return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())

    err = {"probe_mix": 0, "probe_peak": 0, "probe_copy": 0, "probe_roll": 0}
    full = (-2**31, 2**31 - 1)
    cases = [("mix", 1, 1, 3, False), ("mix", 2, 4, 37, False),
             ("mix", 4, 8, _probe_reps("mix", 4, 8, sms), False),
             ("mix", 8, 16, 5, False), ("peak", 1, 32, 9, False),
             ("peak", 2, 8, 6, False),
             ("peak", 4, 16, _probe_reps("peak", 4, 16, sms), False),
             ("mix", 1, 1, 3, True), ("mix", 2, 4, 37, True),
             ("mix", 4, 16, 201, True)]
    for i, (kind, ctas, chains, reps, packed) in enumerate(cases):
        x = _ints(dev, V.BLOCK * sms * ctas, 700 + i, *(full if packed else ()))
        if kind == "mix":
            k, p = V.probe_mix(x, chains, reps, packed), V.mix_plain(
                x, chains, reps, packed)
        else:
            k, p = V.probe_peak(x, chains, reps), V.peak_plain(x, chains, reps)
        torch.cuda.synchronize()
        e = diff(k, p)
        err[f"probe_{kind}"] = max(err[f"probe_{kind}"], e)
        print(f"[probe-vs-plain] {'int8x4 ' if packed else ''}{kind} "
              f"{ctas} CTAs/SM x{chains} chains, {reps} reps: max|diff|={e}")
    for mib in (16, 256):
        # 3 elements more than a whole number of int4: the scalar tail
        x = _ints(dev, (mib << 18) + 3, 720 + mib, -100, 100)
        e = diff(V.probe_copy(x), V.copy_plain(x))
        err["probe_copy"] = max(err["probe_copy"], e)
        print(f"[probe-vs-plain] copy {mib} MiB: max|diff|={e}")
    for Z in P.ZS:
        x = P.slabs(Z, dev, seed=740 + Z)
        p = P.roll_plain(x, P.N_ROLLS)
        for form in P.FORMS:
            e = diff(P.probe_roll(x, P.N_ROLLS, form), p)
            err["probe_roll"] = max(err["probe_roll"], e)
            print(f"[probe-vs-plain] roll Z={Z} {form}, {P.N_ROLLS} rolls: "
                  f"max|diff|={e}")
    assert all(v == 0 for v in err.values()), f"a probe disagrees: {err}"
    return err


def _probe_reps(kind, ctas, chains, sms):
    """The larger repetition count of the alu sweep at this configuration."""
    from ldpcgputegra_tpu_torch.bench import vpu_probe as V

    per_rep = V.OPS_PER_REP if kind == "mix" else V.PEAK_OPS_PER_REP
    return V.sweep_reps(per_rep * V.BLOCK * sms * ctas * chains)[1]


def _time_probes(dev, sms, hw, smi):
    """Each probe kernel's time at a shape its path gives it, its plain
    version's on the same inputs, the library call's where one PyTorch call
    computes the same function, and the bound at the data sheet's rates
    (``roofline.bound``).  Returns {name: (ms, plain_ms, library_ms,
    bound_ms, what sets the bound)}."""
    import torch

    from ldpcgputegra_tpu_torch.bench import measure_call
    from ldpcgputegra_tpu_torch.bench import profile_1944 as P
    from ldpcgputegra_tpu_torch.bench import vpu_probe as V
    from ldpcgputegra_tpu_torch.bench.roofline import bound

    def bound_ms(ops, nbytes, smem_seconds=0.0):
        t, by = bound(ops, nbytes, hw.alu_rate, hw.hbm_bw, smem_seconds)
        return t * 1e3, by

    out = {}
    for kind, chains, per_rep in (("mix", 8, V.OPS_PER_REP),
                                  ("peak", 16, V.PEAK_OPS_PER_REP)):
        n = V.BLOCK * sms * 4
        reps = _probe_reps(kind, 4, chains, sms)
        kfn = V.probe_mix if kind == "mix" else V.probe_peak
        pfn = V.mix_plain if kind == "mix" else V.peak_plain
        xs = [_ints(dev, n, 760 + i) for i in range(4)]
        t = measure_call(lambda x: kfn(x, chains, reps), xs)
        t_p = measure_call(lambda x: pfn(x, chains, reps), xs[:1], k_small=1,
                           k_large=2, repeats=1)
        # nvcc fuses and folds the algorithmic operations (VIADDMNMX is an
        # add and a max), so the operations the function needs are the
        # integer-ALU instructions of its chains, without the loop control
        algo = n * chains * per_rep * reps
        ops = n * chains * reps * V.sass_per_chain_rep(kind, chains)
        issued = n * reps * V.sass_per_rep(kind, chains)[1]
        out[f"probe_{kind}"] = (t * 1e3, t_p * 1e3, None,
                                *bound_ms(ops, 8 * n))
        print(f"[probe-time] {kind} 4 CTAs/SM x{chains}, {reps} reps: kernel "
              f"{t * 1e3:.4f} ms ({algo / t / 1e12:.4f} Tops/s algorithmic, "
              f"{issued / t / 1e12:.4f} T ALU instructions/s issued), plain "
              f"{t_p * 1e3:.4f} ms; bound {ops / hw.alu_rate * 1e3:.4f} ms "
              f"in the chains' ALU instructions ({issued / hw.alu_rate * 1e3:.4f}"
              f" ms with the loop control, {algo / hw.alu_rate * 1e3:.4f} ms "
              f"in algorithmic operations) | {smi}")
    n = 256 << 18
    xs = [_ints(dev, n, 770 + i, -100, 100) for i in range(4)]
    ys = torch.empty_like(xs[0])
    t = measure_call(V.probe_copy, xs)
    t_p = measure_call(V.copy_plain, xs)
    t_l = measure_call(lambda x: torch.add(x, 1, out=ys), xs)
    out["probe_copy"] = (t * 1e3, t_p * 1e3, t_l * 1e3, *bound_ms(n, 8 * n))
    print(f"[probe-time] copy 256 MiB: kernel {t * 1e3:.4f} ms "
          f"({8 * n / t / 1e9:.1f} GB/s), plain {t_p * 1e3:.4f} ms, "
          f"torch.add {t_l * 1e3:.4f} ms ({8 * n / t_l / 1e9:.1f} GB/s) | {smi}")
    Z = 96
    xs = [P.slabs(Z, dev, seed=780 + i) for i in range(4)]
    t = measure_call(lambda x: P.probe_roll(x, P.N_ROLLS, "wrap"), xs)
    t_p = measure_call(lambda x: P.roll_plain(x, P.N_ROLLS), xs, k_small=2,
                       k_large=6)
    n = xs[0].numel()
    # one slab an SM: each rotation moves two slabs through shared memory
    t_smem = P.roll_bound_ns(Z, hw.clock_hz) * P.N_ROLLS * 1e-9
    out["probe_roll"] = (t * 1e3, t_p * 1e3, None,
                         *bound_ms(n * P.N_ROLLS, 8 * n, t_smem))
    print(f"[probe-time] roll Z={Z} wrap, {P.N_ROLLS} rolls, {sms} slabs: "
          f"kernel {t * 1e3:.4f} ms, plain {t_p * 1e3:.4f} ms; bound "
          f"{out['probe_roll'][3]:.4f} ms ({out['probe_roll'][4]}; the adds "
          f"{n * P.N_ROLLS / hw.alu_rate * 1e3:.4f} ms) | {smi}")
    return out


def _hold_mask(dev, sm_count) -> int:
    """The QC kernel with its convergence mask against the plain decode and
    ``syndrome_fn`` on the card, 2NMS 5 iterations: bits, ``iters_used``
    and ``ok`` at 2304x1152 B=8192 (the two-phase path's phase 1, the
    pick's tile), and in every build at ragged batches of 1944x972 (four
    codewords a thread) and a random QC code of degree 12 (one).  Returns
    the largest |difference| (0); fails unless each batch mixes converged
    and unconverged frames."""
    import torch

    from ldpcgputegra_tpu_torch.bench import tiles
    from ldpcgputegra_tpu_torch.codes.registry import (
        load_code,
        make_random_qc_code,
    )
    from ldpcgputegra_tpu_torch.decoder.twophase import syndrome_fn
    from ldpcgputegra_tpu_torch.kernels import layered as K
    from ldpcgputegra_tpu_torch.ops.layered import (
        LayeredSpec,
        make_layered_decoder,
    )

    spec = LayeredSpec(algo="2NMS", iters=5, minclamp="post")
    max_err = 0
    for name, B, snr, every in (("2304x1152", 8192, 2.5, False),
                                ("1944x972", 1000, 2.5, True),
                                ("randqc16", 203, 3.5, True)):
        code = (make_random_qc_code(20, 4, 12, Z=16, seed=5)
                if name == "randqc16" else load_code(name))
        llr = tiles.llrs(code, B, snr, seed=800 + B).to(dev)
        pb, pi = make_layered_decoder(code, spec, dev)(llr)
        pok = syndrome_fn(code, dev)(pb)
        dec = K.make_cuda_decoder(code, spec, emit_mask=True)
        builds = tiles.layered_variants(code) if every else [
            K.pick_tile(code, B, sm_count)]
        for tile in builds:
            with tiles.forced_layered(tile):
                kb, ki, kok = dec(llr)
            torch.cuda.synchronize()
            err = max(int((kb.to(torch.int16) - pb.to(torch.int16)).abs()
                          .max()),
                      int((kok.to(torch.int16) - pok.to(torch.int16)).abs()
                          .max()),
                      abs(int(ki) - int(pi)))
            max_err = max(max_err, err)
            print(f"[mask-vs-plain] {name} B={B} tile {tile} (pack "
                  f"{K.pack(code)}) 2NMS 5 it {snr} dB: max|bits, ok, iters "
                  f"diff|={err}; ok {int(kok.sum())} of {B}")
            assert err == 0, "the mask kernel disagrees with plain"
        assert 0 < int(pok.sum()) < B, "the batch must be mixed"
    return max_err


def _twophase_path(dev, smi, alu_rate):
    """K1's time at k1=5 with and without its mask (and the mask pass's
    bound: 3 operations an edge at ``alu_rate``); then the two-phase
    decoder at 2304x1152 2NMS 2.5 dB B=8192 k1=5 over a window of 4
    batches (serial, pipelined, fused), with the kernel's launches on it
    counted, and each frame of the serial output checked against the k1
    and full decodes.  Returns (launches, mask ms, ms without the mask)."""
    import dataclasses

    import torch

    from ldpcgputegra_tpu_torch.bench import measure_call, tiles
    from ldpcgputegra_tpu_torch.channel.awgn import AwgnChannel
    from ldpcgputegra_tpu_torch.codes.registry import load_code
    from ldpcgputegra_tpu_torch.decoder.twophase import (
        make_twophase_decoder,
        syndrome_fn,
    )
    from ldpcgputegra_tpu_torch.kernels import layered as K
    from ldpcgputegra_tpu_torch.ops.layered import LayeredSpec

    code, B, k1 = load_code("2304x1152"), 8192, 5
    spec = LayeredSpec(algo="2NMS", iters=10, minclamp="post")
    spec1 = dataclasses.replace(spec, iters=k1)
    inputs = [tiles.llrs(code, B, 2.5, seed=820 + i).to(dev) for i in range(3)]
    t_off = measure_call(K.make_cuda_decoder(code, spec1), inputs)
    t_mask = measure_call(K.make_cuda_decoder(code, spec1, emit_mask=True),
                          inputs)
    mask_ops = 3 * B * code.M
    print(f"[mask-time] 2304x1152 B={B} 2NMS {k1} it: {t_mask * 1e3:.4f} ms "
          f"with the mask, {t_off * 1e3:.4f} ms without "
          f"({t_mask / t_off - 1:+.2%}); the pass's bound {mask_ops:.4e} "
          f"operations = {mask_ops / alu_rate * 1e3:.4f} ms at the best "
          f"probe | {smi}")

    tp = make_twophase_decoder(code, spec, k1=k1, device=dev)
    chan = AwgnChannel(code.N, code.K, device=dev)
    chan.configure(2.5)
    llrs = [chan.generate_zero_int8(chan.generator(840 + i), B)
            for i in range(4)]
    tp.warm_buckets(llrs[0])
    tp.warm_fused(llrs[0], 2048)
    torch.cuda.synchronize()
    K.launches["layered_minsum"] = 0
    t0 = time.perf_counter()
    serial = [tp(x) for x in llrs]
    piped, agg = tp.pipelined(llrs)
    fused, fagg = tp.pipelined_fused(llrs, 2048)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_launch = K.launches["layered_minsum"]
    print(f"[twophase] 2304x1152 B={B} 2NMS 2.5 dB k1={k1}: 4 batches x "
          f"(serial, pipelined, fused at 2048) in {wall:.4f} s wall; "
          f"layered_minsum launches: {n_launch}; pipelined {agg}; fused "
          f"{fagg} | {smi}")
    assert n_launch > 0, "the two-phase path did not run the kernel"
    d1 = K.make_cuda_decoder(code, spec1, emit_mask=True)
    d10 = K.make_cuda_decoder(code, spec)
    ok_fn = syndrome_fn(code, dev)
    for x, (bits, stats), pb, fb in zip(llrs, serial, piped, fused):
        b1, _, ok1 = d1(x)
        b10, _ = d10(x)
        assert torch.equal(ok1, ok_fn(b1)), "the mask is not the syndrome"
        assert stats["phase2_frames"] == int((~ok1).sum())
        assert torch.equal(bits[ok1], b1[ok1]), "a converged frame changed"
        assert torch.equal(bits[~ok1], b10[~ok1]), "a phase-2 frame differs"
        assert torch.equal(pb, bits) and torch.equal(fb, bits)
        assert 0 < stats["phase2_frames"] < B
        print(f"[twophase] batch: {stats}; frames checked against the k1 "
              f"and full decodes")
    assert fagg["overflows"] == 0
    return n_launch, t_mask, t_off


def _twophase_sweep(dev, smi):
    """The two-phase sweep at 2304x1152 B=8192, 3.0 dB, k1 5, S=16: every
    batch's counts against the eager two-phase decoder's, at a tail of
    256 and at one of 16 that every batch overflows; K1's launches (two a
    batch, two more a repair, two for the warm-up before the capture) and
    its masked launches (one a batch, one a repair, one warm-up).
    Returns the launches of the tail-256 sweep."""
    import torch

    from ldpcgputegra_tpu_torch.channel.awgn import AwgnChannel
    from ldpcgputegra_tpu_torch.codes.registry import load_code
    from ldpcgputegra_tpu_torch.decoder import twophase
    from ldpcgputegra_tpu_torch.kernels import layered as K
    from ldpcgputegra_tpu_torch.ops.layered import LayeredSpec
    from ldpcgputegra_tpu_torch.sim.analyzer import count_errors
    from ldpcgputegra_tpu_torch.sim.sweep import batch_seed, run_sweep

    code, B = load_code("2304x1152"), 8192
    tp = twophase.make_twophase_decoder(
        code, LayeredSpec(algo="OMS", iters=10), k1=5, device=dev)
    chan = AwgnChannel(code.N, code.K, device=dev)
    chan.configure(3.0)
    first = None
    for tail, n_batches in ((256, 64), (16, 32)):
        rows = {}
        before = dict(twophase.stats)
        l0 = dict(K.launches)
        cfg = _sweep_cfg(code="2304x1152", batch=B, snr_min=3.0,
                         snr_max=3.0, max_frames=n_batches * B,
                         pipeline_depth=1, scan_steps=16, et="twophase",
                         twophase_k1=5, twophase_tail=tail)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (p,) = run_sweep(cfg, progress=False,
                         on_counts=lambda pi, k, r: rows.update(
                             {k + j: tuple(x) for j, x in enumerate(r)})
                         ).points
        wall = time.perf_counter() - t0
        launches = {k: K.launches[k] - l0[k] for k in l0}
        delta = {k: twophase.stats[k] - before[k] for k in before}
        for k, row in rows.items():
            bits, st = tp(chan.generate_zero_int8(
                chan.generator(batch_seed(cfg.seed, 0, k)), B))
            assert row == (*count_errors(bits), st["phase2_frames"]), (
                f"batch {k}: the sweep's {row}, the eager decoder's")
        reps = delta["repairs"]
        assert p.batches == len(rows) == n_batches == delta["batches"]
        assert reps == sum(r[2] > tail for r in rows.values())
        assert (tail == 16) == (reps == n_batches), delta
        assert launches == {"layered_minsum": 2 * (n_batches + reps + 1),
                            "layered_minsum_mask": n_batches + reps + 1}, (
            launches)
        print(f"[twophase-sweep] 2304x1152 B={B} 3.0 dB k1=5 tail={tail} "
              f"S=16: {n_batches} batches equal to the eager two-phase "
              f"decoder's (BE, FE, unconverged); {delta}; K1 launches "
              f"{launches}; {p.frames * code.N / wall / 1e6:.1f} coded "
              f"Mbit/s over {wall:.3f} s with the capture | {smi}")
        first = first or launches["layered_minsum"]
    return first


def _sweep_cfg(**kw):
    """A one-point-or-more ``SweepConfig`` on the card with a frame budget
    that alone ends each point."""
    from ldpcgputegra_tpu_torch.sim.sweep import SweepConfig

    base = dict(algo="OMS", iters=10, early_term=True, max_fe=10**9,
                auto_fe=False, seed=1234, device="cuda")
    base.update(kw)
    return SweepConfig(**base)


def _timed_sweep(cfg):
    """``run_sweep`` with its window spans; (points, wall s, spans)."""
    import torch

    from ldpcgputegra_tpu_torch.sim.sweep import run_sweep

    spans = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_sweep(cfg, progress=False, on_window=lambda *w: spans.append(w))
    torch.cuda.synchronize()
    return res.points, time.perf_counter() - t0, spans


def _scan_path(dev, smi):
    """The graphed sweep (``sim/scan.py``) at 1944x972 B=1024 through K1:
    one graphed batch's int8 LLRs and decoded bits equal the eager
    batch's byte for byte; ``scan_steps`` 1 and 8 over the same 64
    batches at 1.5 and 2.0 dB give the same BE/FE; K1's launches counted
    over the graph's replays (one eager warm-up launch a capture, 8 a
    replay); then both rates with their window spans.  Returns (launches
    on the graphed sweep, {scan_steps: (Mbit/s, spans summary)})."""
    import torch

    from ldpcgputegra_tpu_torch.channel.awgn import AwgnChannel
    from ldpcgputegra_tpu_torch.codes.registry import load_code
    from ldpcgputegra_tpu_torch.decoder import make_decoder
    from ldpcgputegra_tpu_torch.kernels import layered as K
    from ldpcgputegra_tpu_torch.ops.layered import LayeredSpec
    from ldpcgputegra_tpu_torch.sim.scan import ScanSteps
    from ldpcgputegra_tpu_torch.sim.sweep import batch_seed

    name, B = "1944x972", 1024
    code = load_code(name)
    chan = AwgnChannel(code.N, code.K, device=dev)
    chan.configure(2.0)
    dec = make_decoder(code, LayeredSpec(algo="OMS", iters=10,
                                         early_term=True), device=dev)
    seeds = [batch_seed(1234, 0, k) for k in range(3)]
    g_llr = ScanSteps(lambda g: chan.generate_zero_int8(g, B), 3, dev)(seeds)
    scan = ScanSteps(lambda g: dec(chan.generate_zero_int8(g, B))[0], 3, dev)
    g_bits = scan(seeds)
    for j, s in enumerate(seeds):
        e_llr = chan.generate_zero_int8(chan.generator(s), B)
        e_bits, _ = dec(e_llr)
        assert torch.equal(g_llr[j], e_llr), "graphed LLRs differ from eager"
        assert torch.equal(g_bits[j], e_bits), "graphed bits differ from eager"
    torch.cuda.synchronize()
    print(f"[scan] {name} B={B}: 3 graphed batches' int8 LLRs and decoded "
          f"bits equal the eager batches' byte for byte "
          f"(channel bit errors {int((g_llr[0] > 0).sum())}); the warm-up and "
          f"capture of 3 decodes took {scan.capture_s * 1e3:.1f} ms")
    counts = {}
    for S in (1, 8):
        K.launches["layered_minsum"] = 0
        pts, wall, _ = _timed_sweep(_sweep_cfg(
            code=name, batch=B, snr_min=1.5, snr_max=2.0, snr_step=0.5,
            max_frames=64 * B, pipeline_depth=1, scan_steps=S))
        counts[S] = [(p.frames, p.be, p.fe) for p in pts]
        n_launch = K.launches["layered_minsum"]
        batches = sum(p.batches for p in pts)
        print(f"[scan] scan_steps {S}: {counts[S]} (frames, BE, FE) at 1.5 "
              f"and 2.0 dB; layered_minsum launches {n_launch} for "
              f"{batches} batches")
        # a graphed run's warm-up is one eager launch; each replay adds 8
        assert n_launch == batches + (S > 1), (n_launch, batches)
    assert counts[1] == counts[8], "scan_steps changed the counts"
    assert all(fe > 0 for _, _, fe in counts[1])
    rates = {}
    K.launches["layered_minsum"] = 0
    for S in (1, 8, 1, 8):
        pts, wall, spans = _timed_sweep(_sweep_cfg(
            code=name, batch=B, snr_min=2.0, snr_max=2.0,
            max_frames=1024 * B, scan_steps=S))
        (p,) = pts
        disp, fetch = sum(w[0] for w in spans), sum(w[1] for w in spans)
        mbps = p.frames * code.N / wall / 1e6
        rates.setdefault(S, []).append(mbps)
        print(f"[scan] {name} B={B} 2.0 dB scan_steps {S}: {p.batches} "
              f"batches in {wall:.4f} s, {mbps:.1f} coded Mbit/s (the "
              f"point's own clock: {p.mbps:.1f}); "
              f"{len(spans)} windows, {p.batches / len(spans):.2f} batches a "
              f"window, dispatch {disp * 1e3:.3f} ms, fetch wait "
              f"{fetch * 1e3:.3f} ms | {smi}")
    n_launch = K.launches["layered_minsum"]
    assert n_launch > 0, "the graphed sweep did not run the kernel"
    return n_launch, rates


def _coded_paths(dev, smi):
    """The coded sweep at the registry's sizes, each through its kernel:
    64800x32400 B=512 staircase (K2), 4000x2000 B=4096 GF(2) (the gather
    kernel), 16200x10800 B=1024 accumulate table (K2); BER below the raw
    channel BER, launches counted, and the coded rate beside the fake
    encoder's at the same code and batch, both by the point's own clock
    (``SnrPoint.mbps``: the encoder's set-up, a GF(2) elimination, is
    outside it); the table and staircase encoders launch their kernel
    once a batch.  Returns {kernel: launches}."""
    import torch

    from ldpcgputegra_tpu_torch.channel.awgn import AwgnChannel
    from ldpcgputegra_tpu_torch.codes.registry import load_code
    from ldpcgputegra_tpu_torch.kernels import channel as C
    from ldpcgputegra_tpu_torch.kernels import encoder as KE
    from ldpcgputegra_tpu_torch.kernels import gather as G
    from ldpcgputegra_tpu_torch.kernels import streamed as S

    launches = {"streamed_minsum": 0, "gather_minsum": 0,
                "accumulate_encode": 0}
    for name, B, enc, snr, n_batches, mod, key in (
            ("64800x32400", 512, "staircase", 1.5, 8, S, "streamed_minsum"),
            ("4000x2000", 4096, "gf2", 2.0, 16, G, "gather_minsum"),
            ("16200x10800", 1024, "table", 3.0, 16, S, "streamed_minsum")):
        code = load_code(name)
        ch = AwgnChannel(code.N, code.K, device=dev)
        ch.configure(snr)
        raw = float((ch.generate_zero_int8(ch.generator(7), 256) > 0)
                    .float().mean())
        rate = {}
        for e in (enc, "fake", enc):
            mod.launches[key] = 0
            coded0 = C.launches["awgn_quantize_coded"]
            enc0 = KE.launches["accumulate_encode"]
            (p,), wall, _ = _timed_sweep(_sweep_cfg(
                code=name, batch=B, snr_min=snr, snr_max=snr, encoder=e,
                max_frames=n_batches * B))
            if e == enc:
                launches[key] += mod.launches[key]
                assert mod.launches[key] > 0, f"{name}: no {key} launch"
                assert p.ber < raw, f"{name}: decoding did not lower the BER"
                # the channel on coded bits is the coded kernel, a batch each
                assert (C.launches["awgn_quantize_coded"] - coded0
                        == mod.launches[key]), f"{name}: the coded channel"
                # the table and staircase encoders: the kernel, a batch each
                encoded = KE.launches["accumulate_encode"] - enc0
                assert encoded == mod.launches[key] * (e != "gf2"), \
                    f"{name}: the encoder's kernel"
                launches["accumulate_encode"] += encoded
            rate.setdefault(e, []).append(p.mbps)
            print(f"[coded] {name} B={B} {e} {snr} dB: {p.frames} frames, "
                  f"FE={p.fe} FER={p.fer:.4e} BER={p.ber:.4e} (raw channel "
                  f"{raw:.4e}), {key} launches {mod.launches[key]}, "
                  f"{p.mbps:.1f} coded Mbit/s by the point's clock, "
                  f"{p.frames * code.N / wall / 1e6:.1f} with the set-up "
                  f"| {smi}")
        print(f"[coded] {name} B={B}: coded / fake rate "
              f"{max(rate[enc]) / max(rate['fake']):.4f} (best of each)")
    torch.cuda.synchronize()
    return launches


def _flooding_path(dev, smi):
    """Flooding at 4000x2000 (plain PyTorch on the card): a 64-frame batch
    decoded on the card equals the CPU's, OMS 20 iterations, ET on and
    off; its ms a call at B=4096 beside the gather kernel's layered decode
    (OMS 10); then a flooding sweep at B=4096.  Returns (flooding ms,
    gather ms)."""
    import torch

    from ldpcgputegra_tpu_torch.bench import measure_call
    from ldpcgputegra_tpu_torch.codes.registry import load_code
    from ldpcgputegra_tpu_torch.decoder import make_decoder
    from ldpcgputegra_tpu_torch.ops.flooding import make_flooding_decoder
    from ldpcgputegra_tpu_torch.ops.layered import LayeredSpec

    code = load_code("4000x2000")
    for et in (True, False):
        spec = LayeredSpec(algo="OMS", iters=20, early_term=et,
                           schedule="flooding")
        llr = torch.from_numpy(_llrs(code.N, 64, 1.5, seed=900))
        cb, ci = make_flooding_decoder(code, spec, "cpu")(llr)
        gb, gi = make_flooding_decoder(code, spec, dev)(llr.to(dev))
        assert torch.equal(gb.cpu(), cb) and int(gi) == int(ci), \
            "flooding on the card differs from the CPU"
        print(f"[flooding] 4000x2000 B=64 OMS 20 it ET={et} 1.5 dB: card "
              f"equals CPU (iters {int(gi)}, decoded errors "
              f"{int(gb.sum())} of channel {int((llr > 0).sum())})")
    inputs = [torch.from_numpy(_llrs(code.N, 4096, 2.0, seed=910 + i)).to(dev)
              for i in range(3)]
    t_f = measure_call(make_flooding_decoder(code, LayeredSpec(
        algo="OMS", iters=20, schedule="flooding"), dev), inputs, k_small=1,
        k_large=4, repeats=2)
    t_g = measure_call(make_decoder(code, LayeredSpec(algo="OMS", iters=10),
                                    device=dev), inputs)
    print(f"[flooding] 4000x2000 B=4096 ET off: flooding OMS 20 it "
          f"{t_f * 1e3:.4f} ms a call, the gather kernel's layered OMS 10 it "
          f"{t_g * 1e3:.4f} ms ({t_f / t_g:.2f}x) | {smi}")
    (p,), wall, _ = _timed_sweep(_sweep_cfg(
        code="4000x2000", batch=4096, iters=20, schedule="flooding",
        snr_min=2.0, snr_max=2.0, max_frames=4 * 4096))
    print(f"[flooding] sweep 4000x2000 B=4096 OMS 20 it ET on 2.0 dB: "
          f"{p.frames} frames FER={p.fer:.4e} BER={p.ber:.4e}, "
          f"{p.frames * code.N / wall / 1e6:.1f} coded Mbit/s | {smi}")
    assert p.fe < p.frames
    return t_f, t_g


def _stream_path(dev):
    """``DecodeStream`` over K1 at 1944x972 B=1024, depth 2: results in
    order equal direct decodes; returns K1's launches on it."""
    import numpy as np
    import torch

    from ldpcgputegra_tpu_torch.codes.registry import load_code
    from ldpcgputegra_tpu_torch.decoder import make_decoder
    from ldpcgputegra_tpu_torch.decoder.stream import DecodeStream
    from ldpcgputegra_tpu_torch.kernels import layered as K
    from ldpcgputegra_tpu_torch.ops.layered import LayeredSpec

    code = load_code("1944x972")
    spec = LayeredSpec(algo="OMS", iters=10, early_term=True)
    xs = [torch.from_numpy(_llrs(code.N, 1024, 1.75, seed=950 + i)).to(dev)
          for i in range(5)]
    stream = DecodeStream(code, spec, depth=2, device=dev)
    torch.cuda.synchronize()
    K.launches["layered_minsum"] = 0
    for x in xs:
        stream.submit(x)
    got = list(stream.drain())
    n_launch = K.launches["layered_minsum"]
    direct = make_decoder(code, spec, device=dev)
    for x, (bits, iters) in zip(xs, got):
        ref, ref_it = direct(x)
        assert np.array_equal(bits, ref.cpu().numpy()) and iters == int(ref_it)
    print(f"[stream] DecodeStream 1944x972 B=1024 depth 2: 5 batches in "
          f"order, equal to direct decodes; layered_minsum launches "
          f"{n_launch}; iters {[it for _, it in got]}")
    assert n_launch == 5 and stream.pending == 0
    return n_launch


def _ranks_job(rank, job):
    """One rank of phase 21, spawned by ``parallel/launch.py::run_ranks``
    with every rank on the one card: ``job["point"]`` runs
    ``run_distributed_point`` (its counters on rank 0, and this rank's K1
    launches); ``job["cases"]`` go through ``parallel/dryrun.py::
    decode_cases``; ``job["timing"]`` times one row-sharded decode with a
    fixed number of iterations and the all-reduce of one layer's delta
    slab, ``[max deg, Z, B]`` int32.  ``out["started"]`` is the wall clock
    when the rank, spawned and in its group, begins the job."""
    started = time.time()
    import torch
    import torch.distributed as dist

    from ldpcgputegra_tpu_torch.codes.registry import load_code
    from ldpcgputegra_tpu_torch.codes.schedule import build_layers
    from ldpcgputegra_tpu_torch.decoder import effective_code
    from ldpcgputegra_tpu_torch.kernels import layered as K
    from ldpcgputegra_tpu_torch.ops.layered import LayeredSpec
    from ldpcgputegra_tpu_torch.parallel import (
        decode_mesh,
        make_rowsharded_decoder,
    )
    from ldpcgputegra_tpu_torch.parallel.dryrun import decode_cases
    from ldpcgputegra_tpu_torch.sim.distributed import run_distributed_point

    out = {"started": started}
    if job.get("point"):
        name, snr, batch, batches = job["point"]
        K.launches["layered_minsum"] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a = run_distributed_point(name, snr, batch, batches, LayeredSpec(
            algo="OMS", iters=10, early_term=True), seed=1234, device="cuda")
        torch.cuda.synchronize()
        out["point"] = (None if a is None else
                        (a.frames, a.bit_errors, a.frame_errors),
                        K.launches["layered_minsum"],
                        time.perf_counter() - t0)
    out["cases"] = decode_cases(rank, job.get("cases", []), "cuda")
    if job.get("timing"):
        name, iters, llr = job["timing"]
        view = effective_code(load_code(name))
        layers = build_layers(view, "auto")
        dec = make_rowsharded_decoder(view, LayeredSpec(algo="OMS",
                                                        iters=iters),
                                      decode_mesh(), device="cuda")
        x = torch.from_numpy(llr).cuda()
        dec(x)
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        dec(x)
        torch.cuda.synchronize()
        t_dec = time.perf_counter() - t0
        slab = torch.zeros((max(l.deg for l in layers), view.Z, x.shape[0]),
                           dtype=torch.int32, device="cuda")
        for _ in range(5):
            dist.all_reduce(slab)
        torch.cuda.synchronize()
        dist.barrier()
        reps = 100
        t0 = time.perf_counter()
        for _ in range(reps):
            dist.all_reduce(slab)
        torch.cuda.synchronize()
        out["timing"] = {
            "decode_ms": t_dec * 1e3, "layer_steps": len(layers) * iters,
            "allreduce_ms": (time.perf_counter() - t0) / reps * 1e3,
            "slab_bytes": slab.numel() * 4}
    return out


def _multi_device(dev, smi):
    """Phase 21: the multi-device path on the one card, every rank a
    process on ``cuda:0`` (gloo: NCCL refuses two ranks on one card).

    2 ranks: ``run_distributed_point`` at 1944x972, global batch 2048
    (1024 a rank through K1) x 8 batches, whose (frames, BE, FE) must equal
    a one-process ``run_sweep`` over the same seeds; the row-sharded decode
    at D=2 of 2304x1152 (B=64, 10 iterations) and of 64800x32400's QC
    view (B=4, 6 iterations), whose bits and iters_used must equal K1's
    and K2's, ET on and off; the decode's ms and the all-reduce's ms a
    layer.  4 ranks: dp x tp = 2x2 on 64800x32400 (B=8, 6 iterations)
    against K2.  1 NCCL rank: the sharded step at
    1944x972 B=1024 against K1.  Returns K1's launches in the ranks'
    point."""
    import numpy as np
    import torch

    from ldpcgputegra_tpu_torch.codes.registry import load_code
    from ldpcgputegra_tpu_torch.decoder import effective_code
    from ldpcgputegra_tpu_torch.kernels import layered as K
    from ldpcgputegra_tpu_torch.kernels import streamed as S
    from ldpcgputegra_tpu_torch.ops.layered import LayeredSpec
    from ldpcgputegra_tpu_torch.parallel.launch import run_ranks

    specs = {et: LayeredSpec(algo="OMS", iters=10, early_term=et)
             for et in (False, True)}
    # 64800x32400: 6 iterations (105 layers, an all-reduce each), at 2.0 dB
    # where ET stops early
    specs64 = {et: LayeredSpec(algo="OMS", iters=6, early_term=et)
               for et in (False, True)}
    l2304 = _llrs(2304, 64, 2.0, seed=1100)
    l64800 = _llrs(64800, 8, 2.0, seed=1101)
    row_cases = [{"kind": "rowshard", "code": name, "spec": sp[et],
                  "llr": llr} for name, llr, sp in (
                      ("2304x1152", l2304, specs),
                      ("64800x32400", l64800[:4], specs64))
                 for et in (False, True)]
    t0, w0 = time.perf_counter(), time.time()
    res2 = run_ranks(_ranks_job, 2, ({
        "point": ("1944x972", 2.0, 2048, 8), "cases": row_cases,
        "timing": ("64800x32400", 3, l64800[:4])},), threads=0,
        timeout=300)
    t_2 = time.perf_counter() - t0
    point, k_launch = res2[0]["point"][0], sum(r["point"][1] for r in res2)
    (one,), _, _ = _timed_sweep(_sweep_cfg(
        code="1944x972", batch=2048, snr_min=2.0, snr_max=2.0,
        max_frames=8 * 2048, pipeline_depth=1))
    print(f"[multi] run_distributed_point 1944x972 2 gloo ranks on one card, "
          f"global batch 2048 x 8 at 2.0 dB: (frames, BE, FE) {point}, "
          f"one-process run_sweep {(one.frames, one.be, one.fe)}; "
          f"layered_minsum launches in the ranks {k_launch}; point wall "
          f"{max(r['point'][2] for r in res2):.3f} s | {smi}")
    assert point == (one.frames, one.be, one.fe) and one.fe > 0
    assert k_launch == 2 * 8, k_launch
    refs = {"2304x1152": K.make_cuda_decoder,
            "64800x32400": S.make_streamed_decoder}
    for i, case in enumerate(row_cases):
        code = effective_code(load_code(case["code"]))
        kb, ki = refs[case["code"]](code, case["spec"])(
            torch.from_numpy(case["llr"]).to(dev))
        kb = kb.cpu().numpy()
        for r in res2:
            got = r["cases"][i]
            assert np.array_equal(got["bits"], kb), (case["code"], i)
            assert got["iters"] == int(ki), (got["iters"], int(ki))
        print(f"[multi] rowshard D=2 {case['code']} B={len(case['llr'])} "
              f"ET={case['spec'].early_term}: bits and iters_used "
              f"({int(ki)}) equal {refs[case['code']].__module__}'s "
              f"(decoded errors {int(kb.sum())})")
    tm = res2[0]["timing"]
    print(f"[multi] rowshard D=2 64800x32400 B=4 OMS 3 it ET off: "
          f"{tm['decode_ms']:.3f} ms a decode, {tm['layer_steps']} layer "
          f"steps, {tm['decode_ms'] / tm['layer_steps']:.4f} ms a layer; the "
          f"gloo all-reduce of one layer's {tm['slab_bytes']} B slab "
          f"{tm['allreduce_ms']:.4f} ms | {smi}")
    print(f"[phase 21] two ranks: {t_2:.1f} s, of which the ranks' start "
          f"(spawn, torch's import, the gloo group) "
          f"{max(r['started'] for r in res2) - w0:.3f} s")

    dp_tp = [{"kind": "dp_tp", "code": "64800x32400", "spec": specs64[et],
              "llr": l64800, "dp": 2, "tp": 2} for et in (False, True)]
    t0, w0 = time.perf_counter(), time.time()
    res4 = run_ranks(_ranks_job, 4, ({"cases": dp_tp},), threads=0,
                     timeout=300)
    print(f"[phase 21] four ranks: {time.perf_counter() - t0:.1f} s, of "
          f"which the ranks' start {max(r['started'] for r in res4) - w0:.3f}"
          f" s")
    view = effective_code(load_code("64800x32400"))
    for i, case in enumerate(dp_tp):
        kb, ki = S.make_streamed_decoder(view, case["spec"])(
            torch.from_numpy(l64800).to(dev))
        kb = kb.cpu().numpy()
        err = kb.astype(np.int64)
        for rank, r in enumerate(res4):
            got = r["cases"][i]
            row = rank // 2
            assert np.array_equal(got["bits"], kb[4 * row:4 * row + 4])
            assert got["iters"] == int(ki)
            assert (got["be"], got["fe"]) == (int(err.sum()),
                                              int(err.any(1).sum()))
        print(f"[multi] dp x tp 2x2 64800x32400 B=8 ET={case['spec'].early_term}"
              f": bits, iters_used ({int(ki)}), BE and FE equal K2's "
              f"({time.perf_counter() - t0:.1f} s with the ranks' start)")

    llr = _llrs(1944, 1024, 2.0, seed=1102)
    t0, w0 = time.perf_counter(), time.time()
    (r1,) = run_ranks(_ranks_job, 1, ({"cases": [
        {"kind": "sharded", "code": "1944x972", "spec": specs[True],
         "llr": llr}]},), backend="nccl", threads=0, timeout=120)
    print(f"[phase 21] one NCCL rank: {time.perf_counter() - t0:.1f} s, of "
          f"which its start {r1['started'] - w0:.3f} s")
    kb, ki = K.make_cuda_decoder(load_code("1944x972"), specs[True])(
        torch.from_numpy(llr).to(dev))
    kb = kb.cpu().numpy()
    got = r1["cases"][0]
    assert np.array_equal(got["bits"], kb) and got["iters"] == int(ki)
    assert (got["be"], got["fe"]) == (int(kb.sum()),
                                      int(kb.any(1).sum()))
    print(f"[multi] sharded step over one NCCL rank, 1944x972 B=1024: bits, "
          f"iters_used and (BE, FE) {(got['be'], got['fe'])} equal K1's")
    return k_launch


def _native_path(dev, smi, t_k1024):
    """Phase 22: the native host library (``golden/native.py``): its build
    and the host's CPU; the AVX-512 decoder at 1944x972 B=1024 against K1
    bit for bit, and its coded Mbit/s beside K1's (``t_k1024``, s a call,
    OMS 10 ET off); a ``backend='native'`` Philox sweep point with its
    batch-0 check against K1; the hybrid decoder at host_fraction 0, 0.05
    and 0.25 against the device's bits, with the wall ms of each.  Without
    AVX-512BW on the host the SIMD parts are skipped and said so.  Returns
    K1's launches on the native sweep (its cross-check)."""
    import numpy as np
    import torch

    from ldpcgputegra_tpu_torch.codes.registry import load_code
    from ldpcgputegra_tpu_torch.decoder.extras import make_hybrid_decoder
    from ldpcgputegra_tpu_torch.golden import GoldenParams
    from ldpcgputegra_tpu_torch.golden import native
    from ldpcgputegra_tpu_torch.kernels import layered as K
    from ldpcgputegra_tpu_torch.ops.layered import LayeredSpec

    info = native.build()
    with open("/proc/cpuinfo") as f:
        cpu = {}
        for line in f:  # the first processor's fields
            key, _, val = line.partition(":")
            if not key.strip() and cpu:
                break
            cpu.setdefault(key.strip(), val.strip())
    flags = cpu.get("flags", "").split()
    # a virtual machine may report the model name as "unknown": the vendor,
    # family and model numbers beside it name the part
    model = (f"{cpu.get('model name', 'unknown')} ({cpu.get('vendor_id')} "
             f"family {cpu.get('cpu family')} model {cpu.get('model')})")
    print(f"[native] {os.path.relpath(info['path'], HERE)} built in "
          f"{info['seconds']:.2f} s; host CPU {model}, {os.cpu_count()} "
          f"logical CPUs; avx512bw {'avx512bw' in flags}; SIMD lanes "
          f"{64 if native.simd_available() else 0}")
    code = load_code("1944x972")
    B = 1024
    k_launch = 0
    if native.simd_available():
        spec = LayeredSpec(algo="OMS", iters=10)
        gp = GoldenParams(algo="OMS", iters=10)
        llrs = [_llrs(code.N, B, 2.0, seed=1200 + i) for i in range(4)]
        kb, _ = K.make_cuda_decoder(code, spec)(torch.from_numpy(llrs[0])
                                                 .to(dev))
        nb, _ = native.decode_simd_native(code, llrs[0], gp)
        assert np.array_equal(nb, kb.cpu().numpy()), "SIMD decoder != K1"
        native.decode_simd_native(code, llrs[1], gp)  # warm
        t0 = time.perf_counter()
        for x in llrs:
            native.decode_simd_native(code, x, gp)
        t_n = (time.perf_counter() - t0) / len(llrs)
        print(f"[native] decode_simd_native 1944x972 B={B} OMS 10 it ET off: "
              f"bits equal K1's; {t_n * 1e3:.3f} ms a call, "
              f"{B * code.N / t_n / 1e6:.1f} coded Mbit/s on {model}; K1 "
              f"{t_k1024 * 1e3:.4f} ms, {B * code.N / t_k1024 / 1e6:.1f} "
              f"coded Mbit/s | {smi}")
        K.launches["layered_minsum"] = 0
        (p,), wall, _ = _timed_sweep(_sweep_cfg(
            code="1944x972", batch=B, snr_min=2.0, snr_max=2.0,
            max_frames=16 * B, backend="native", channel_rng="philox"))
        k_launch = K.launches["layered_minsum"]
        print(f"[native] backend='native' philox sweep 1944x972 B={B} 2.0 dB:"
              f" {p.frames} frames FE={p.fe} BER={p.ber:.4e}, batch 0 checked"
              f" against K1 ({k_launch} layered_minsum launch), "
              f"{p.frames * code.N / wall / 1e6:.1f} coded Mbit/s on {model}")
        assert k_launch == 1 and p.fe < p.frames
    else:
        print(f"[native] no AVX-512BW on this host: the SIMD decoder and "
              f"backend='native' are not run; CPU flags: {' '.join(flags)}")
    spec = LayeredSpec(algo="OMS", iters=10, early_term=True)
    x = torch.from_numpy(_llrs(code.N, B, 2.0, seed=1210)).to(dev)
    kb, ki = K.make_cuda_decoder(code, spec)(x)
    for fraction in (0.0, 0.05, 0.25):
        hybrid = make_hybrid_decoder(code, spec, host_fraction=fraction,
                                     device=dev)
        hybrid(x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hb, hi = hybrid(x)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        assert torch.equal(hb, kb), f"hybrid {fraction} != the device's bits"
        print(f"[native] hybrid 1944x972 B={B} OMS 10 ET host_fraction "
              f"{fraction}: bits equal K1's, iters_used {int(hi)} (K1 "
              f"{int(ki)}); {wall * 1e3:.3f} ms wall ({int(B * fraction)} "
              f"frames on the scalar oracle, {model}) | {smi}")
    return k_launch


def _node_major_path(dev):
    """Phase 23: the plain decoder's node-major option on the card equals
    its frame-major decode (1944x972 and the 16200x7560 view, ET on)."""
    import torch

    from ldpcgputegra_tpu_torch.codes.registry import load_code
    from ldpcgputegra_tpu_torch.decoder import effective_code
    from ldpcgputegra_tpu_torch.ops.layered import (
        LayeredSpec,
        make_layered_decoder,
    )

    spec = LayeredSpec(algo="OMS", iters=10, early_term=True)
    for name, B in (("1944x972", 256), ("16200x7560", 32)):
        code = effective_code(load_code(name))
        x = torch.from_numpy(_llrs(code.N, B, 2.0, seed=1300,
                                   rate=code.rate)).to(dev)
        nb, ni = make_layered_decoder(code, spec, dev, node_major=True)(
            x.t().contiguous())
        fb, fi = make_layered_decoder(code, spec, dev)(x)
        assert torch.equal(nb.t(), fb) and int(ni) == int(fi)
        print(f"[node-major] {name} B={B}: [N, B] decode on the card equals "
              f"the frame-major one (iters {int(ni)})")


def _ber_spots(dev, smi):
    """Phase 24, the BER spot check (``bench/ber_check.py``): at each of
    its four ``SPOTS`` on the card, batch 0 through the kernel and through
    the plain decoder (identical bits and counters, or ``SystemExit``),
    then ``run_sweep`` at the spot held against the JAX book's stored
    point by the exact test (p >= ``P_FAIL``).  Returns each decode
    kernel's launches in the sweeps (stage 1's comparison not counted)."""
    import torch

    from ldpcgputegra_tpu_torch.bench import ber_check
    from ldpcgputegra_tpu_torch.kernels import gather as G
    from ldpcgputegra_tpu_torch.kernels import layered as K
    from ldpcgputegra_tpu_torch.kernels import streamed as S

    counters = {"layered_minsum": K.launches, "gather_minsum": G.launches,
                "streamed_minsum": S.launches}
    launches = dict.fromkeys(counters, 0)
    for spot in ber_check.SPOTS:
        code, algo, iters, snr, batch, _ = spot
        dec = ber_check.decoder_stage(code, algo, iters, snr, batch, dev)
        torch.cuda.synchronize()
        for name, c in counters.items():
            c[name] = 0
        rec = ber_check.sweep_stage(spot, dev)
        torch.cuda.synchronize()
        for name, c in counters.items():
            launches[name] += c[name]
        print(f"[ber] {code} {algo} {iters} it {snr} dB B={batch}: batch 0 "
              f"through {dec['backend']} and the plain decoder: BE {dec['be']} "
              f"FE {dec['fe']} both; sweep frames={rec['frames']} "
              f"FE={rec['fe']} FER={rec['fer']:.4e}, stored FER "
              f"{rec['stored_fer']:.4e} ({rec['stored_fe']}/"
              f"{rec['stored_frames']}), p={rec['p']:.4g}, "
              f"{rec['mbps']:.1f} coded Mbit/s | {smi}")
        assert rec["p"] >= ber_check.P_FAIL, f"{spot} fails the exact test"
    print(f"[ber] launches in the spots' sweeps: {launches}")
    assert all(n > 0 for n in launches.values()), launches
    return launches


def _tools(dev, out_dir):
    """Phase 25: the ported JAX tools on the card, each failing the run on a
    mismatch (``SystemExit``): ``hw_validate --quick`` (K1 against K2 on
    K1's codes, the gather kernel and a tail code against the plain
    version, bit for bit), ``et_skip_diag --quick`` on 576x288,
    ``vectors_check`` and ``encoder_matrix_check``.  Returns each decode
    kernel's launches in them."""
    import torch

    from ldpcgputegra_tpu_torch.bench import (
        encoder_matrix_check,
        et_skip_diag,
        hw_validate,
        vectors_check,
    )
    from ldpcgputegra_tpu_torch.kernels import gather as G
    from ldpcgputegra_tpu_torch.kernels import layered as K
    from ldpcgputegra_tpu_torch.kernels import streamed as S

    counters = {"layered_minsum": K.launches, "gather_minsum": G.launches,
                "streamed_minsum": S.launches}
    for name, c in counters.items():
        c[name] = 0
    hw_out = os.path.join(out_dir, "HWVALIDATE.md")
    assert hw_validate.main(["--which", "streamed,gather,tail", "--quick",
                             "--out", hw_out]) == 0
    assert et_skip_diag.main(["--quick", "--out",
                              os.path.join(out_dir, "ET.md")]) == 0
    assert vectors_check.main([]) == 0
    assert encoder_matrix_check.main([]) == 0
    torch.cuda.synchronize()
    launches = {name: c[name] for name, c in counters.items()}
    with open(hw_out) as f:
        recs = [json.loads(line) for line in f if line.startswith("{")]
    for r in recs:
        if (r["a"], r["b"]) == ("cuda", "cuda-streamed"):
            k1, k2 = r["rows"]
            print(f"[tools] {r['code']} B={r['batch']}: K1 ({k1['variant']}) "
                  f"{k1['ms']:.4f} ms, K2 ({k2['variant']}) {k2['ms']:.4f} "
                  f"ms, K2 / K1 {k2['ms'] / k1['ms']:.3f}, bit-exact | "
                  f"{r['card']}")
    print(f"[tools] launches in the tools: {launches}")
    assert all(n > 0 for n in launches.values()), launches
    return launches


def _headline(t_k1, smi):
    """Phase 26 (a): ``python -m ldpcgputegra_tpu_torch.bench.headline`` in
    a process of its own.  Its one stdout line must carry the record's keys
    and metric, and its ms per call lie within 10% of phase 5's K1 time
    at the same shape (``t_k1`` seconds); returns the line and the K1
    launches its ``(PERF)`` line reports."""
    from ldpcgputegra_tpu_torch.bench import headline

    res = subprocess.run(
        [sys.executable, "-m", "ldpcgputegra_tpu_torch.bench.headline"],
        cwd=HERE, env={**os.environ, "PYTHONPATH": HERE},
        capture_output=True, text=True, timeout=600,
    )
    assert res.returncode == 0, res.stderr
    out = res.stdout.strip().splitlines()
    assert len(out) == 1, res.stdout
    rec = json.loads(out[0])
    assert set(rec) == {"metric", "value", "unit", "vs_baseline", "device"}
    assert rec["metric"] == headline.METRIC and rec["device"] == smi, rec
    perf = [ln for ln in res.stderr.splitlines() if ln.startswith("(PERF)")]
    assert len(perf) == 1, res.stderr
    ms = float(perf[0].split(": ")[1].split(" ms/call")[0])
    n_launch = int(perf[0].split("K1 launches ")[1].split()[0])
    print(f"[headline] {out[0]}")
    print(f"[headline] {perf[0]}")
    print(f"[headline] {ms:.4f} ms/call against phase 5's K1 "
          f"{t_k1 * 1e3:.4f} ms ({ms / (t_k1 * 1e3):.4f}x), K1 launches "
          f"{n_launch} | {smi}")
    assert abs(ms / (t_k1 * 1e3) - 1) <= 0.10, "the headline's harness is off"
    assert n_launch > 0, "the headline did not run K1"
    return out[0], n_launch


def _entry(dev):
    """Phase 26 (b): ``entry()`` on the card; its step's bits and
    ``iters_used`` against the plain decoder's on the same tensor, bit for
    bit; returns K1's launches in the step."""
    import torch

    from ldpcgputegra_tpu_torch import entry as E
    from ldpcgputegra_tpu_torch.codes.registry import load_code
    from ldpcgputegra_tpu_torch.kernels import layered as K
    from ldpcgputegra_tpu_torch.ops.layered import make_layered_decoder

    fn, args = E.entry()
    torch.cuda.synchronize()
    K.launches["layered_minsum"] = 0
    bits, iters = fn(*args)
    torch.cuda.synchronize()
    n_launch = K.launches["layered_minsum"]
    ref_bits, ref_iters = make_layered_decoder(load_code(E.CODE), E.SPEC,
                                               dev)(*args)
    (llr,) = args
    print(f"[entry] {E.CODE} B={llr.shape[0]} on {llr.device}: iters_used "
          f"{int(iters)} (plain {int(ref_iters)}), channel bit errors "
          f"{int((llr > 0).sum())}, decoded {int(bits.sum())}, K1 launches "
          f"{n_launch}")
    assert torch.equal(bits, ref_bits) and int(iters) == int(ref_iters), (
        "entry()'s step differs from the plain decoder")
    assert n_launch > 0, "entry()'s step did not run K1"
    return n_launch


def _device_us(fn, inputs, k=24):
    """Device microseconds a ``fn(x)`` call takes, ``x`` cycled through
    ``inputs``, by the profiler: every kernel, copy and fill of ``k``
    calls over ``k``; and the same by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ldpcgputegra_tpu_torch.bench.harness import device_time_by_kernel

    for x in inputs:
        fn(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(k):
            fn(inputs[i % len(inputs)])
        torch.cuda.synchronize()
    by_name = {n: us / k for n, us in device_time_by_kernel(prof).items()}
    return sum(by_name.values()), by_name


# the two sweep cells' shapes: (code, batch)
CHANNEL_SHAPES = (("64800x32400", 512), ("4000x2000", 4096))
# the coded sweep cell's: (code, batch, Eb/N0 dB); the info bits counted
CODED_SHAPE = ("16200x10800", 512, 2.4)


def _channel_chain(chan, gen, bits):
    """The chain of PyTorch operations that the channel's kernel replaces,
    for coded bits: ``generate_float`` then the quantizer."""
    from ldpcgputegra_tpu_torch.channel.awgn import _quantize

    return _quantize(gen, chan.generate_float(gen, bits), chan._scalars[1],
                     chan.spec)


def _channel_count(dev, hbm, smi, main_launches, coded_encodes):
    """Phase 27: the channel's and the count's kernels
    (``kernels/channel.py``, ``csrc/channel_count.cu``; they replace no
    TPU kernel: the JAX package left this chain to XLA's fusion), the
    all-zero codeword's forms at the two sweep cells' shapes and the coded
    forms at the coded sweep cell's.  ``awgn_quantize`` through
    ``AwgnChannel.generate_zero_int8`` (``generate_int8`` of coded bits)
    against the chain of PyTorch operations on the same seed, byte for
    byte, the generator's next draw equal, and the kernel against its
    plain version on the same noise; ``count_errors`` through
    ``count_errors_async`` (against the bits sent, over the info bits)
    against its plain version on decoded bits and on random bytes.  Each
    kernel's device time (the profiler's) beside its bound (its bytes at
    the data sheet's 3.35 TB/s and at the probed ``hbm`` bytes a second),
    its plain version's and the chain's it replaces; a graph of 16 sweep
    batches launches each kernel 16 times a replay and counts what eager
    batches count.  Returns the kernels' rows of the summary line: the
    zero forms' ``launches`` those of the main paths of phases 9 and 12
    (``main_launches``, by code: the sweep and the CLI at 4000x2000 and
    at 64800x32400), the coded forms' those of a coded sweep of the coded
    cell's traffic here, and ``launches_replay`` those of one replay of
    the last graph of each.  Then the accumulate encoders' kernel
    (``kernels/encoder.py``, ``csrc/encoder.cu``; it replaces no TPU
    kernel: the JAX package encodes with NumPy on the host) at the coded
    cell's shape: byte for byte against its plain version (the chain of
    PyTorch operations it replaced), its time beside its bound (the info
    bytes read and the codewords written) and the chain's, a launch a
    batch of the coded sweep and 16 a replay; its row's ``launches_coded``
    are those of phase 20's coded sweeps (``coded_encodes``)."""
    import torch

    from ldpcgputegra_tpu_torch.bench import sass
    from ldpcgputegra_tpu_torch.bench.roofline import TABLE_HBM_BYTES_PER_S
    from ldpcgputegra_tpu_torch.channel.awgn import AwgnChannel
    from ldpcgputegra_tpu_torch.channel.bitgen import generate_info_bits
    from ldpcgputegra_tpu_torch.channel.encoder import make_encoder
    from ldpcgputegra_tpu_torch.codes.registry import load_code
    from ldpcgputegra_tpu_torch.decoder import make_decoder
    from ldpcgputegra_tpu_torch.kernels import channel as C
    from ldpcgputegra_tpu_torch.kernels import encoder as KE
    from ldpcgputegra_tpu_torch.kernels import streamed as S
    from ldpcgputegra_tpu_torch.ops.layered import LayeredSpec
    from ldpcgputegra_tpu_torch.sim.analyzer import count_errors_async
    from ldpcgputegra_tpu_torch.sim.scan import ScanSteps

    lib = C.build()["path"]
    for kname in ("awgn_quantize", "awgn_quantize_coded"):
        ops = sass.opcodes(lib, f"{kname}_kernel")
        ffma = sum(n for o, n in ops.items() if o.startswith("FFMA"))
        print(f"[channel] {kname} SASS: {sum(ops.values())} instructions, "
              f"FFMA {ffma}")
        assert ops and ffma == 0, f"{kname} contracts a multiply and an add"
    for kname in ("count_errors", "count_errors_ref"):
        print(f"[channel] {kname} SASS: "
              f"{sum(sass.opcodes(lib, f'{kname}_kernel').values())} "
              f"instructions")

    def diff(a, b):
        return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())

    def timed(shape, kname, nbytes, kernel, plain, inputs, chain=None,
              gens=None, draw=None):
        """The kernel's row at ``shape``: its time beside its bound, its
        plain version's and, for the channel, the chain's and the draw's."""
        t_k, by_k = _device_us(kernel, inputs)
        at = {"ms": t_k / 1e3,
              "plain_ms": _device_us(plain, inputs)[0] / 1e3,
              "bound_ms": nbytes / TABLE_HBM_BYTES_PER_S * 1e3,
              "probed_bound_ms": nbytes / hbm * 1e3}
        if chain is not None:
            # the chain it replaces, the draw included, and the draw
            at["chain_ms"] = _device_us(chain, gens)[0] / 1e3
            at["draw_ms"] = _device_us(draw, gens)[0] / 1e3
        rows[kname][shape] = at
        us = {k: round(v * 1e3, 2) for k, v in at.items()}
        print(f"[channel] {kname} {shape}: {us} (us); "
              f"{at['ms'] / at['probed_bound_ms']:.3f}x the bound at the "
              f"probed {hbm / 1e9:.1f} GB/s; by name {by_k} | {smi}")

    def graphed(name, B, chan, step, forms):
        """A graph of 16 batches of ``step``: 16 launches of each of
        ``forms`` a replay (17 with the capture's eager warm-up batch),
        none of the others, and the eager batches' counts, the eager
        batches' generators ``chan``'s."""
        scan = ScanSteps(step, 16, dev)
        seeds = list(range(2800, 2816))
        before = dict(C.launches)
        out = scan(seeds)
        per = {k: C.launches[k] - before[k] for k in before}
        eager = torch.stack([step(chan.generator(s)) for s in seeds])
        assert torch.equal(out, eager), (name, out.tolist(), eager.tolist())
        assert per == {k: 17 * (k in forms) for k in before}, per
        replay = scan.replayed(C.launches)
        assert replay == {k: 16 * (k in forms) for k in before}, replay
        print(f"[channel] {name} B={B}: a graph of 16 batches: launches "
              f"{replay} a replay (the capture's warm-up batch "
              f"one more), counts equal to eager: BE, FE "
              f"{out.sum(0).tolist()}")
        return replay, scan

    forms = {"awgn_quantize": "awgn_quantize_coded",
             "count_errors": "count_errors_ref"}
    rows = {k: {} for k in (*forms, *forms.values())}  # by kernel, by shape
    err = dict.fromkeys(rows, 0)
    spec = LayeredSpec(algo="OMS", iters=10, early_term=True)
    for name, B in CHANNEL_SHAPES:
        code = load_code(name)
        chan = AwgnChannel(code.N, code.K, device=dev)
        chan.configure(2.0)
        sat = chan.spec.quant.sat
        zeros = torch.zeros((B, code.N), dtype=torch.int8, device=dev)
        for seed in (2700, 2701):
            g1, g2 = chan.generator(seed), chan.generator(seed)
            got = chan.generate_zero_int8(g1, B)
            want = _channel_chain(chan, g2, zeros)
            assert torch.equal(*[torch.randn(64, generator=g, device=dev)
                                 for g in (g1, g2)]), (name, seed)
            noise = torch.randn((B, code.N), generator=chan.generator(seed),
                                device=dev)
            err["awgn_quantize"] = max(
                err["awgn_quantize"], diff(got, want),
                diff(C.awgn_quantize(noise, 1.0, chan._scalars, sat),
                     C.awgn_quantize_plain(noise, 1.0, chan._scalars, sat)))
        dec = make_decoder(code, spec, device=dev)
        decoded = [dec(chan.generate_zero_int8(chan.generator(2710 + i),
                                               B))[0] for i in range(4)]
        rnd = [torch.randint(0, 2, (B, code.N), dtype=torch.uint8,
                             device=dev, generator=chan.generator(2720 + i))
               for i in range(2)]
        for x in decoded + rnd:
            err["count_errors"] = max(
                err["count_errors"],
                diff(torch.stack(count_errors_async(x)),
                     C.count_errors_plain(x, code.N)))
        assert not any(err.values()), (name, err)
        print(f"[channel] {name} B={B}: counts of the decoded batches "
              f"{[torch.stack(count_errors_async(x)).tolist() for x in decoded]}")
        noises = [torch.randn((B, code.N), generator=chan.generator(2730 + i),
                              device=dev) for i in range(3)]
        gens = [chan.generator(2740 + i) for i in range(3)]
        shape = f"{name} B={B}"
        # the bound: the float32 noise read and the int8 LLRs written; the
        # decoded bytes read
        timed(shape, "awgn_quantize", 5 * B * code.N,
              lambda x: C.awgn_quantize(x, 1.0, chan._scalars, sat),
              lambda x: C.awgn_quantize_plain(x, 1.0, chan._scalars, sat),
              noises, chain=lambda g: _channel_chain(chan, g, zeros),
              gens=gens, draw=lambda g: torch.randn((B, code.N), generator=g,
                                                    device=dev))
        timed(shape, "count_errors", B * code.N, count_errors_async,
              lambda x: C.count_errors_plain(x, code.N), decoded)
        replay, _ = graphed(name, B, chan, lambda g: torch.stack(
            count_errors_async(dec(chan.generate_zero_int8(g, B))[0])), forms)

    # the coded forms at the coded sweep cell's shape: the table encoder's
    # codewords of seeded info bits, the count over the info bits
    name, B, snr = CODED_SHAPE
    code = load_code(name)
    K = code.K
    chan = AwgnChannel(code.N, K, device=dev)
    chan.configure(snr)
    sat = chan.spec.quant.sat
    enc = make_encoder(code, "table")
    dec = make_decoder(code, spec, device=dev)

    def coded_of(gen):
        return enc.encode(generate_info_bits(gen, B, K))

    for seed in (2750, 2751):
        g1, g2 = chan.generator(seed), chan.generator(seed)
        bits = coded_of(g1)
        assert torch.equal(bits, coded_of(g2)), (name, seed)
        got = chan.generate_int8(g1, bits)
        want = _channel_chain(chan, g2, bits)
        assert torch.equal(*[torch.randn(64, generator=g, device=dev)
                             for g in (g1, g2)]), (name, seed)
        noise = torch.randn((B, code.N), generator=chan.generator(seed),
                            device=dev)
        err["awgn_quantize_coded"] = max(
            err["awgn_quantize_coded"], diff(got, want),
            diff(C.awgn_quantize(noise, 1.0, chan._scalars, sat, bits),
                 C.awgn_quantize_plain(noise, 1.0, chan._scalars, sat, bits)))
    sent = [coded_of(chan.generator(2760 + i)).view(torch.uint8)
            for i in range(4)]
    decoded = [dec(chan.generate_int8(chan.generator(2770 + i), x))[0]
               for i, x in enumerate(sent)]
    rnd = [torch.randint(0, 2, (B, code.N), dtype=torch.uint8, device=dev,
                         generator=chan.generator(2780 + i)) for i in range(2)]
    pairs = list(zip(decoded, sent)) + [(rnd[0], sent[0]), (rnd[1], rnd[0])]
    for x, ref in pairs:
        err["count_errors_ref"] = max(
            err["count_errors_ref"],
            diff(torch.stack(count_errors_async(x, reference=ref,
                                                info_only=True, k=K)),
                 C.count_errors_plain(x, K, ref)))
    assert not any(err.values()), (name, err)
    counts = [torch.stack(count_errors_async(x, reference=r, info_only=True,
                                             k=K)).tolist()
              for x, r in pairs[:4]]
    print(f"[channel] {name} B={B}: info-bit counts of the decoded batches "
          f"against the bits sent {counts}")
    gens = [chan.generator(2790 + i) for i in range(3)]
    noises = [(torch.randn((B, code.N), generator=g, device=dev), x)
              for g, x in zip(gens, sent)]
    shape = f"{name} B={B}"
    # the bound: the float32 noise and the coded bits read, the int8 LLRs
    # written; the decoded bits and the bits sent, over the info bits, read
    timed(shape, "awgn_quantize_coded", 6 * B * code.N,
          lambda x: C.awgn_quantize(x[0], 1.0, chan._scalars, sat, x[1]),
          lambda x: C.awgn_quantize_plain(x[0], 1.0, chan._scalars, sat, x[1]),
          noises, chain=lambda g: _channel_chain(chan, g, sent[0]),
          gens=gens, draw=lambda g: torch.randn((B, code.N), generator=g,
                                                device=dev))
    timed(shape, "count_errors_ref", 2 * B * K,
          lambda x: count_errors_async(x[0], reference=x[1], info_only=True,
                                       k=K),
          lambda x: C.count_errors_plain(x[0], K, x[1]), pairs[:4])

    def coded_step(g):
        bits = coded_of(g)
        decoded, _ = dec(chan.generate_int8(g, bits))
        return torch.stack(count_errors_async(
            decoded, reference=bits.view(torch.uint8), info_only=True, k=K))

    coded_replay, scan = graphed(name, B, chan, coded_step, forms.values())
    enc_replay = scan.replayed(KE.launches)
    assert enc_replay == {"accumulate_encode": 16}, enc_replay

    # the encoder's kernel: its plain version is the chain it replaced
    row_ptr, cols = enc._on(dev, enc._row_ptr, enc._cols)
    infos = [generate_info_bits(chan.generator(2850 + i), B, K)
             for i in range(3)]
    err["accumulate_encode"] = max(
        diff(KE.accumulate_encode(u, row_ptr, cols, code.N),
             KE.accumulate_plain(u, row_ptr, cols, code.N)) for u in infos)
    assert not err["accumulate_encode"], err
    t_k, by_k = _device_us(
        lambda u: KE.accumulate_encode(u, row_ptr, cols, code.N), infos)
    t_p, by_p = _device_us(
        lambda u: KE.accumulate_plain(u, row_ptr, cols, code.N), infos)
    nbytes = B * (K + code.N)  # the info bytes read, the codewords written
    enc_at = {"ms": t_k / 1e3, "plain_ms": t_p / 1e3,
              "bound_ms": nbytes / TABLE_HBM_BYTES_PER_S * 1e3,
              "probed_bound_ms": nbytes / hbm * 1e3}
    print(f"[encoder] accumulate_encode {name} B={B}: "
          f"{ {k: round(v * 1e3, 2) for k, v in enc_at.items()} } (us); "
          f"{enc_at['ms'] / enc_at['bound_ms']:.2f}x the bound at the data "
          f"sheet's rate; the chain {enc_at['plain_ms'] / enc_at['ms']:.1f}x "
          f"the kernel; by name {by_k} | {smi}")
    print(f"[encoder] the chain by name: "
          f"{ {k: round(v, 2) for k, v in by_p.items()} } (us)")

    # the main path of the coded cell's traffic: run_sweep with the table
    # encoder, 16 batches a graph replay; one launch of each coded form and
    # of the encoder's kernel a K2 launch, and none of the zero forms
    for k in C.launches:
        C.launches[k] = 0
    S.launches["streamed_minsum"] = 0
    KE.launches["accumulate_encode"] = 0
    (p,), _, _ = _timed_sweep(_sweep_cfg(
        code=name, batch=B, snr_min=snr, snr_max=snr, encoder="table",
        count_bits="info", scan_steps=16, pipeline_depth=2,
        max_frames=64 * B))
    torch.cuda.synchronize()
    coded_launches = dict(C.launches)
    k2 = S.launches["streamed_minsum"]
    print(f"[channel] {name} B={B} coded sweep at {snr} dB: {p.frames} "
          f"frames, FE={p.fe} BER={p.ber:.4e}, launches {coded_launches}, "
          f"streamed_minsum {k2}, {p.mbps:.1f} coded Mbit/s | {smi}")
    assert k2 > 0 and coded_launches == {
        k: k2 * (k in forms.values()) for k in coded_launches}, coded_launches
    encoded = KE.launches["accumulate_encode"]
    assert encoded == k2, (encoded, k2)
    print(f"[encoder] {name} B={B} coded sweep: accumulate_encode {encoded} "
          f"launches, one a batch")
    main_launches = {**{k: {c: n[k] for c, n in main_launches.items()}
                        for k in forms},
                     **{k: {name: coded_launches[k]} for k in forms.values()}}
    kernels = []
    for kname, at in rows.items():
        first = next(iter(at.values()))
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "ldpcgputegra_tpu_torch/csrc/channel_count.cu",
            "replaces": C.REPLACES,
            "launches": sum(main_launches[kname].values()),
            "launches_by_code": main_launches[kname],
            "launches_replay": (replay if kname in forms
                                else coded_replay)[kname],
            "max_abs_err": err[kname], "ms": first["ms"],
            "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"],
            "bound_by": "bytes", "probed_bound_ms": first["probed_bound_ms"],
            "library_ms": None, "at": at,
        })
    kernels.append({
        "name": "accumulate_encode", "route": "cuda",
        "source": "ldpcgputegra_tpu_torch/csrc/encoder.cu",
        "replaces": KE.REPLACES, "launches": encoded,
        "launches_by_code": {name: encoded},
        "launches_coded": coded_encodes,
        "launches_replay": enc_replay["accumulate_encode"],
        "max_abs_err": err["accumulate_encode"], **enc_at,
        "bound_by": "bytes", "library_ms": None,
        "at": {f"{name} B={B}": enc_at},
    })
    return kernels


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import numpy as np

    from ldpcgputegra_tpu_torch.bench import profile_1944 as P
    from ldpcgputegra_tpu_torch.bench import sass, suite, tiles
    from ldpcgputegra_tpu_torch.bench import vpu_probe as V
    from ldpcgputegra_tpu_torch.bench.roofline import hw_spec, roofline_report
    from ldpcgputegra_tpu_torch.codes.registry import load_code
    from ldpcgputegra_tpu_torch.decoder import backend_for, effective_code
    from ldpcgputegra_tpu_torch.kernels import _lib
    from ldpcgputegra_tpu_torch.kernels import channel as C
    from ldpcgputegra_tpu_torch.kernels import encoder as KE
    from ldpcgputegra_tpu_torch.kernels import gather as G
    from ldpcgputegra_tpu_torch.kernels import layered as K
    from ldpcgputegra_tpu_torch.kernels import streamed as S
    from ldpcgputegra_tpu_torch.ops.layered import LayeredSpec, make_layered_decoder

    assert "jax" not in sys.modules, "the port must not import jax"
    dev = torch.device("cuda", 0)
    t_phase = [time.perf_counter()]

    def phase_done(n):
        now = time.perf_counter()
        print(f"[phase {n}] {now - t_phase[0]:.1f} s", flush=True)
        t_phase[0] = now

    # 1. device
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    hw = hw_spec(dev)  # SM count, max SM clock, the data sheet's rates
    sm_count = hw.sm_count
    print(f"[device] {kind} | count {torch.cuda.device_count()} | "
          f"torch {torch.__version__} cuda {torch.version.cuda} | "
          f"{sm_count} SMs, max SM clock {hw.clock_hz / 1e6:.0f} MHz")
    print(f"[device] nvidia-smi: {smi}")
    phase_done(1)

    # 2. build: one nvcc per probe source and per decode kernel and
    # (algorithm, minclamp) pair, all started together
    decode_kernels = {"layered_minsum": K, "gather_minsum": G,
                      "streamed_minsum": S}
    with ThreadPoolExecutor(4 + 3 * len(_lib.PAIRS)) as pool:
        builds = {**{f"{name} {a}/{m}": pool.submit(mod.build, a, m)
                     for name, mod in decode_kernels.items()
                     for a, m in _lib.PAIRS},
                  "probes": pool.submit(V.build),
                  "roll_probe": pool.submit(P.build),
                  "channel_count": pool.submit(C.build),
                  "encoder": pool.submit(KE.build)}
        builds = {name: f.result() for name, f in builds.items()}
    for name, info in builds.items():
        print(f"[build] {name}: {os.path.relpath(info['path'], HERE)} in "
              f"{info['seconds']:.2f} s")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"[build] {line.strip()}")
    for kind_, chains in ([("mix", c) for c in V.MIX_CHAINS]
                          + [("mix4", c) for c in V.MIX_CHAINS]
                          + [("peak", c) for c in V.PEAK_CHAINS]):
        per_rep = V.PEAK_OPS_PER_REP if kind_ == "peak" else V.OPS_PER_REP
        chain = (f"; {V.sass_per_chain_rep(kind_, chains)} ALU instructions a "
                 "chain without the loop control" if chains > 1 else "")
        print(f"[sass] probe_{kind_} x{chains}: (all, integer ALU pipe) "
              f"instructions a repetition {V.sass_per_rep(kind_, chains)}; "
              f"algorithmic operations {per_rep} x {chains}{chain}")
    # the decode kernels' variants on the main paths: SASS per edge
    # update, registers, stack (spills) and local memory
    decode_sass = sass.report(HERE)
    for (kname, what), (_, _, res) in decode_sass.items():
        # the QC kernel's contributions stay in registers: no stack frame
        assert kname != "layered_minsum" or res.get("STACK") == 0, (what, res)
    assert {k for k, _ in decode_sass} == {"layered_minsum", "gather_minsum",
                                          "streamed_minsum"}, decode_sass
    phase_done(2)

    # 3. kernel vs the committed golden vectors (fixed iterations)
    vecs = sorted(p for p in glob.glob(os.path.join(HERE, "tests", "vectors",
                                                    "*.npz"))
                  if not os.path.basename(p).startswith("refcheck_"))
    assert vecs, "no golden vectors found"
    for path in vecs:
        d = np.load(path)
        code = load_code(str(d["code"]))
        spec = LayeredSpec(algo=str(d["algo"]), iters=int(d["iters"]),
                           minclamp=str(d["minclamp"]), offset=int(d["offset"]))
        bits, _ = K.make_cuda_decoder(code, spec)(
            torch.from_numpy(d["llr"]).to(dev))
        got = bits.cpu().numpy()
        assert np.array_equal(got, d["bits"].astype(np.uint8)), path
        print(f"[vectors] {os.path.basename(path)}: {got.shape[0]} frames "
              "bit-exact")
    phase_done(3)

    # 4. kernel vs the plain version on the card: bits and iters_used
    max_err = _hold(K.make_cuda_decoder, "vs-plain", [
        ("2304x1152", 8192, "OMS", "pre", False, 2.0),
        ("2304x1152", 8192, "OMS", "pre", True, 2.0),
        ("1944x972", 8192, "OMS", "pre", False, 2.0),
        ("1944x972", 8192, "OMS", "pre", True, 2.0),
        ("1944x972", 1024, "OMS", "pre", True, 5.0),
        ("1944x972", 1000, "OMS", "pre", True, 2.0),
        ("2304x1152", 1000, "OMS", "pre", False, 2.0),
        ("1944x972", 1024, "MS", "post", True, 2.0),
        ("1944x972", 1024, "NMS", "post", True, 2.0),
        ("2304x1152", 1024, "2NMS", "post", True, 2.0),
    ], dev, pick=lambda c, B: f"tile {K.pick_tile(c, B, sm_count)}")
    # every build of the kernel, each forced through its pick
    max_err = max(max_err, tiles.check("layered", dev))
    phase_done(4)

    # 5. throughput at the bench configuration and at the sweep's batch
    k_times = {}
    for name, B in (("2304x1152", 8192), ("1944x972", 1024)):
        code = load_code(name)
        spec = LayeredSpec(algo="OMS", iters=10)
        print(f"[throughput] {name} B={B}: tile "
              f"{K.pick_tile(code, B, sm_count)}")
        k_times[name] = _throughput(K.make_cuda_decoder(code, spec),
                                    make_layered_decoder(code, spec, dev),
                                    name, B, smi, dev, seed0=200)
    t_k, t_p = k_times["2304x1152"]
    phase_done(5)

    # 6. the QC path: sweep + CLI at 1944x972, counted launches
    n_launch, _ = _main_path("1944x972", 1024, (1.5, 2.5), 2.0, 64 * 1024,
                             dev, K.launches, "layered_minsum")
    phase_done(6)

    # 7. gather kernel vs the plain version on the card: bits and iters_used
    # at all 8 (algorithm, minclamp) pairs, through the pick
    g_err = _hold(G.make_gather_decoder, "gather-vs-plain", [
        ("4000x2000", 4096, "OMS", "pre", False, 2.0),
        ("4000x2000", 4096, "OMS", "pre", True, 2.5),
        ("8000x4000", 2048, "OMS", "pre", True, 2.5),
        ("9972x4986", 2048, "OMS", "pre", False, 2.0),
        ("20000x10000", 1024, "OMS", "pre", True, 2.5),
        ("2048x384", 1024, "OMS", "pre", True, 4.0),
        ("1024x518", 1000, "OMS", "pre", True, 4.0),
        ("4000x2000", 1024, "MS", "post", True, 2.5),
        ("4000x2000", 1024, "NMS", "post", True, 2.5),
        ("4000x2000", 1024, "2NMS", "post", True, 2.5),
        ("4000x2000", 384, "OMS", "post", True, 2.5),
        ("4000x2000", 1000, "MS", "pre", True, 2.5),
        ("4000x2000", 383, "NMS", "pre", True, 2.5),
        ("1200x600", 1001, "2NMS", "pre", True, 3.5),
        ("200x100", 1024, "OMS", "pre", True, 4.0, "reference"),
    ], dev, seed0=300, pick=lambda c, B: G.pick_tile(c, B, sm_count))
    # every build of the kernel, each forced through its pick: every tile,
    # 2 and 4 lanes a check
    g_err = max(g_err, tiles.check("gather", dev))
    phase_done(7)

    # 8. gather throughput at the suite's batches, and at 4000x2000 at the
    # batches of two-phase early termination's phase 2
    g_shapes = (("4000x2000", 4096), ("4000x2000", 1024), ("4000x2000", 384),
                ("8000x4000", 2048), ("20000x10000", 1024))
    g_times = {}
    for name, B in g_shapes:
        code = load_code(name)
        spec = LayeredSpec(algo="OMS", iters=10)
        print(f"[throughput] {name} B={B}: "
              f"{G.pick_tile(code, B, sm_count)}")
        g_times[name, B] = _throughput(
            G.make_gather_decoder(code, spec),
            make_layered_decoder(code, spec, dev), name, B, smi, dev,
            seed0=400)
    phase_done(8)

    # 9. the gather path: sweep + CLI at 4000x2000, counted launches
    # the channel's and the count's launches in the two sweep cells' codes'
    # main paths, by code (phase 27's rows)
    c_launches = {}
    g_launch, c_launches["4000x2000"] = _main_path(
        "4000x2000", 4096, (1.5, 2.0), 2.0, 16 * 4096, dev, G.launches,
        "gather_minsum")
    phase_done(9)

    # 10. streamed kernel vs the plain version on the card, on the QC views
    # of all 7 staircase codes and on synthqc: bits and iters_used
    s_err = _hold(S.make_streamed_decoder, "streamed-vs-plain", [
        ("64800x32400", 512, "OMS", "pre", False, 1.5),
        ("64800x32400", 512, "OMS", "pre", True, 3.0),
        ("64800x32400-dvbs2", 256, "OMS", "pre", True, 2.5),
        ("64800x21600", 256, "OMS", "pre", True, 4.0),
        ("64800x6480-dvbs2", 256, "OMS", "pre", True, 7.0),
        ("64800x7200-dvbs2", 256, "OMS", "pre", True, 6.0),
        ("16200x7560", 1024, "MS", "post", True, 3.5),
        ("16200x7560", 1024, "NMS", "post", True, 5.0),
        ("16200x7560", 1024, "2NMS", "post", True, 5.0),
        ("16200x10800", 512, "OMS", "pre", True, 5.0),
        ("synthqc-256x128x6-z1024", 256, "OMS", "pre", True, 4.0),
        ("16200x7560", 500, "OMS", "pre", True, 5.0),
        ("16200x10800", 512, "OMS", "pre", True, 5.0, "reference"),
    ], dev, seed0=500, pick=lambda c, B: S.pick_tile(c, B, sm_count))
    # every build of the kernel, each forced through its pick: both APP
    # placements, every tile, 1, 2 and 4 lanes a check
    s_err = max(s_err, tiles.check("streamed", dev))
    phase_done(10)

    # 11. streamed throughput at the suite's batches
    s_times = {}
    for name, B in (("64800x32400", 512), ("16200x7560", 1024),
                    ("64800x6480-dvbs2", 256),
                    ("synthqc-256x128x6-z1024", 256)):
        code = effective_code(load_code(name))
        spec = LayeredSpec(algo="OMS", iters=10)
        print(f"[throughput] {name} B={B}: "
              f"{S.pick_tile(code, B, sm_count)}")
        s_times[name] = _throughput(
            S.make_streamed_decoder(code, spec),
            make_layered_decoder(code, spec, dev), name, B, smi, dev,
            seed0=600)
    phase_done(11)

    # 12. the DVB-S2 path: sweep + CLI at 64800x32400, counted launches
    s_launch, c_launches["64800x32400"] = _main_path(
        "64800x32400", 512, (1.5, 2.0), 2.0, 16 * 512, dev, S.launches,
        "streamed_minsum")
    phase_done(12)

    # 13. each probe kernel against its plain version on the card (exact),
    # and its time beside the plain version's and its bound
    p_err = _hold_probes(dev, sm_count)
    p_times = _time_probes(dev, sm_count, hw, smi)
    phase_done(13)

    # 14. the benchmark-suite path: the card's ceilings (the K6 and K7
    # probes), then every suite row and latency row through a kernel
    # backend, each share against the probed ceilings; counted launches
    out_dir = os.path.join(HERE, "bench_results", "smoke")
    os.makedirs(out_dir, exist_ok=True)
    suite_out = os.path.join(out_dir, "SUITE.md")
    for key in V.launches:
        V.launches[key] = 0
    rc = suite.main(["--quick", "--fresh", "--out", suite_out])
    torch.cuda.synchronize()
    p_launch = dict(V.launches)
    print(f"[suite] exit {rc}; probe launches: {p_launch}")
    assert rc == 0, "the suite failed"
    with open(suite.ckpt_path(suite_out)) as f:
        ck = json.load(f)
    rates, srows, lrows = ck["rates"], ck["rows"], ck["lat_rows"]
    n_rows = sum(len(e[3]) if len(e) > 3 else 2 for e in suite.CONFIGS)
    assert len(srows) == n_rows == 40 and len(lrows) == 4, (len(srows),
                                                           len(lrows))
    for r in srows + lrows:
        assert r["backend"] in suite.KERNEL_BACKENDS, r
    for r in srows:
        assert r["ceiling"] == "probed", r
        assert math.isfinite(r["roofline_frac"]) and r["roofline_frac"] > 0, r
        assert r["roofline_frac_mix"] >= r["roofline_frac"], r
    assert all(n > 0 for n in p_launch.values()), p_launch
    print(f"[ceilings] int32: probed {rates['alu'] / 1e12:.4f} Tops/s (the "
          f"best probe), {rates['alu_mix'] / 1e12:.4f} on the decoder's mix; "
          f"data sheet {hw.alu_rate / 1e12:.4f} ({rates['alu'] / hw.alu_rate:.1%}"
          f", {rates['alu_mix'] / hw.alu_rate:.1%}); integer-ALU instructions "
          f"{rates['alu_instructions'] / 1e12:.4f} T/s "
          f"({rates['alu_instructions'] / hw.alu_rate:.1%}) | {smi}")
    print(f"[ceilings] int8x4 mix: probed {rates['alu_int8x4'] / 1e12:.4f} "
          f"Tops/s ({rates['alu_int8x4'] / rates['alu_mix']:.2f}x the int32 "
          f"mix, {rates['alu_int8x4'] / rates['alu']:.2f}x the best probe) "
          f"| {smi}")
    print(f"[ceilings] device memory: probed {rates['hbm'] / 1e9:.1f} GB/s, "
          f"data sheet {hw.hbm_bw / 1e9:.1f} ({rates['hbm'] / hw.hbm_bw:.1%}) "
          f"| {smi}")
    print(f"[ceilings] seen while probing: {rates['seen']} | {smi}")
    phase_done(14)

    # 15. the odd-Z profile: the K8 roll table and the seven decode rows;
    # counted launches
    P.launches["probe_roll"] = 0
    rc = P.main(["--out", os.path.join(out_dir, "PROFILE_1944.md")])
    torch.cuda.synchronize()
    r_launch = P.launches["probe_roll"]
    print(f"[profile] exit {rc}; probe_roll launches: {r_launch}")
    assert rc == 0 and r_launch > 0, "the profile failed"
    phase_done(15)

    # 16. the two-phase path: K1's mask against the plain version, its
    # cost, and the two-phase decoder with counted launches
    mask_err = _hold_mask(dev, sm_count)
    tp_launch, t_mask, t_mask_off = _twophase_path(dev, smi, rates["alu"])
    phase_done(16)

    # 17. the bound of every timed decode (``bench/roofline.py``): against
    # the data sheet's rates and against the probed ones
    bounds = {}
    timed = ([("layered_minsum", n, B, k_times[n]) for n, B in
              (("2304x1152", 8192), ("1944x972", 1024))]
             + [("gather_minsum", n, B, g_times[n, B]) for n, B in g_shapes]
             + [("streamed_minsum", n, B, s_times[n]) for n, B in
                (("64800x32400", 512), ("16200x7560", 1024),
                 ("64800x6480-dvbs2", 256), ("synthqc-256x128x6-z1024", 256))])
    spec10 = LayeredSpec(algo="OMS", iters=10)
    for kname, name, B, (t, _) in timed:
        code = load_code(name)
        tab = roofline_report(code, spec10, B, t, hw=hw)
        prb, mix = (roofline_report(code, spec10, B, t, alu, rates["hbm"],
                                    hw=hw)
                    for alu in (rates["alu"], rates["alu_mix"]))
        bounds[name, B] = (tab["t_roofline_ms"], tab["bound"],
                           prb["t_roofline_ms"], mix["t_roofline_ms"])
        print(f"[bound] {name} B={B} 10 it: {tab['edge_updates']:.4e} edge "
              f"updates x {tab['ops_per_edge']} ops; LLRs + bits "
              f"{tab['bytes'] / 1e6:.1f} MB = {tab['t_bytes_ms']:.4f} ms; "
              f"notes: message traffic {tab['msg_bytes'] / 1e9:.2f} GB "
              f"({tab['t_msg_ms']:.4f} ms at the data sheet's device memory "
              f"rate); int8x4, four codewords an operation: "
              f"{tab['t_ops_ms'] / 4:.4f} ms at four times the data sheet's "
              f"int32 rate, {tab['ops'] / rates['alu_int8x4'] * 1e3:.4f} ms at "
              f"the probed int8x4 rate")
        # the issue floor of the kernel's own SASS: edge updates x its ALU
        # instructions an edge over the probed ALU-instruction rate
        pair = _lib.pair(spec10)
        if kname == "layered_minsum":
            sym = sass.layered_symbol(code, K.pick_tile(code, B, sm_count),
                                      *pair)
        elif kname == "streamed_minsum":
            sym = sass.streamed_symbol(effective_code(code),
                                       S.pick_tile(effective_code(code), B,
                                                   sm_count), *pair)
        else:
            sym = sass.gather_symbol(code, G.pick_tile(code, B, sm_count),
                                     *pair)
        lib = decode_kernels[kname].build(*pair)["path"]
        alu_edge = sass.per_edge(lib, *sym)[1]
        t_issue = tab["edge_updates"] * alu_edge / rates["alu_instructions"]
        print(f"[issue] {kname} {name} B={B}: {alu_edge:.2f} ALU instructions "
              f"an edge update in its SASS ({sym[0]}); at the probed "
              f"{rates['alu_instructions'] / 1e12:.4f} T ALU instructions/s "
              f"that is {t_issue * 1e3:.4f} ms, the kernel {t * 1e3:.4f} ms "
              f"({t_issue / t:.1%}) | {smi}")
        print(f"[roofline] {kname} {name} B={B}: {t * 1e3:.4f} ms against a "
              f"bound of {tab['t_roofline_ms']:.4f} ms ({tab['bound']}, data "
              f"sheet), {tab['roofline_frac']:.1%} of it; "
              f"{prb['t_roofline_ms']:.4f} ms ({prb['bound']}, probed), "
              f"{prb['roofline_frac']:.1%} of it; {mix['t_roofline_ms']:.4f} ms "
              f"at the mix's probed rate, {mix['roofline_frac']:.1%} of it "
              f"| {smi}")
    phase_done(17)

    # 18. the graphed sweep: scan_steps 1 and 8 through K1, counted over
    # the graph's replays
    scan_launch, scan_rates = _scan_path(dev, smi)
    phase_done(18)

    # 19. the coded sweep on three codes, each through its kernel
    coded_launch = _coded_paths(dev, smi)
    phase_done(19)

    # 20. flooding (plain PyTorch on the card) and DecodeStream over K1
    t_flood, t_flood_g = _flooding_path(dev, smi)
    stream_launch = _stream_path(dev)
    phase_done(20)

    # 21. the multi-device path: gloo ranks sharing the card, one NCCL rank
    multi_launch = _multi_device(dev, smi)
    phase_done(21)

    # 22. the native host library, backend='native' and the hybrid split
    native_launch = _native_path(dev, smi, k_times["1944x972"][0])
    phase_done(22)

    # 23. the plain decoder's node-major option on the card
    _node_major_path(dev)
    phase_done(23)

    # 24. the BER spot check: four points of the book against the JAX book
    ber_launch = _ber_spots(dev, smi)
    phase_done(24)

    # 25. the ported JAX tools: K1 against K2, the skip diagnosis, the golden
    # vectors and the derived 16200x10800 matrix
    tools_launch = _tools(dev, out_dir)
    phase_done(25)

    # 26. the system's two root entry points: the headline line in a
    # process of its own, and entry()'s flagship step against the plain
    # decoder
    _, headline_launch = _headline(t_k, smi)
    entry_launch = _entry(dev)
    phase_done(26)

    # 27. the channel's and the count's kernels, the zero forms at the two
    # sweep cells' shapes and the coded forms at the coded cell's: against
    # the chain of PyTorch operations, their time beside their bound and
    # the chain's, 16 launches of each a graph replay; the same for the
    # accumulate encoders' kernel at the coded cell's shape
    channel_rows = _channel_count(dev, rates["hbm"], smi, c_launches,
                                  coded_launch["accumulate_encode"])
    phase_done(27)

    # 28. the two-phase sweep, graphed, against the eager two-phase
    # decoder, with and without repairs
    tps_launch = _twophase_sweep(dev, smi)
    phase_done(28)

    # "route" is how the kernel is written (CUDA C++); "backend" is the
    # decoder backend that ``auto`` resolves to on the path it was driven
    # on; no one PyTorch call computes a layered min-sum decode, so its
    # "library_ms" is null.  "bound_ms" is at the data sheet's rates,
    # "probed_bound_ms" at the best probed ones, "probed_mix_bound_ms" at
    # the probed rate of the decoder's own mix.
    spec = LayeredSpec(algo="OMS", iters=10, early_term=True)
    rows = [
        ("layered_minsum", "1944x972", K, n_launch, max_err,
         ("2304x1152", 8192), (t_k, t_p)),
        ("gather_minsum", "4000x2000", G, g_launch, g_err, ("4000x2000", 4096),
         g_times["4000x2000", 4096]),
        ("streamed_minsum", "64800x32400", S, s_launch, s_err,
         ("64800x32400", 512), s_times["64800x32400"]),
    ]
    kernels = []
    for name, path_code, mod, launches, err, timed, (t, t_plain) in rows:
        # K1's row: its launches on the two-phase path, its largest
        # disagreement over bits, iters_used and ok, and its time at k1=5
        # with and without the mask
        mask = ({"launches_twophase": tp_launch,
                 "launches_twophase_sweep": tps_launch,
                 "mask_ms": t_mask * 1e3,
                 "mask_off_ms": t_mask_off * 1e3,
                 "launches_scan": scan_launch,
                 "launches_stream": stream_launch,
                 "launches_multi": multi_launch,
                 "launches_native": native_launch,
                 "launches_headline": headline_launch,
                 "launches_entry": entry_launch}
                if name == "layered_minsum" else
                {"launches_coded": coded_launch[name]})
        mask["launches_ber"] = ber_launch[name]
        mask["launches_tools"] = tools_launch[name]
        if name == "layered_minsum":
            err = max(err, mask_err)
        kernels.append({
            "name": name,
            "route": "cuda",
            "backend": backend_for(load_code(path_code), spec, dev),
            "source": f"ldpcgputegra_tpu_torch/csrc/{name}.cu",
            "replaces": mod.REPLACES,
            "launches": launches,
            "max_abs_err": err,
            "ms": t * 1e3,
            "plain_ms": t_plain * 1e3,
            "bound_ms": bounds[timed][0],
            "bound_by": bounds[timed][1],
            "probed_bound_ms": bounds[timed][2],
            "probed_mix_bound_ms": bounds[timed][3],
            "library_ms": None,
            **mask,
        })
    probe_rows = [(n, "probes.cu", V.REPLACES[n], p_launch[n])
                  for n in ("probe_mix", "probe_peak", "probe_copy")]
    probe_rows.append(("probe_roll", "roll_probe.cu", P.REPLACES, r_launch))
    # the roll's bound is its shared-memory bytes: "bytes", and "bytes_of"
    # says which
    for name, src, replaces, launches in probe_rows:
        ms, plain_ms, library_ms, b_ms, b_by = p_times[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"ldpcgputegra_tpu_torch/csrc/{src}",
            "replaces": replaces,
            "launches": launches,
            "max_abs_err": p_err[name],
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": b_ms,
            "bound_by": "operations" if b_by == "operations" else "bytes",
            **({"bytes_of": b_by} if b_by == "shared memory" else {}),
            "library_ms": library_ms,
        })
    kernels += channel_rows
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

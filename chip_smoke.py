#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``ldpcgputegra_tpu_torch/csrc/``
(one nvcc per source, all at once): the QC kernel (``layered_minsum``), the
gather kernel for non-QC codes (``gather_minsum``) and the streamed kernel
for the DVB-S2 QC views and synthqc (``streamed_minsum``).  Holds the QC
kernel against the committed golden vectors, and each kernel against the
plain PyTorch decoder on the card; times both; then drives each kernel's
path (``run_sweep`` and the CLI, at 1944x972, 4000x2000 and 64800x32400)
and checks that it went through the kernel.  Imports nothing of JAX.
Exits non-zero, before printing any result, when there is no CUDA device
or the package is not beside this script; any failing phase exits
non-zero.  The last line of standard output is ``{"ok": true, "device":
{...}}``; the line before it lists each kernel with its launches on its
path, its largest disagreement with the plain version, its time, the
plain version's and its bound (the least time the card could take).
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


HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA's data sheet)
INT32_LANES_PER_SM = 64  # int32 issue rate: SMs x 64 lanes x max SM clock


def _llrs(N: int, B: int, snr_db: float, seed: int, rate: float = 0.5):
    """int8 LLRs of the all-zero codeword at Eb/N0 ``snr_db`` for a code of
    ``rate``, from a numpy seed: clamp(8*y, +-31) truncated toward zero."""
    import numpy as np

    sigma = math.sqrt(10 ** (-0.1 * (snr_db + 10 * math.log10(rate))) / 2)
    rng = np.random.default_rng(seed)
    y = (-1.0 + sigma * rng.standard_normal((B, N))).astype(np.float32)
    return np.clip(8.0 * y, -31, 31).astype(np.int8)


def _hold(make_kernel_decoder, tag, cases, dev, seed0=100) -> int:
    """Decode each case with the kernel and with the plain version on the
    card; both must give the same bits and ``iters_used``.  A case is
    (code, B, algo, minclamp, early_term, Eb/N0 dB[, schedule]); a staircase
    code decodes through its QC view, as ``make_decoder`` does.  Returns the
    largest |bit difference| (0); fails unless early termination ended
    some decode early."""
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
        print(f"[{tag}] {name} B={B} {algo}/{mc} ET={et} {schedule} {snr} dB: "
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


def _bound(name, B, iters, sm_count, clock_hz):
    """The least time the card could take for one decode of B codewords at
    ``iters`` iterations, ET off: the larger of the operations (edge updates
    x the integer operations one min-sum edge update needs,
    ``kernels/_lib.py::OPS_PER_EDGE``, over the int32 issue rate) and the
    bytes (the LLRs read once and the bits written once, over the device
    memory rate).  Returns (ms, "operations" | "bytes")."""
    from ldpcgputegra_tpu_torch.codes.code import committed_edges
    from ldpcgputegra_tpu_torch.codes.registry import load_code
    from ldpcgputegra_tpu_torch.decoder import effective_code
    from ldpcgputegra_tpu_torch.kernels._lib import OPS_PER_EDGE

    code = effective_code(load_code(name))
    edges = 0  # real edges: a deficient circulant's pinned one is no work
    for lay in code.layers:
        idx, pinned = committed_edges(lay)
        edges += idx.size - (0 if pinned is None else int(pinned.sum()))
    updates = edges * B * iters
    ops_s = updates * OPS_PER_EDGE / (sm_count * INT32_LANES_PER_SM * clock_hz)
    bytes_s = 2 * B * code.N / HBM_BYTES_PER_S
    print(f"[bound] {name} B={B} {iters} it: {updates:.4e} edge updates x "
          f"{OPS_PER_EDGE} ops = {ops_s * 1e3:.4f} ms; LLRs + bits "
          f"{2 * B * code.N / 1e6:.1f} MB = {bytes_s * 1e3:.4f} ms; notes: "
          f"message traffic {2 * updates / 1e9:.2f} GB "
          f"({2 * updates / HBM_BYTES_PER_S * 1e3:.4f} ms at the device "
          f"memory rate); int8x4 SIMD, four codewords an operation if each "
          f"were one instruction: {ops_s / 4 * 1e3:.4f} ms")
    if ops_s >= bytes_s:
        return ops_s * 1e3, "operations"
    return bytes_s * 1e3, "bytes"


def _main_path(code_name, batch, snr, cli_snr, max_frames, dev, counter, key):
    """``run_sweep`` at two SNR points and the CLI at one, on the card;
    returns the kernel launches they made.  FER must fall with SNR and the
    decoded BER must be below the raw channel BER."""
    import torch

    from ldpcgputegra_tpu_torch.channel.awgn import AwgnChannel
    from ldpcgputegra_tpu_torch.codes.registry import load_code
    from ldpcgputegra_tpu_torch.sim import cli
    from ldpcgputegra_tpu_torch.sim.sweep import SweepConfig, run_sweep

    code = load_code(code_name)
    counter[key] = 0
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
    print(f"[main-path] {code_name}: {key} launches: {n_launch}")
    assert n_launch > 0, "the main path did not run the kernel"
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
    return n_launch


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import numpy as np

    from ldpcgputegra_tpu_torch.codes.registry import load_code
    from ldpcgputegra_tpu_torch.decoder import backend_for, effective_code
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
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0])
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"[device] {kind} | count {torch.cuda.device_count()} | "
          f"torch {torch.__version__} cuda {torch.version.cuda} | "
          f"{sm_count} SMs, max SM clock {clock_mhz:.0f} MHz")
    print(f"[device] nvidia-smi: {smi}")
    phase_done(1)

    # 2. build: one nvcc per source, all started together
    with ThreadPoolExecutor(3) as pool:
        builds = {"layered_minsum": pool.submit(K.build),
                  "gather_minsum": pool.submit(G.build),
                  "streamed_minsum": pool.submit(S.build)}
        builds = {name: f.result() for name, f in builds.items()}
    for name, info in builds.items():
        print(f"[build] {name}: {os.path.relpath(info['path'], HERE)} in "
              f"{info['seconds']:.2f} s")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"[build] {line.strip()}")
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
    ], dev)
    phase_done(4)

    # 5. throughput at the bench configuration
    code = load_code("2304x1152")
    spec = LayeredSpec(algo="OMS", iters=10)
    t_k, t_p = _throughput(K.make_cuda_decoder(code, spec),
                           make_layered_decoder(code, spec, dev),
                           "2304x1152", 8192, smi, dev, seed0=200)
    phase_done(5)

    # 6. the QC path: sweep + CLI at 1944x972, counted launches
    n_launch = _main_path("1944x972", 1024, (1.5, 2.5), 2.0, 64 * 1024, dev,
                          K.launches, "layered_minsum")
    phase_done(6)

    # 7. gather kernel vs the plain version on the card: bits and iters_used
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
        ("200x100", 1024, "OMS", "pre", True, 4.0, "reference"),
    ], dev, seed0=300)
    phase_done(7)

    # 8. gather throughput at the suite's batches
    g_times = {}
    for name, B in (("4000x2000", 4096), ("8000x4000", 2048),
                    ("20000x10000", 1024)):
        code = load_code(name)
        spec = LayeredSpec(algo="OMS", iters=10)
        g_times[name] = _throughput(
            G.make_gather_decoder(code, spec),
            make_layered_decoder(code, spec, dev), name, B, smi, dev,
            seed0=400)
    phase_done(8)

    # 9. the gather path: sweep + CLI at 4000x2000, counted launches
    g_launch = _main_path("4000x2000", 4096, (1.5, 2.0), 2.0, 16 * 4096, dev,
                          G.launches, "gather_minsum")
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
    ], dev, seed0=500)
    phase_done(10)

    # 11. streamed throughput at the suite's batches
    s_times = {}
    for name, B in (("64800x32400", 512), ("16200x7560", 1024),
                    ("64800x6480-dvbs2", 256),
                    ("synthqc-256x128x6-z1024", 256)):
        code = effective_code(load_code(name))
        spec = LayeredSpec(algo="OMS", iters=10)
        print(f"[throughput] {name} B={B}: tile "
              f"{S.pick_tile(code, B, sm_count)}")
        s_times[name] = _throughput(
            S.make_streamed_decoder(code, spec),
            make_layered_decoder(code, spec, dev), name, B, smi, dev,
            seed0=600)
    phase_done(11)

    # 12. the DVB-S2 path: sweep + CLI at 64800x32400, counted launches
    s_launch = _main_path("64800x32400", 512, (1.5, 2.0), 2.0, 16 * 512, dev,
                          S.launches, "streamed_minsum")
    phase_done(12)

    # the bound of every timed decode: the least time the card could take
    # (``_bound``), and the kernel's share of it
    bounds = {}
    timed = ([("layered_minsum", "2304x1152", 8192, (t_k, t_p))]
             + [("gather_minsum", n, B, g_times[n]) for n, B in
                (("4000x2000", 4096), ("8000x4000", 2048),
                 ("20000x10000", 1024))]
             + [("streamed_minsum", n, B, s_times[n]) for n, B in
                (("64800x32400", 512), ("16200x7560", 1024),
                 ("64800x6480-dvbs2", 256), ("synthqc-256x128x6-z1024", 256))])
    for kname, name, B, (t, _) in timed:
        b_ms, b_by = _bound(name, B, 10, sm_count, clock_mhz * 1e6)
        bounds[name] = (b_ms, b_by)
        print(f"[roofline] {kname} {name} B={B}: {t * 1e3:.4f} ms against a "
              f"bound of {b_ms:.4f} ms ({b_by}), {b_ms / (t * 1e3):.1%} of "
              f"it | {smi}")
    phase_done(13)

    # "route" is how the kernel is written (CUDA C++); "backend" is the
    # decoder backend that ``auto`` resolves to on the path it was driven
    # on; no one PyTorch call computes a layered min-sum decode, so
    # "library_ms" is null
    spec = LayeredSpec(algo="OMS", iters=10, early_term=True)
    rows = [
        ("layered_minsum", "1944x972", K, n_launch, max_err, "2304x1152",
         (t_k, t_p)),
        ("gather_minsum", "4000x2000", G, g_launch, g_err, "4000x2000",
         g_times["4000x2000"]),
        ("streamed_minsum", "64800x32400", S, s_launch, s_err, "64800x32400",
         s_times["64800x32400"]),
    ]
    kernels = []
    for name, path_code, mod, launches, err, timed_code, (t, t_plain) in rows:
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
            "bound_ms": bounds[timed_code][0],
            "bound_by": bounds[timed_code][1],
            "library_ms": None,
        })
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

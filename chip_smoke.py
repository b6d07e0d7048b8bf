#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``ldpcgputegra_tpu_torch/csrc/``
(one nvcc per source, all at once): the QC kernel (``layered_minsum``) and
the gather kernel for non-QC codes (``gather_minsum``).  Holds the QC
kernel against the committed golden vectors, and each kernel against the
plain PyTorch decoder on the card; times both; then drives each kernel's
path (``run_sweep`` and the CLI, at 1944x972 and at 4000x2000) and checks
that it went through the kernel.  Imports nothing of JAX.  Exits non-zero,
before printing any result, when there is no CUDA device or the package is
not beside this script; any failing phase exits non-zero.  The last line of
standard output is ``{"ok": true, "device": {...}}``; the line before it
lists each kernel with its launches on its path, its largest disagreement
with the plain version, and its time and the plain version's.
"""

from __future__ import annotations

import glob
import json
import math
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))


def _llrs(N: int, B: int, snr_db: float, seed: int):
    """int8 LLRs of the all-zero codeword at ``snr_db`` (rate 1/2), from a
    numpy seed: clamp(8*y, +-31) truncated toward zero."""
    import numpy as np

    sigma = math.sqrt(10 ** (-0.1 * (snr_db + 10 * math.log10(0.5))) / 2)
    rng = np.random.default_rng(seed)
    y = (-1.0 + sigma * rng.standard_normal((B, N))).astype(np.float32)
    return np.clip(8.0 * y, -31, 31).astype(np.int8)


def _hold(make_kernel_decoder, tag, cases, dev, seed0=100) -> int:
    """Decode each case with the kernel and with the plain version on the
    card; both must give the same bits and ``iters_used``.  A case is
    (code, B, algo, minclamp, early_term, SNR dB[, schedule]).  Returns the
    largest |bit difference| (0); fails unless early termination ended
    some decode early."""
    import torch

    from ldpcgputegra_tpu_torch.codes.registry import load_code
    from ldpcgputegra_tpu_torch.ops.layered import (
        LayeredSpec,
        make_layered_decoder,
    )

    max_err = 0
    et_iters = []
    for i, (name, B, algo, mc, et, snr, *sched) in enumerate(cases):
        code = load_code(name)
        schedule = sched[0] if sched else "auto"
        spec = LayeredSpec(algo=algo, iters=10, minclamp=mc, early_term=et,
                           schedule=schedule)
        llr = torch.from_numpy(_llrs(code.N, B, snr, seed=seed0 + i)).to(dev)
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

    N = int(name.split("x")[0])
    inputs = [torch.from_numpy(_llrs(N, B, 2.0, seed=seed0 + s)).to(dev)
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
    from ldpcgputegra_tpu_torch.decoder import backend_for
    from ldpcgputegra_tpu_torch.kernels import gather as G
    from ldpcgputegra_tpu_torch.kernels import layered as K
    from ldpcgputegra_tpu_torch.ops.layered import LayeredSpec, make_layered_decoder

    assert "jax" not in sys.modules, "the port must not import jax"
    dev = torch.device("cuda", 0)

    # 1. device
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"[device] {kind} | count {torch.cuda.device_count()} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}")
    print(f"[device] nvidia-smi: {smi}")

    # 2. build: one nvcc per source, all started together
    with ThreadPoolExecutor(2) as pool:
        builds = {"layered_minsum": pool.submit(K.build),
                  "gather_minsum": pool.submit(G.build)}
        builds = {name: f.result() for name, f in builds.items()}
    for name, info in builds.items():
        print(f"[build] {name}: {os.path.relpath(info['path'], HERE)} in "
              f"{info['seconds']:.2f} s")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"[build] {line.strip()}")

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

    # 5. throughput at the bench configuration
    code = load_code("2304x1152")
    spec = LayeredSpec(algo="OMS", iters=10)
    t_k, t_p = _throughput(K.make_cuda_decoder(code, spec),
                           make_layered_decoder(code, spec, dev),
                           "2304x1152", 8192, smi, dev, seed0=200)

    # 6. the QC path: sweep + CLI at 1944x972, counted launches
    n_launch = _main_path("1944x972", 1024, (1.5, 2.5), 2.0, 64 * 1024, dev,
                          K.launches, "layered_minsum")

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

    # 9. the gather path: sweep + CLI at 4000x2000, counted launches
    g_launch = _main_path("4000x2000", 4096, (1.5, 2.0), 2.0, 16 * 4096, dev,
                          G.launches, "gather_minsum")

    # "route" is how the kernel is written (CUDA C++); "backend" is the
    # decoder backend that ``auto`` resolves to on the path it was driven on
    spec = LayeredSpec(algo="OMS", iters=10, early_term=True)
    print(json.dumps({"kernels": [{
        "name": "layered_minsum",
        "route": "cuda",
        "backend": backend_for(load_code("1944x972"), spec, dev),
        "source": "ldpcgputegra_tpu_torch/csrc/layered_minsum.cu",
        "replaces": K.REPLACES,
        "launches": n_launch,
        "max_abs_err": max_err,
        "ms": t_k * 1e3,
        "plain_ms": t_p * 1e3,
    }, {
        "name": "gather_minsum",
        "route": "cuda",
        "backend": backend_for(load_code("4000x2000"), spec, dev),
        "source": "ldpcgputegra_tpu_torch/csrc/gather_minsum.cu",
        "replaces": G.REPLACES,
        "launches": g_launch,
        "max_abs_err": g_err,
        "ms": g_times["4000x2000"][0] * 1e3,
        "plain_ms": g_times["4000x2000"][1] * 1e3,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

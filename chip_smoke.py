#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernel from ``ldpcgputegra_tpu_torch/csrc/``,
holds it against the committed golden vectors and against the plain
PyTorch decoder on the card, times both, then drives the port's main path
(``run_sweep`` and the CLI) and checks that it went through the kernel.
Imports nothing of JAX.  Exits non-zero, before printing any result, when
there is no CUDA device or the package is not beside this script; any
failing phase exits non-zero.  The last line of standard output is
``{"ok": true, "device": {...}}``; the line before it lists each kernel
with its launches on the main path, its largest disagreement with the
plain version, and its time and the plain version's.
"""

from __future__ import annotations

import glob
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def _llrs(N: int, B: int, snr_db: float, seed: int):
    """int8 LLRs of the all-zero codeword at ``snr_db`` (rate 1/2), from a
    numpy seed: clamp(8*y, +-31) truncated toward zero."""
    import numpy as np

    sigma = math.sqrt(10 ** (-0.1 * (snr_db + 10 * math.log10(0.5))) / 2)
    rng = np.random.default_rng(seed)
    y = (-1.0 + sigma * rng.standard_normal((B, N))).astype(np.float32)
    return np.clip(8.0 * y, -31, 31).astype(np.int8)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import numpy as np

    from ldpcgputegra_tpu_torch.bench import measure_call, throughput_report
    from ldpcgputegra_tpu_torch.codes.registry import load_code
    from ldpcgputegra_tpu_torch.kernels import layered as K
    from ldpcgputegra_tpu_torch.ops.layered import LayeredSpec, make_layered_decoder
    from ldpcgputegra_tpu_torch.sim import cli
    from ldpcgputegra_tpu_torch.sim.sweep import SweepConfig, run_sweep

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

    # 2. build
    info = K.build()
    print(f"[build] {os.path.relpath(info['path'], HERE)} in "
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
    max_err = 0
    et_iters = []
    cases = [
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
    ]
    for i, (name, B, algo, mc, et, snr) in enumerate(cases):
        code = load_code(name)
        spec = LayeredSpec(algo=algo, iters=10, minclamp=mc, early_term=et)
        llr = torch.from_numpy(_llrs(code.N, B, snr, seed=100 + i)).to(dev)
        kb, ki = K.make_cuda_decoder(code, spec)(llr)
        pb, pi = make_layered_decoder(code, spec, dev)(llr)
        torch.cuda.synchronize()
        err = int((kb.to(torch.int16) - pb.to(torch.int16)).abs().max())
        max_err = max(max_err, err)
        ch_err = int((llr > 0).sum())
        print(f"[vs-plain] {name} B={B} {algo}/{mc} ET={et} {snr} dB: "
              f"max|bits diff|={err} iters kernel={int(ki)} plain={int(pi)} "
              f"channel bit errors={ch_err} decoded={int(kb.sum())}")
        assert err == 0 and int(ki) == int(pi), "kernel disagrees with plain"
        assert et or int(ki) == 10, "fixed iterations must report iters"
        if et:
            et_iters.append(int(ki))
    assert min(et_iters) < 10, "early termination never ended a decode early"

    # 5. throughput at the bench configuration
    code = load_code("2304x1152")
    spec = LayeredSpec(algo="OMS", iters=10)
    inputs = [torch.from_numpy(_llrs(code.N, 8192, 2.0, seed=200 + s)).to(dev)
              for s in range(3)]
    kdec = K.make_cuda_decoder(code, spec)
    pdec = make_layered_decoder(code, spec, dev)
    t_k = measure_call(kdec, inputs)
    t_p = measure_call(pdec, inputs, k_small=2, k_large=6, repeats=2)
    for label, t in (("kernel", t_k), ("plain", t_p)):
        r = throughput_report(t, 8192, code.N)
        print(f"[throughput] 2304x1152 B=8192 OMS 10it ET off {label}: "
              f"{r['ms_per_call']:.4f} ms/call, {r['coded_mbps']:.1f} coded "
              f"Mbit/s | {smi}")

    # 6. the main path: sweep + CLI, counted launches
    K.launches["layered_minsum"] = 0
    res = run_sweep(SweepConfig(
        code="1944x972", algo="OMS", iters=10, early_term=True, batch=1024,
        snr_min=1.5, snr_max=2.5, snr_step=1.0, max_fe=50,
        max_frames=64 * 1024, device="cuda",
    ), progress=False)
    cli.main(["--code", "1944x972", "--min", "2.0", "--max", "2.0",
              "--fer", "20", "--batch", "1024", "--max-frames", "8192",
              "--quiet", "--device", "cuda"])
    torch.cuda.synchronize()
    n_launch = K.launches["layered_minsum"]
    print(f"[main-path] layered_minsum launches: {n_launch}")
    assert n_launch > 0, "the main path did not run the kernel"
    p_lo, p_hi = res.points
    assert p_hi.fer < p_lo.fer, "FER does not fall with SNR"
    from ldpcgputegra_tpu_torch.channel.awgn import AwgnChannel

    for p in res.points:
        ch = AwgnChannel(1944, 972, device=dev)
        ch.configure(p.snr_db)
        raw = float((ch.generate_zero_int8(ch.generator(7), 4096) > 0)
                    .float().mean())
        print(f"[main-path] {p.snr_db} dB: frames={p.frames} FE={p.fe} "
              f"FER={p.fer:.4e} BER={p.ber:.4e} raw channel BER={raw:.4e} "
              f"({p.mbps:.1f} coded Mbit/s wall clock)")
        assert p.ber < raw, "decoding did not lower the BER"

    print(json.dumps({"kernels": [{
        "name": "layered_minsum",
        "route": "cuda",
        "source": "ldpcgputegra_tpu_torch/csrc/layered_minsum.cu",
        "replaces": K.REPLACES,
        "launches": n_launch,
        "max_abs_err": max_err,
        "ms": t_k * 1e3,
        "plain_ms": t_p * 1e3,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

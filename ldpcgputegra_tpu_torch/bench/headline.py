"""The headline line on the card: the port of the JAX package's ``bench.py``.

    python -m ldpcgputegra_tpu_torch.bench.headline

Decodes the (2304,1152) 802.16e QC code with 10 layered OMS iterations,
early termination off, 8192 frames a call, through the QC kernel (K1,
``csrc/layered_minsum.cu``; ``make_decoder``'s ``auto`` backend, built
at first use), as ``bench.py:_measure`` does.  The inputs are 8 distinct
batches of the all-zero codeword at 3.0 dB, each from its own seeded
generator on the card; ``bench/harness.py::measure_call`` times the
decode by CUDA events, and ``throughput_report`` converts it in the
reference's accounting (coded bits per second,
``code/gpu_fixed/main.cpp:311-315``).  With ET off the SNR does not
change the work.

Standard error gets one ``(PERF)`` line: ms per call, coded Gbit/s, the
backend, K1's launches in the run and the card's ``nvidia-smi`` name and
power limit.  Standard output gets exactly one JSON line (``record``)::

    {"metric": "decode_throughput_2304x1152_oms_10it_cuda", "value": ...,
     "unit": "coded-Mbps/chip", "vs_baseline": ..., "device": "..."}

``vs_baseline`` is against 132 coded Mbit/s (GTX 680, 3 streams,
``paper/ldpcGpuTegra.tex:345``).  The metric's name carries ``_cuda`` so
that the card's series never mixes with the TPU's.

There is no fallback: without a card it prints "no CUDA device" on
standard error, nothing on standard output, and exits non-zero; a failed
build or launch fails the run; no stored record is ever read or replayed.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from ..channel.awgn import AwgnChannel, ChannelSpec
from ..codes.registry import load_code
from ..decoder import backend_for, make_decoder
from ..kernels import layered
from ..ops.layered import LayeredSpec
from .ber_curves import card_name
from .harness import measure_call, throughput_report

__all__ = ["CODE", "BATCH", "SPEC", "SNR_DB", "N_INPUTS", "BASELINE_MBPS",
           "METRIC", "UNIT", "record", "main"]

# bench.py:_measure's configuration
CODE = "2304x1152"
BATCH = 8192
SPEC = LayeredSpec(algo="OMS", iters=10, early_term=False, minclamp="pre",
                   schedule="auto")
SNR_DB = 3.0
N_INPUTS = 8  # inputs i = 0 .. 7, one generator seeded i each
BASELINE_MBPS = 132.0  # GTX 680, 3 streams, 10 iterations, (2304,1152)
METRIC = "decode_throughput_2304x1152_oms_10it_cuda"
UNIT = "coded-Mbps/chip"


def record(seconds_per_call: float, card: str) -> dict:
    """The headline's JSON record for a decode of ``seconds_per_call`` on
    the card ``card`` (``nvidia-smi``'s name and power limit)."""
    rep = throughput_report(seconds_per_call, BATCH, load_code(CODE).N)
    return {
        "metric": METRIC,
        "value": round(rep["coded_mbps"], 1),
        "unit": UNIT,
        "vs_baseline": round(rep["coded_mbps"] / BASELINE_MBPS, 2),
        "device": card,
    }


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(
        argv)
    if not torch.cuda.is_available():
        print("headline: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    code = load_code(CODE)
    backend = backend_for(code, SPEC, dev)
    if backend != "cuda":  # the headline times K1, never another path
        raise RuntimeError(f"{CODE} resolves to {backend!r}, not 'cuda'")
    decoder = make_decoder(code, SPEC, device=dev)
    chan = AwgnChannel(code.N, code.K, ChannelSpec(), device=dev)
    chan.configure(SNR_DB)
    inputs = [chan.generate_zero_int8(chan.generator(i), BATCH)
              for i in range(N_INPUTS)]
    layered.launches["layered_minsum"] = 0
    sec = measure_call(decoder, inputs)
    torch.cuda.synchronize(dev)
    n_launch = layered.launches["layered_minsum"]
    card = card_name(dev)
    rep = throughput_report(sec, BATCH, code.N)
    print(f"(PERF) {CODE} OMS 10it B={BATCH}: {rep['ms_per_call']:.4f} "
          f"ms/call, {rep['coded_gbps']:.3f} Gbps coded, backend {backend}, "
          f"K1 launches {n_launch} | {card}", file=sys.stderr)
    print(json.dumps(record(sec, card)))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""SNR sweep (the port's counterpart of
``ldpcgputegra_tpu/sim/sweep.py``).

Sweeps Eb/N0 from min to max in steps; per point, generates all-zero
codeword frames through the channel, decodes and counts them in batches
until the adaptive FE limit, a frame budget or a wall-clock budget is
reached; stops the whole sweep at a quasi-error-free FER (``-qef``).

Batches are dispatched ``pipeline_depth`` deep: on a CUDA device the
channel, decode and count of a batch are queued on the stream without a
host wait, and the (BE, FE) counters of the oldest batches are fetched
in one transfer per window.  Batch k of point p draws its noise from a
generator seeded by ``(seed, p, k)``, so dispatch order never changes the
result and a resume from the per-point checkpoint is deterministic.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from collections import deque
from typing import Callable, Optional

import numpy as np
import torch

from ..channel.awgn import AwgnChannel, ChannelSpec
from ..codes.registry import load_code
from ..decoder import default_device, make_decoder
from ..ops.layered import LayeredSpec
from ..quant import QuantSpec
from .analyzer import ErrorAnalyzer, count_errors_async
from .terminal import Terminal

__all__ = ["SweepConfig", "SnrPoint", "SweepResult", "run_sweep",
           "batch_seed"]


@dataclasses.dataclass(frozen=True)
class SweepConfig:
    code: str = "1944x972"
    algo: str = "OMS"  # MS | OMS | NMS | 2NMS
    iters: int = 10
    offset: int = 1
    nms_f: int = 24  # NMS factor, 1/32 units
    nms_f2: int = 28  # 2NMS second factor
    early_term: bool = True
    minclamp: str = "pre"
    schedule: str = "auto"

    snr_min: float = 0.5
    snr_max: float = 4.0
    snr_step: float = 0.25
    es_n0: bool = False
    qpsk: bool = False
    norm_channel: bool = False
    fading: str = "none"  # none | rayleigh
    opt_llr: bool = False
    no_channel: bool = False
    inject_flip_p: float = 0.0
    count_bits: str = "all"  # all | info

    batch: int = 1024  # frames per decode call (-n)
    max_fe: int = 100  # FE limit (-fer)
    auto_fe: bool = True
    max_frames: int = 10_000_000  # per-point frame budget
    timer_s: Optional[float] = None  # per-point wall budget (-timer)
    qef_fer: Optional[float] = None  # sweep cutoff (-qef)
    pipeline_depth: int = 2  # batches kept in flight
    scan_steps: int = 1  # only 1 is ported (ROADMAP queue 1 item 7)

    backend: str = "auto"  # auto | cuda | cuda-gather | cuda-streamed | torch
    channel_rng: str = "threefry"  # read only by backend='native'
    encoder: str = "fake"  # only the fake (all-zero) encoder is ported
    random_bits: bool = True
    quant_factor: int = 8
    bits_llr: int = 6
    var_bits: int = 8  # APP quantizer width -> sat 2^(b-1)-1
    msg_bits: int = 6  # message quantizer width

    seed: int = 1234
    device: Optional[str] = None  # None: cuda when available, else cpu

    checkpoint: Optional[str] = None
    metrics: Optional[str] = None


@dataclasses.dataclass
class SnrPoint:
    snr_db: float
    frames: int
    be: int
    fe: int
    ber: float
    fer: float
    mbps: float
    runtime_s: float
    batches: int = 0


@dataclasses.dataclass
class SweepResult:
    config: SweepConfig
    points: list[SnrPoint]


def _snr_grid(cfg: SweepConfig) -> list[float]:
    pts = []
    s = cfg.snr_min
    while s <= cfg.snr_max + 1e-9:
        pts.append(round(s, 6))
        s += cfg.snr_step
    return pts


def _load_ckpt(path: Optional[str]) -> dict:
    if path and os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {"done": {}, "partial": None}


def _save_ckpt(path: Optional[str], state: dict) -> None:
    if not path:
        return
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(state, f)
    os.replace(tmp, path)


def batch_seed(seed: int, point: int, batch: int) -> int:
    """The channel generator's seed for batch ``batch`` of SNR point
    ``point``."""
    return int(np.random.SeedSequence((seed, point, batch)).generate_state(
        1, np.uint64)[0] >> 1)


def _check_ported(cfg: SweepConfig) -> None:
    if cfg.encoder != "fake":
        raise NotImplementedError(
            "only the fake (all-zero) encoder is ported; the coded path "
            "waits for channel/encoder.py (ROADMAP queue 1 item 7)")
    if cfg.backend == "native":
        raise NotImplementedError(
            "backend='native' is not ported yet (ROADMAP queue 1 item 7)")
    if cfg.scan_steps > 1:
        raise NotImplementedError(
            "scan_steps > 1 is not ported yet (ROADMAP queue 1 item 7: "
            "CUDA Graphs or drop)")
    if cfg.schedule == "flooding":
        raise NotImplementedError(
            "the flooding schedule is not ported yet (ROADMAP queue 1 item 12)")


def run_sweep(
    cfg: SweepConfig,
    progress: bool = True,
    on_point: Optional[Callable[[SnrPoint], None]] = None,
) -> SweepResult:
    _check_ported(cfg)
    device = torch.device(cfg.device) if cfg.device else default_device()
    code = load_code(cfg.code)
    quant = QuantSpec(factor=cfg.quant_factor, bits_llr=cfg.bits_llr)
    chan_spec = ChannelSpec(
        qpsk=cfg.qpsk, es_n0=cfg.es_n0, normalize=cfg.norm_channel,
        fading=cfg.fading, opt_llr=cfg.opt_llr, no_channel=cfg.no_channel,
        inject_flip_p=cfg.inject_flip_p, quant=quant,
    )
    channel = AwgnChannel(code.N, code.K, chan_spec, device)
    spec = LayeredSpec(
        algo=cfg.algo,
        iters=cfg.iters,
        offset=cfg.offset,
        nms_f=cfg.nms_f,
        nms_f2=cfg.nms_f2,
        early_term=cfg.early_term,
        minclamp=cfg.minclamp,
        schedule=cfg.schedule,
        sat_var=(1 << (cfg.var_bits - 1)) - 1,
        sat_msg=(1 << (cfg.msg_bits - 1)) - 1,
    )
    decoder = make_decoder(code, spec, backend=cfg.backend, device=device)
    info_only = cfg.count_bits == "info"
    metrics_f = open(cfg.metrics, "a") if cfg.metrics else None
    ckpt = _load_ckpt(cfg.checkpoint)

    points: list[SnrPoint] = []
    try:
        for pi, snr in enumerate(_snr_grid(cfg)):
            key_snr = str(snr)
            if key_snr in ckpt["done"]:
                points.append(SnrPoint(**ckpt["done"][key_snr]))
                continue
            channel.configure(snr)
            analyzer = ErrorAnalyzer(
                n=code.N, k=code.K, max_fe=cfg.max_fe, auto_fe=cfg.auto_fe,
                counted_bits=code.K if info_only else code.N,
            )
            batch_idx = 0
            resumed_elapsed = 0.0
            part = ckpt.get("partial")
            if part and part.get("snr") == key_snr:
                analyzer.add_counts(part["frames"], part["be"], part["fe"])
                batch_idx = part["batches"]
                # carry the pre-kill wall time so resumed rates stay honest
                resumed_elapsed = float(part.get("elapsed_s", 0.0))
            term = Terminal(
                analyzer, snr, metrics=metrics_f, start_elapsed=resumed_elapsed
            )

            def dispatch(k: int, pi=pi):
                gen = channel.generator(batch_seed(cfg.seed, pi, k))
                llr = channel.generate_zero_int8(gen, cfg.batch)
                decoded, _ = decoder(llr)
                return count_errors_async(decoded, info_only=info_only,
                                          k=code.K)

            depth = max(1, cfg.pipeline_depth)
            inflight: deque = deque()
            next_k = batch_idx
            stop = False
            while not stop or inflight:
                while not stop and len(inflight) < depth:
                    inflight.append(dispatch(next_k))
                    next_k += 1
                # fetch the oldest half of the window in ONE transfer
                n_fetch = max(1, len(inflight) // 2) if not stop else len(inflight)
                group = [inflight.popleft() for _ in range(n_fetch)]
                stacked = torch.stack(
                    [torch.stack([be, fe]) for be, fe in group]).cpu().tolist()
                for be_i, fe_i in stacked:
                    analyzer.add_counts(cfg.batch, int(be_i), int(fe_i))
                    batch_idx += 1
                if progress:
                    term.temp_report()
                ckpt["partial"] = {
                    "snr": key_snr,
                    "frames": analyzer.frames,
                    "be": analyzer.bit_errors,
                    "fe": analyzer.frame_errors,
                    "batches": batch_idx,
                    "elapsed_s": term.elapsed(),
                }
                _save_ckpt(cfg.checkpoint, ckpt)
                if (
                    analyzer.fe_limit_achieved()
                    or analyzer.frames >= cfg.max_frames
                    or (cfg.timer_s is not None and term.elapsed() >= cfg.timer_s)
                ):
                    stop = True
            rec = term.final_report()
            point = SnrPoint(
                snr_db=snr,
                frames=analyzer.frames,
                be=analyzer.bit_errors,
                fe=analyzer.frame_errors,
                ber=analyzer.ber,
                fer=analyzer.fer,
                mbps=rec["mbps"],
                runtime_s=rec["runtime_s"],
                batches=batch_idx,
            )
            points.append(point)
            ckpt["done"][key_snr] = dataclasses.asdict(point)
            ckpt["partial"] = None
            _save_ckpt(cfg.checkpoint, ckpt)
            if on_point:
                on_point(point)
            if cfg.qef_fer is not None and point.fer < cfg.qef_fer:
                break
    finally:
        if metrics_f:
            metrics_f.close()
    return SweepResult(config=cfg, points=points)

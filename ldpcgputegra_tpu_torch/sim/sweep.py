"""SNR sweep (the port's counterpart of
``ldpcgputegra_tpu/sim/sweep.py``).

Sweeps Eb/N0 from min to max in steps; per point, generates frames
through the encoder and the channel, decodes and counts them in batches
until the adaptive FE limit, a frame budget or a wall-clock budget is
reached; stops the whole sweep at a quasi-error-free FER (``-qef``).

Batches are dispatched ``pipeline_depth`` deep: on a CUDA device the
channel, decode and count of a batch are queued on the stream without a
host wait, and the (BE, FE) counters of the oldest batches are fetched
in one transfer per window.  Batch k of point p draws its randomness
from one generator seeded by ``(seed, p, k)``: the noise with the fake
(all-zero) encoder, the info bits and then the noise with a real one.  So
dispatch order never changes the result and a resume from the per-point
checkpoint is deterministic.  The info bits are not the JAX package's
(it draws them with NumPy): the coded path's contract is statistical, as
the channel's is.

``scan_steps`` = S > 1 dispatches S batches at a time (``sim/scan.py``):
one CUDA graph replay on the card, where JAX runs one ``lax.scan``
executable for the fake encoder; counters are the same for any S, and a
frame budget that S does not divide is overshot to whole groups, as in
JAX.  The coded path folds its batches too (the info bits' draw and the
encoder inside the graph), where JAX's dispatches one at a time; the
native backend dispatches one batch at a time.

``et = "twophase"`` decodes each batch by two-phase early termination
(``decoder/twophase.py``) in place of the kernel's own (``early_term`` is
then ignored): phase 1 at ``twophase_k1`` iterations with the convergence
mask, the unconverged frames first (a stable sort of the mask), phase 2 at
the full budget on the first ``twophase_tail`` of them, the merge, and the
count: (BE, FE, unconverged) a batch, queued with no host read, so S
batches are one graph replay as on the kernel-ET path (whose counts stay
(BE, FE)).  At the fetch, a batch whose unconverged count exceeds the tail
kept some unconverged frames' k1-iteration bits: its inputs are made again
from its seed and decoded again exactly (``decode.repair``, in the span
``ldpc.twophase.repair``, count: the batches repaired at that fetch), and
its counts replace the graph's before the terminal, the checkpoint and the
stop test read them.  So every batch's counts are plain two-phase's: a
frame whose k1-iteration decision satisfies every check keeps it, every
other frame gets its full-budget decode, whatever the tail and S.  Each
fetched group is added to ``twophase.stats``; ``on_counts(point, first
batch, rows)`` receives each fetched group's final counts, a row a batch.

``LDPC_TPU_DEBUG_TIMING=1`` prints each window's host spans, as the JAX
sweep does: the time spent dispatching, the time waiting on the fetch of
the counts, and the batches fetched; ``on_window`` receives the same
three numbers.  While a profiler runs, the loop records them as the spans
``ldpc.sweep.dispatch`` and ``ldpc.sweep.fetch`` (``utils/profiling.py``),
from the same clock readings, and the rest of a window's host work, from
``on_window``'s return to the next dispatch, as ``ldpc.sweep.account``.
The spans of a group carry ``(point, first batch)`` as their request.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from collections import deque
from typing import Callable, Optional

import numpy as np
import torch

from ..channel.awgn import AwgnChannel, ChannelSpec
from ..channel.bitgen import generate_info_bits
from ..channel.encoder import FakeEncoder, make_encoder
from ..codes.registry import load_code
from ..decoder import default_device, make_decoder, twophase
from ..ops.layered import LayeredSpec
from ..quant import QuantSpec
from ..utils.profiling import span
from .analyzer import ErrorAnalyzer, count_errors_async
from .scan import ScanSteps
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
    # kernel: each decoder's own early termination (early_term); twophase:
    # two-phase early termination, phase 1 at twophase_k1 iterations, phase
    # 2 at the full budget on a fixed tail of twophase_tail frames
    et: str = "kernel"
    twophase_k1: int = 5
    twophase_tail: int = 256

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
    pipeline_depth: int = 2  # dispatches kept in flight
    # batches a dispatch (any encoder, not the native backend): S > 1 is one
    # CUDA graph replay of S batches on the card (sim/scan.py), a loop of S
    # on the CPU
    scan_steps: int = 1

    # auto | cuda | cuda-gather | cuda-streamed | torch | native
    backend: str = "auto"
    # backend='native' only: 'threefry' = the port's own channel (a torch
    # generator a batch), 'philox' = the native counter-based channel
    channel_rng: str = "threefry"
    encoder: str = "fake"  # fake | table | staircase | gf2 | auto
    random_bits: bool = True  # -random (ignored by the fake encoder)
    quant_factor: int = 8
    bits_llr: int = 6
    var_bits: int = 8  # APP quantizer width -> sat 2^(b-1)-1
    msg_bits: int = 6  # message quantizer width

    seed: int = 1234
    device: Optional[str] = None  # None: the card (raises without one)

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


def _native_decoder(code, spec: LayeredSpec, cfg: SweepConfig):
    """``backend='native'``: the AVX-512 host decoder on the schedule-view
    code, a code whose check table is ``build_layers(code,
    spec.schedule)`` in order, so that it decodes in the order the device
    decoder does.  Returns ``decode(llr ndarray) -> bits ndarray int8``."""
    from ..codes.code import DegreeClass, LdpcCode
    from ..codes.schedule import build_layers
    from ..decoder import effective_code
    from ..golden import GoldenParams
    from ..golden.native import decode_simd_native, simd_available

    if not simd_available():
        raise RuntimeError("backend='native' needs the AVX-512BW build of "
                           "the native library; this host has no AVX-512BW")
    if effective_code(code) is not code:
        raise NotImplementedError(
            f"{code.name}: backend='native' is not available for QC-view "
            "staircase codes (the device decodes the permuted QC view in "
            "another check order; use backend='auto')")
    layers = build_layers(code, spec.schedule)
    sched_view = LdpcCode(
        name=code.name + "-sched", N=code.N, K=code.K,
        classes=tuple(DegreeClass(l.deg, l.idx.shape[0]) for l in layers),
        class_idx=tuple(l.idx for l in layers),
    )
    gp = GoldenParams(
        algo=cfg.algo, iters=cfg.iters, offset=cfg.offset,
        nms_factor=cfg.nms_f / 32.0, nms_factor2=cfg.nms_f2 / 32.0,
        early_term=cfg.early_term, minclamp=cfg.minclamp,
        sat_var=spec.sat_var, sat_msg=spec.sat_msg,
    )
    return lambda llr: decode_simd_native(sched_view, llr, gp)[0]


def run_sweep(
    cfg: SweepConfig,
    progress: bool = True,
    on_point: Optional[Callable[[SnrPoint], None]] = None,
    on_window: Optional[Callable[[float, float, int], None]] = None,
    on_counts: Optional[Callable[[int, int, list], None]] = None,
) -> SweepResult:
    """Run the sweep; ``on_point(point)`` after each SNR point,
    ``on_window(dispatch_s, fetch_s, batches)`` after each fetch window,
    ``on_counts(point, first batch, rows)`` before it: the window's counts,
    a list of [BE, FE] (two-phase: [BE, FE, unconverged]) a batch."""
    if cfg.et not in ("kernel", "twophase"):
        raise ValueError(f"unknown et {cfg.et!r}: kernel or twophase")
    two_phase = cfg.et == "twophase"
    if two_phase and cfg.backend == "native":
        raise ValueError("et='twophase' runs on the factory's decoders; "
                         "backend='native' has no convergence mask")
    if two_phase and not (1 <= cfg.twophase_k1 <= cfg.iters
                          and cfg.twophase_tail >= 1):
        raise ValueError(f"two-phase needs 1 <= k1 <= iters and a tail of "
                         f"at least 1 frame, got k1={cfg.twophase_k1}, "
                         f"tail={cfg.twophase_tail}")
    device = torch.device(cfg.device) if cfg.device else default_device()
    code = load_code(cfg.code)
    quant = QuantSpec(factor=cfg.quant_factor, bits_llr=cfg.bits_llr)
    chan_spec = ChannelSpec(
        qpsk=cfg.qpsk, es_n0=cfg.es_n0, normalize=cfg.norm_channel,
        fading=cfg.fading, opt_llr=cfg.opt_llr, no_channel=cfg.no_channel,
        inject_flip_p=cfg.inject_flip_p, quant=quant,
    )
    channel = AwgnChannel(code.N, code.K, chan_spec, device)
    encoder = make_encoder(code, cfg.encoder)
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
    info_only = cfg.count_bits == "info"
    is_fake = isinstance(encoder, FakeEncoder)
    use_native = cfg.backend == "native"
    if use_native:
        native_decode = _native_decoder(code, spec, cfg)
        # the device decoder only cross-checks batch 0 of each point
        decoder = make_decoder(code, spec, backend="auto", device=device)
        # the native Philox channel wherever the spec allows it
        native_chan = (
            cfg.channel_rng == "philox"
            and chan_spec.fading == "none" and not chan_spec.normalize
            and not chan_spec.no_channel and chan_spec.inject_flip_p == 0.0
        )
        native_amp = (1.0 / math.sqrt(2.0)) if cfg.qpsk else 1.0
    elif two_phase:
        decoder = twophase.make_twophase_decoder(
            code, spec, k1=cfg.twophase_k1, backend=cfg.backend,
            device=device)
    else:
        decoder = make_decoder(code, spec, backend=cfg.backend, device=device)
    tail = min(cfg.twophase_tail, cfg.batch)

    def inputs(gen: torch.Generator):
        """One batch's LLRs from ``gen``, and the bits sent (None: the
        all-zero codeword)."""
        if is_fake:
            return channel.generate_zero_int8(gen, cfg.batch), None
        info = generate_info_bits(gen, cfg.batch, code.K, cfg.random_bits)
        coded = encoder.encode(info)
        # the decoded bits' type, so that the count's kernel takes it
        return channel.generate_int8(gen, coded), coded.view(torch.uint8)

    def step(gen: torch.Generator) -> torch.Tensor:
        """One batch from ``gen``: [2] int64 (BE, FE) on the device; with
        two-phase ET [3] (BE, FE, unconverged)."""
        llr, reference = inputs(gen)
        if two_phase:
            decoded, n_bad = decoder.step(llr, tail)
            return torch.stack((*count_errors_async(
                decoded, reference=reference, info_only=info_only, k=code.K),
                n_bad))
        decoded, _ = decoder(llr)
        return torch.stack(count_errors_async(
            decoded, reference=reference, info_only=info_only, k=code.K))

    def repaired(pi: int, k: int, n_bad: int) -> list:
        """Batch k of point pi decoded again exactly (two-phase): [BE, FE,
        unconverged], fetched."""
        llr, reference = inputs(channel.generator(batch_seed(cfg.seed, pi, k)))
        be, fe = count_errors_async(decoder.repair(llr, n_bad),
                                    reference=reference, info_only=info_only,
                                    k=code.K)
        return [int(be), int(fe), n_bad]

    def native_step(gen: torch.Generator, pi: int, k: int,
                    xchecked: list) -> torch.Tensor:
        """One batch through the native decoder: [1, 2] int64 on the CPU.
        The first batch of a point is also decoded on the device, and the
        point refuses to measure unless the bits are the same."""
        from ..golden.native import awgn_quantize_native

        coded = None
        if not is_fake:
            info = generate_info_bits(gen, cfg.batch, code.K, cfg.random_bits)
            coded = encoder.encode(info)
        if native_chan:
            llr_np = awgn_quantize_native(
                cfg.seed, (pi << 32) | k, cfg.batch, code.N,
                sigma=channel.sigma, factor=channel.factor, sat=quant.sat,
                coded=None if coded is None else coded.cpu().numpy(),
                amp=native_amp)
            llr = None
        else:
            llr = (channel.generate_zero_int8(gen, cfg.batch) if is_fake
                   else channel.generate_int8(gen, coded))
            llr_np = llr.cpu().numpy()
        bits = native_decode(llr_np)
        if not xchecked[0]:
            if llr is None:
                llr = torch.from_numpy(llr_np).to(device)
            ref, _ = decoder(llr)
            if not np.array_equal(ref.cpu().numpy().view(np.int8), bits):
                raise AssertionError(
                    f"{code.name}: the native decode differs from the device "
                    f"decoder's on the first batch of point {pi}: refusing "
                    "to measure")
            xchecked[0] = True
        err = bits != (0 if coded is None else coded.cpu().numpy())
        if info_only:
            err = err[:, : code.K]
        be_pf = err.sum(axis=1)
        return torch.tensor([[int(be_pf.sum()), int((be_pf != 0).sum())]])

    # batches a dispatch: scan-folded on every path but the native one
    grp = max(1, cfg.scan_steps) if not use_native else 1
    scan = ScanSteps(step, grp, device) if grp > 1 else None
    metrics_f = open(cfg.metrics, "a") if cfg.metrics else None
    ckpt = _load_ckpt(cfg.checkpoint)
    debug_t = os.environ.get("LDPC_TPU_DEBUG_TIMING") == "1"

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

            xchecked = [False]

            def dispatch(k: int, pi=pi, xchecked=xchecked) -> torch.Tensor:
                """Batches k .. k + grp - 1: [grp, 2] counts (two-phase:
                [grp, 3]), not fetched."""
                if use_native:
                    return native_step(
                        channel.generator(batch_seed(cfg.seed, pi, k)), pi, k,
                        xchecked)
                if scan is not None:
                    return scan([batch_seed(cfg.seed, pi, k + j)
                                 for j in range(grp)])
                return step(channel.generator(batch_seed(cfg.seed, pi, k)))[None]

            depth = max(1, cfg.pipeline_depth)
            inflight: deque = deque()  # (first batch, counts) of each group
            next_k = batch_idx
            stop = False
            t_disp = time.perf_counter()
            while not stop or inflight:
                with span("sweep.dispatch", request=(pi, next_k),
                          start=t_disp) as sp:
                    k0 = next_k
                    while not stop and len(inflight) < depth:
                        inflight.append((next_k, dispatch(next_k)))
                        next_k += grp
                    sp.count = next_k - k0
                t_fetch = sp.end = time.perf_counter()
                # fetch the oldest half of the window in ONE transfer
                req = (pi, inflight[0][0])
                with span("sweep.fetch", request=req, start=t_fetch) as sp:
                    n_fetch = (max(1, len(inflight) // 2) if not stop
                               else len(inflight))
                    group = [inflight.popleft() for _ in range(n_fetch)]
                    k_first = group[0][0]
                    stacked = torch.cat([c for _, c in group]).cpu().tolist()
                    if two_phase:
                        over = [j for j, r in enumerate(stacked)
                                if r[2] > tail]
                        if over:
                            with span("twophase.repair", request=req,
                                      count=len(over)):
                                for j in over:
                                    stacked[j] = repaired(pi, k_first + j,
                                                          stacked[j][2])
                        twophase.tally(cfg.batch, tail,
                                       [r[2] for r in stacked],
                                       [stacked[j][2] for j in over])
                    for row in stacked:
                        analyzer.add_counts(cfg.batch, int(row[0]),
                                            int(row[1]))
                        batch_idx += 1
                    sp.count = len(stacked)
                    if on_counts is not None:
                        on_counts(pi, k_first, stacked)
                t_end = sp.end = time.perf_counter()
                if on_window is not None:
                    on_window(t_fetch - t_disp, t_end - t_fetch, len(stacked))
                with span("sweep.account", request=req) as sp:
                    if debug_t:
                        print(f"(DBG) window: dispatch "
                              f"{1e3 * (t_fetch - t_disp):.1f} ms, fetch "
                              f"{1e3 * (t_end - t_fetch):.1f} ms "
                              f"({len(stacked)} batches)")
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
                        or (cfg.timer_s is not None
                            and term.elapsed() >= cfg.timer_s)
                    ):
                        stop = True
                t_disp = sp.end = time.perf_counter()
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

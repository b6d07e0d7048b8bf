"""Command-line simulator — the same flags as ``ldpcgputegra_tpu.sim.cli``.

Usage:
    python -m ldpcgputegra_tpu_torch.sim.cli --code 1944x972 --algo OMS \
        --min 0.5 --max 3.0 --step 0.25 --fer 100 --iters 10
"""

from __future__ import annotations

import argparse

from .sweep import SweepConfig, run_sweep


class _AwgnAlias(argparse.Action):
    """Accept the reference's -awgn_jego / -awgn channel selectors as
    no-ops: AWGN is already the default channel."""

    def __call__(self, parser, namespace, values, option_string=None):
        setattr(namespace, "fading", "none")
        setattr(namespace, "no_channel", False)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ldpc-sim-torch",
        description="PyTorch/CUDA LDPC BER/FER Monte-Carlo simulator",
    )
    g = p.add_argument_group("code / algorithm")
    g.add_argument("--code", default="1944x972", help="registry name or path")
    g.add_argument(
        "--algo", default="OMS", choices=["MS", "OMS", "NMS", "2NMS"]
    )
    g.add_argument("--iters", type=int, default=10, help="-iter equivalent")
    g.add_argument("--offset", type=int, default=1, help="OMS beta")
    g.add_argument("--nms-factor", dest="nms_f", type=int, default=24,
                   help="NMS normalization in 1/32 units")
    g.add_argument("--nms-factor2", dest="nms_f2", type=int, default=28,
                   help="2NMS second factor in 1/32 units")
    g.add_argument("--no-early-term", dest="early_term", action="store_false",
                   help="disable syndrome early termination")
    g.add_argument("--et", default="kernel", choices=["kernel", "twophase"],
                   help="kernel = each decoder's own early termination; "
                        "twophase = two-phase early termination (--k1 "
                        "iterations on every frame, the full budget on a "
                        "fixed tail of the unconverged ones; --no-early-term "
                        "is then ignored)")
    g.add_argument("--k1", dest="twophase_k1", type=int, default=5,
                   help="with --et twophase: phase 1's iterations")
    g.add_argument("--tail", dest="twophase_tail", type=int, default=256,
                   help="with --et twophase: phase 2's batch (frames); a "
                        "batch with more unconverged frames is decoded "
                        "again at the fetch")
    g.add_argument("--minclamp", default="pre", choices=["pre", "post"],
                   help="pre = x86 scalar oracle semantics, post = GPU kernels")
    g.add_argument("--schedule", default="auto",
                   choices=["auto", "reference", "colored", "flooding"],
                   help="layered check order, or flooding (all checks in "
                        "parallel, plain PyTorch; ~2x the iterations for the "
                        "same BER)")
    g.add_argument("--backend", default="auto",
                   choices=["auto", "cuda", "cuda-gather", "cuda-streamed",
                            "torch", "native"],
                   help="cuda = hand-written QC kernel, cuda-gather = "
                        "hand-written kernel for any layers (non-QC codes), "
                        "cuda-streamed = hand-written kernel with the APP in "
                        "device memory (DVB-S2 QC views, synthqc), "
                        "torch = plain PyTorch, native = the AVX-512 host "
                        "decoder (golden/native.py), its first batch of "
                        "each point checked against the device decoder")
    g.add_argument("--device", default=None,
                   help="torch device (default: the card, cuda; without one "
                        "the run refuses: --device cpu runs the plain "
                        "version on the CPU)")
    p.add_argument("--channel-rng", dest="channel_rng", default="threefry",
                   choices=["threefry", "philox"],
                   help="with --backend native: threefry = the port's own "
                        "channel, philox = the native counter-based channel "
                        "(another stream, the same statistics)")

    s = p.add_argument_group("SNR sweep")
    s.add_argument("--min", dest="snr_min", type=float, default=0.5)
    s.add_argument("--max", dest="snr_max", type=float, default=4.0)
    s.add_argument("--step", dest="snr_step", type=float, default=0.25,
                   help="-pas equivalent")
    s.add_argument("--es-n0", action="store_true", help="-Es/N0 mode")
    s.add_argument("--qpsk", action="store_true", help="-qpsk modulation")
    s.add_argument("--norm-channel", action="store_true")
    s.add_argument("--rayleigh", dest="fading", action="store_const",
                   const="rayleigh", default="none",
                   help="flat Rayleigh fading (-Rayleigh_Fading equivalent)")
    s.add_argument("--no-channel", dest="no_channel", action="store_true",
                   help="noiseless channel (perfect LLRs; -no-channel)")
    s.add_argument("--awgn-jego", "--awgn", dest="awgn", nargs=0,
                   action=_AwgnAlias, help="AWGN channel (the default)")
    s.add_argument("--inject-flip", dest="inject_flip_p", type=float,
                   default=0.0,
                   help="LLR sign-flip fault-injection probability")

    t = p.add_argument_group("stopping / batching")
    t.add_argument("--batch", "-n", type=int, default=1024,
                   help="frames per decode call (-n equivalent)")
    t.add_argument("--fer", dest="max_fe", type=int, default=100,
                   help="frame-error limit per point")
    t.add_argument("--no-auto-fe", dest="auto_fe", action="store_false",
                   help="disable adaptive FE-limit shrink at low BER")
    t.add_argument("--max-frames", type=int, default=10_000_000)
    t.add_argument("--timer", dest="timer_s", type=float, default=None,
                   help="per-point wall-clock budget in seconds")
    t.add_argument("--qef", "--tfer", dest="qef_fer", type=float,
                   default=None,
                   help="stop sweep when FER drops below this value")
    t.add_argument("--pipeline", dest="pipeline_depth", type=int, default=2,
                   help="dispatches kept in flight")
    t.add_argument("--scan-steps", dest="scan_steps", type=int, default=1,
                   help="batches a dispatch, with any encoder: one CUDA "
                        "graph replay of S batches on the card (the native "
                        "backend takes one)")

    e = p.add_argument_group("encoder / quantization")
    e.add_argument("--encoder", default="fake",
                   choices=["fake", "table", "staircase", "gf2", "auto"],
                   help="fake = all-zero codeword; the others encode random "
                        "info bits on the device")
    e.add_argument("--all-zero-bits", dest="random_bits",
                   action="store_false", help="info bits all zero")
    e.add_argument("--llr-factor", dest="quant_factor", type=int, default=8,
                   help="-fraq equivalent (FACTEUR_BETA)")
    e.add_argument("--llr-bits", dest="bits_llr", type=int, default=6,
                   help="-llr equivalent (quantizer width)")
    e.add_argument("--var-bits", type=int, default=8,
                   help="-var equivalent (APP width; sat 2^(b-1)-1)")
    e.add_argument("--msg-bits", type=int, default=6,
                   help="-msg equivalent (message width)")
    e.add_argument("--ollr", dest="opt_llr", action="store_true",
                   help="sigma-adaptive LLR quantizer scale (-ollr)")
    e.add_argument("--info-ber", dest="count_bits", action="store_const",
                   const="info", default="all",
                   help="count info-bit errors only; default counts all "
                        "coded bits")

    o = p.add_argument_group("io")
    o.add_argument("--seed", type=int, default=1234)
    o.add_argument("--checkpoint", default=None,
                   help="JSON checkpoint path for resume")
    o.add_argument("--metrics", default=None, help="JSONL metrics path")
    o.add_argument("--quiet", action="store_true")
    o.add_argument("--histo", action="store_true",
                   help="print the quantized-LLR histogram of one batch")
    o.add_argument("--info", action="store_true",
                   help="print decoder backend/layout info and exit")
    return p


def config_from_args(args: argparse.Namespace) -> SweepConfig:
    fields = {f.name for f in SweepConfig.__dataclass_fields__.values()}
    kw = {k: v for k, v in vars(args).items() if k in fields}
    return SweepConfig(**kw)


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    print(
        f"(II) PyTorch LDPC simulator | code={cfg.code} algo={cfg.algo} "
        f"iters={cfg.iters} batch={cfg.batch} "
        f"sweep=[{cfg.snr_min}:{cfg.snr_step}:{cfg.snr_max}] dB"
    )
    if args.info:
        _print_info(cfg)
        return
    if args.histo:
        _print_histo(cfg)
    run_sweep(cfg, progress=not args.quiet)


def _spec(cfg: SweepConfig):
    from ..ops.layered import LayeredSpec

    return LayeredSpec(algo=cfg.algo, iters=cfg.iters, offset=cfg.offset,
                       early_term=cfg.early_term, minclamp=cfg.minclamp,
                       schedule=cfg.schedule, nms_f=cfg.nms_f,
                       nms_f2=cfg.nms_f2)


def _print_info(cfg: SweepConfig) -> None:
    """Backend/layout report (the reference's -info kernel report)."""
    import torch

    from ..channel.encoder import FakeEncoder, make_encoder
    from ..codes.registry import load_code
    from ..decoder import backend_for, effective_code
    from ..kernels._lib import SMS_H100

    base = load_code(cfg.code)
    spec = _spec(cfg)
    # flooding decodes the original code, the layered schedules its QC view
    code = base if spec.schedule == "flooding" else effective_code(base)
    # no device named: resolved as for the card, which need not be here
    device = torch.device(cfg.device or "cuda")
    if device.type != "cuda":
        name = "cpu"
    elif torch.cuda.is_available():
        name = torch.cuda.get_device_name(device)
    else:
        name = "not present here; backend resolved as for a card"
    print(f"(II) device       : {device} ({name})")
    print(f"(II) code         : N={code.N} K={code.K} M={code.M} "
          f"checks={code.n_checks} Z={code.Z} rate={code.rate:.3f}")
    print(f"(II) layers       : {len(code.layers)} "
          f"(qc {sum(1 for l in code.layers if l.qc is not None)}, sub-pass "
          f"{sum(1 for l in code.layers if l.qc and l.qc.commit_rows is not None)})"
          + (" of the QC view" if code.col_perm is not None else ""))
    enc = make_encoder(base, cfg.encoder)
    print(f"(II) encoder      : {cfg.encoder} -> {type(enc).__name__}"
          + ("" if isinstance(enc, FakeEncoder) else
             f" ({'random' if cfg.random_bits else 'all-zero'} info bits, "
             "encoded on the device)"))
    try:
        if cfg.backend == "native":
            print(f"(II) backend      : native (the AVX-512 host decoder, "
                  f"{cfg.channel_rng} channel); each point's first batch "
                  f"checked against {backend_for(code, spec, device)}")
            return
        backend = backend_for(code, spec, device, cfg.backend)
    except NotImplementedError as e:
        print(f"(II) backend      : none ({e})")
        return
    print(f"(II) backend      : {backend}")
    two_phase = cfg.et == "twophase"
    if two_phase:
        print(f"(II) early term.  : two-phase, phase 1 at {cfg.twophase_k1} "
              f"iterations with the convergence mask on all {cfg.batch} "
              f"frames, phase 2 at {cfg.iters} on a tail of "
              f"{min(cfg.twophase_tail, cfg.batch)} frames (a batch with "
              "more unconverged frames decoded again at the fetch)")
    else:
        print(f"(II) early term.  : the kernel's own "
              f"({'on' if cfg.early_term else 'off'})")
    if cfg.scan_steps > 1:
        how = ("one CUDA graph captured at the first dispatch, one replay "
               "a dispatch" if device.type == "cuda" else "a loop")
        print(f"(II) scan steps   : {cfg.scan_steps} batches a dispatch "
              f"({how}), {cfg.pipeline_depth} dispatches in flight")
    sms = (torch.cuda.get_device_properties(device).multi_processor_count
           if device.type == "cuda" and torch.cuda.is_available()
           else SMS_H100)
    _print_pick(code, cfg, backend, cfg.batch, sms)
    if two_phase:
        # the S batches of a dispatch share one phase-2 call
        te = max(1, cfg.scan_steps) * min(cfg.twophase_tail, cfg.batch)
        print(f"(II) phase 2      : one call a dispatch, {te} frames")
        _print_pick(code, cfg, backend, te, sms)


def _print_pick(code, cfg: SweepConfig, backend: str, batch: int,
                sms: int) -> None:
    """The decode kernel's variant for a batch of ``batch``."""
    if backend == "cuda-gather":
        from ..codes.convert import layer_shapes
        from ..kernels import gather

        shapes = layer_shapes(code, cfg.schedule)
        v = gather.pick_tile(code, batch, sms, cfg.schedule, shapes)
        print(f"(II) gather       : {len(shapes)} {cfg.schedule} layers, "
              f"{v.tile} codewords per CTA at batch {batch} on {sms} SMs "
              f"(w={gather.W} a thread, k={v.k} lanes a check), "
              f"{gather.smem_bytes(code, v)} B shared memory")
    if backend == "cuda":
        from ..kernels import layered

        tile = layered.pick_tile(code, batch, sms)
        print(f"(II) QC kernel    : {tile} codewords per CTA at batch "
              f"{batch} on {sms} SMs, {layered.NTHREADS // tile} check "
              f"lanes, {layered.smem_bytes(code, tile)} B shared memory")
    if backend == "cuda-streamed":
        from ..kernels import streamed

        shapes = streamed.layer_shapes(code, cfg.schedule)
        v = streamed.pick_tile(code, batch, sms, cfg.schedule, shapes)
        msgs = -(-batch // v.tile) * v.tile * sum(g * d for g, d in shapes)
        where = ("shared memory" if v.placement == "smem"
                 else "device memory")
        print(f"(II) streamed     : {v.tile} codewords per CTA at batch "
              f"{batch} on {sms} SMs, {v.k} lanes a check, APP in "
              f"{where} ({streamed.smem_bytes(code, v)} B shared memory a "
              f"CTA), messages in device memory ({msgs} B)")


def _print_histo(cfg: SweepConfig) -> None:
    from ..channel.awgn import AwgnChannel, ChannelSpec
    from ..codes.registry import load_code
    from ..decoder import default_device
    from ..quant import QuantSpec, print_llr_histogram

    code = load_code(cfg.code)
    quant = QuantSpec(factor=cfg.quant_factor, bits_llr=cfg.bits_llr)
    chan = AwgnChannel(code.N, code.K, ChannelSpec(
        qpsk=cfg.qpsk, es_n0=cfg.es_n0, normalize=cfg.norm_channel,
        fading=cfg.fading, quant=quant), cfg.device or default_device())
    chan.configure(cfg.snr_min)
    llr = chan.generate_zero_int8(chan.generator(cfg.seed), cfg.batch)
    print_llr_histogram(llr, quant)


if __name__ == "__main__":
    main()

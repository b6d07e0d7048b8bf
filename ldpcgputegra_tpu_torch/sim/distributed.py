"""Multi-process sharded Monte-Carlo point: the port's counterpart of
``ldpcgputegra_tpu/sim/distributed.py``.

Every rank makes the same global batch from the sweep's per-batch seed
(``sim/sweep.py::batch_seed(seed, 0, k)``, point 0) and decodes its share
of it; the counters are summed over the ranks.  So a point's (frames, BE,
FE) equal a one-process ``run_sweep`` over the same seeds, the contract
the JAX package keeps with threefry keys.  Rank 0 reports.

Launch one process a rank with torchrun, which sets the rank, the world
size and the rendezvous (``MASTER_ADDR`` / ``MASTER_PORT``):

    torchrun --nproc-per-node 2 -m ldpcgputegra_tpu_torch.sim.distributed \\
        --dist-backend gloo --code 1944x972 --snr 2.0 --batch 4096 \\
        --batches 10

``--dist-backend nccl`` when each rank owns a card (rank r takes card
``LOCAL_RANK``); ``gloo`` on the CPU (``--device cpu``) or when the ranks
share one card, which NCCL refuses.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional

import torch
import torch.distributed as dist

from ..channel.awgn import AwgnChannel, ChannelSpec
from ..codes.registry import load_code
from ..ops.layered import LayeredSpec
from ..parallel import (
    decode_mesh,
    decode_mesh_2d,
    initialize_distributed,
    make_dp_tp_decoder,
    make_sharded_decoder,
)
from .analyzer import ErrorAnalyzer
from .sweep import batch_seed

__all__ = ["run_distributed_point", "run_dp_tp_point", "main"]


def _channel(code, snr_db: float, device) -> AwgnChannel:
    chan = AwgnChannel(code.N, code.K, ChannelSpec(), device)
    chan.configure(snr_db)
    return chan


def _device(device):
    from ..decoder import default_device

    return torch.device(device) if device is not None else default_device()


def run_distributed_point(
    code_name: str,
    snr_db: float,
    batch: int,
    batches: int,
    spec: LayeredSpec = LayeredSpec(),
    seed: int = 1234,
    mesh=None,
    device=None,
) -> Optional[ErrorAnalyzer]:
    """Decode ``batches`` global batches at one SNR over the ``dp`` ranks
    of ``mesh`` (default: every rank) on ``device`` (default: the card).

    ``batch`` is the GLOBAL batch size (divisible by the rank count).
    Returns the analyzer on rank 0 of the world, None elsewhere.
    """
    code = load_code(code_name)
    device = _device(device)
    mesh = mesh if mesh is not None else decode_mesh()
    step = make_sharded_decoder(code, spec, mesh, device=device)
    chan = _channel(code, snr_db, device)
    analyzer = ErrorAnalyzer(n=code.N, k=code.K)
    for k in range(batches):
        llr = chan.generate_zero_int8(
            chan.generator(batch_seed(seed, 0, k)), batch)
        _, _, be, fe = step(llr)
        analyzer.add_counts(batch, int(be), int(fe))
    if not dist.is_initialized() or dist.get_rank() == 0:
        return analyzer
    return None


def run_dp_tp_point(
    code_name: str,
    snr_db: float,
    batch: int,
    batches: int,
    spec: LayeredSpec = LayeredSpec(),
    seed: int = 1234,
    dp: int = 2,
    tp: int = 4,
    mesh=None,
    checkpoint: Optional[str] = None,
    device=None,
) -> ErrorAnalyzer:
    """One Monte-Carlo point through the ``(dp, tp)`` topology
    (``parallel.rowshard.make_dp_tp_decoder``): the batch over dp, each
    codeword's Tanner graph over tp, with the sweep's per-batch seeds and
    a checkpoint after every batch that a later call resumes from.

    The counters equal a one-device decode of the same batches: the row
    sharding is bit-exact and the seeds are ``run_sweep``'s (point 0).
    Every rank returns the same analyzer; rank 0 writes the checkpoint.
    """
    code = load_code(code_name)
    device = _device(device)
    mesh = mesh if mesh is not None else decode_mesh_2d(dp, tp)
    step = make_dp_tp_decoder(code, spec, mesh, device=device)
    chan = _channel(code, snr_db, device)
    analyzer = ErrorAnalyzer(n=code.N, k=code.K)
    k0 = 0
    if checkpoint and os.path.exists(checkpoint):
        with open(checkpoint) as f:
            st = json.load(f)
        analyzer.add_counts(st["frames"], st["be"], st["fe"])
        k0 = st["batches"]
    if dist.is_initialized():
        dist.barrier()  # every rank has read it before rank 0 rewrites it
    writer = checkpoint and (not dist.is_initialized()
                             or dist.get_rank() == 0)
    for k in range(k0, batches):
        llr = chan.generate_zero_int8(
            chan.generator(batch_seed(seed, 0, k)), batch)
        _, _, be, fe = step(llr)
        analyzer.add_counts(batch, int(be), int(fe))
        if writer:
            tmp = checkpoint + ".tmp"
            with open(tmp, "w") as f:
                json.dump({
                    "frames": analyzer.frames,
                    "be": analyzer.bit_errors,
                    "fe": analyzer.frame_errors,
                    "batches": k + 1,
                }, f)
            os.replace(tmp, checkpoint)
    return analyzer


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="one sharded Monte-Carlo point over torchrun's ranks")
    ap.add_argument("--dist-backend", required=True, choices=["gloo", "nccl"],
                    help="nccl: one card a rank; gloo: the CPU, or ranks "
                         "that share one card")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; with nccl rank r "
                         "takes card LOCAL_RANK)")
    ap.add_argument("--code", default="1944x972")
    ap.add_argument("--snr", type=float, default=2.0)
    ap.add_argument("--batch", type=int, default=4096,
                    help="the global batch, divisible by the dp ranks")
    ap.add_argument("--batches", type=int, default=10)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)

    initialize_distributed(args.dist_backend)
    rank = dist.get_rank() if dist.is_initialized() else 0
    world = dist.get_world_size() if dist.is_initialized() else 1
    spec = LayeredSpec(algo="OMS", iters=args.iters, early_term=True)
    res = run_distributed_point(args.code, args.snr, args.batch,
                                args.batches, spec, device=args.device)
    if rank == 0:
        print(f"(II) ranks={world} backend={args.dist_backend} "
              f"device={_device(args.device)}")
        print(f"RESULT frames={res.frames} be={res.bit_errors} "
              f"fe={res.frame_errors} ber={res.ber:.3e} fer={res.fer:.3e}")
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

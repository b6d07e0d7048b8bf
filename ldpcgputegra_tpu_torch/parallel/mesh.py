"""Process groups and their set-up: the port's counterpart of
``ldpcgputegra_tpu/parallel/mesh.py``.

A JAX mesh names devices; here each rank is one process with one device,
and a mesh is the ``torch.distributed`` process groups it belongs to:

* ``decode_mesh()``: one ``dp`` axis over every rank (the codeword batch);
* ``decode_mesh_2d(dp, tp)``: rank r sits at ``(r // tp, r % tp)``, the
  layout of JAX's ``reshape(dp, tp)``; its ``dp`` group holds the ranks of
  its column (the same tp index), its ``tp`` group those of its row.

The backend is the caller's explicit choice: ``nccl`` when each rank owns
a card, ``gloo`` on the CPU or when ranks share one card (NCCL refuses two
ranks on one GPU).  Without a default process group (one process, nothing
initialised) a mesh holds no groups and the collectives are skipped.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist

__all__ = [
    "DecodeMesh",
    "all_reduce",
    "decode_mesh",
    "decode_mesh_2d",
    "initialize_distributed",
    "local_batch_size",
]

BATCH_AXIS = "dp"
TP_AXIS = "tp"
BACKENDS = ("gloo", "nccl")


@dataclasses.dataclass(frozen=True)
class DecodeMesh:
    """This rank's place in a 1-D ``(dp,)`` or 2-D ``(dp, tp)`` mesh.

    ``dp_group`` / ``tp_group`` are None when no default process group
    exists (one process: nothing to reduce over)."""

    dp_rank: int
    dp_size: int
    dp_group: Optional[object] = None
    tp_rank: int = 0
    tp_size: int = 1
    tp_group: Optional[object] = None
    axis_names: tuple = (BATCH_AXIS,)

    @property
    def size(self) -> int:
        """Ranks in the mesh."""
        return self.dp_size * self.tp_size


def _world() -> tuple[int, int, bool]:
    """(rank, world size, whether a default group exists)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size(), True
    return 0, 1, False


def initialize_distributed(
    backend: str,
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
) -> None:
    """Join the default process group (``torch.distributed``).

    ``world_size`` and ``rank`` default to torchrun's ``WORLD_SIZE`` and
    ``RANK``, ``init_method`` to ``env://`` (torchrun's ``MASTER_ADDR`` and
    ``MASTER_PORT``).  At world size 1 with no ``init_method`` this does
    nothing.  With ``nccl`` the rank takes the card ``LOCAL_RANK`` (else
    its rank) as its current device.
    """
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: choose one of {BACKENDS} "
                         "(nccl: one card a rank; gloo: the CPU, or ranks "
                         "that share a card)")
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    if world_size == 1 and init_method is None:
        return
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
    dist.init_process_group(backend=backend,
                            init_method=init_method or "env://",
                            world_size=world_size, rank=rank)


def decode_mesh(n_devices: Optional[int] = None) -> DecodeMesh:
    """1-D mesh over every rank: the codeword batch's (data-parallel) axis.
    ``n_devices``, when given, must be the world size."""
    rank, world, grouped = _world()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"a mesh of {n_devices} ranks in a world of "
                         f"{world}: start {n_devices} ranks")
    return DecodeMesh(dp_rank=rank, dp_size=world,
                      dp_group=dist.group.WORLD if grouped else None)


def decode_mesh_2d(dp: int, tp: int) -> DecodeMesh:
    """2-D ``(dp, tp)`` mesh: the codeword batch over ``dp``, each
    codeword's Tanner graph block-row-sharded over ``tp``
    (``parallel.rowshard``).  Every rank of the world must call it (it
    creates the groups); a rank outside the first ``dp * tp`` raises."""
    rank, world, grouped = _world()
    assert world >= dp * tp, (
        f"need {dp * tp} ranks for a {dp}x{tp} mesh, have {world}"
    )
    dp_group = tp_group = None
    if grouped:
        # every rank creates every group, in one order (new_group's rule)
        rows = [dist.new_group(list(range(i * tp, (i + 1) * tp)))
                for i in range(dp)]
        cols = [dist.new_group(list(range(j, dp * tp, tp)))
                for j in range(tp)]
        if rank >= dp * tp:
            raise ValueError(f"rank {rank} is outside the {dp}x{tp} mesh")
        tp_group, dp_group = rows[rank // tp], cols[rank % tp]
    return DecodeMesh(dp_rank=rank // tp, dp_size=dp, dp_group=dp_group,
                      tp_rank=rank % tp, tp_size=tp, tp_group=tp_group,
                      axis_names=(BATCH_AXIS, TP_AXIS))


def all_reduce(t: torch.Tensor, group, op=None) -> torch.Tensor:
    """``dist.all_reduce`` of ``t`` in place over ``group`` (SUM unless
    ``op``); nothing when the group is None (one process, no group)."""
    if group is not None:
        dist.all_reduce(t, op=op or dist.ReduceOp.SUM, group=group)
    return t


def local_batch_size(global_batch: int, mesh: DecodeMesh) -> int:
    """The frames a rank of the ``dp`` axis decodes."""
    n = mesh.dp_size
    if global_batch % n:
        raise ValueError(
            f"global batch {global_batch} not divisible by {n} dp ranks")
    return global_batch // n

"""Multi-device execution over ``torch.distributed``: the port's
counterpart of ``ldpcgputegra_tpu/parallel/``.

The reference's parallel axes are frame batching and host streams on one
GPU.  Here, as in the JAX package, with one process a rank:

* DP: the codeword batch shared out over the ranks of the ``dp`` group;
  decoding is embarrassingly parallel, so only the counters travel
  (``all_reduce`` of (BE, FE), the maximum of ``iters_used``);
* TP: one codeword's Tanner graph block-row-sharded over the ``tp`` group
  (``rowshard``), one ``all_reduce`` of APP deltas a layer; composable
  with DP on a ``(dp, tp)`` mesh (``make_dp_tp_decoder``);
* ``initialize_distributed`` joins the default group (torchrun's
  environment, or an explicit ``init_method``), with the backend named by
  the caller: ``nccl`` for one card a rank, ``gloo`` on the CPU or for
  ranks that share a card.
"""

from .mesh import (
    decode_mesh,
    decode_mesh_2d,
    initialize_distributed,
    local_batch_size,
)
from .rowshard import make_dp_tp_decoder, make_rowsharded_decoder
from .sharded import make_sharded_decoder

__all__ = [
    "decode_mesh",
    "decode_mesh_2d",
    "initialize_distributed",
    "local_batch_size",
    "make_dp_tp_decoder",
    "make_rowsharded_decoder",
    "make_sharded_decoder",
]

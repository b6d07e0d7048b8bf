"""The port's counterpart of ``__graft_entry__.py``: the flagship
single-card step and the multi-rank dry run.

``entry(device=None)`` returns ``(fn, (llr,))``: ``fn`` the batched
layered OMS decode of the 802.11n 1944x972 code (10 iterations, ET off)
from ``make_decoder``, which is the QC kernel (K1) on the card and the
plain PyTorch decoder with ``device="cpu"``; ``llr`` 128 frames of int8
LLRs from the same numpy recipe as the JAX entry, so the array is
identical to JAX's, as a tensor on the device.  Without a card and
without ``device="cpu"`` it raises (``default_device``): there is no
fallback to the CPU.

``dryrun_multichip`` is ``parallel/dryrun.py``'s.
"""

from __future__ import annotations

import numpy as np
import torch

from .codes.registry import load_code
from .decoder import default_device, make_decoder
from .ops.layered import LayeredSpec
from .parallel.dryrun import dryrun_multichip

__all__ = ["CODE", "BATCH", "SPEC", "entry", "dryrun_multichip"]

CODE = "1944x972"
BATCH = 128
SPEC = LayeredSpec(algo="OMS", iters=10, early_term=False, minclamp="pre",
                   schedule="auto")


def entry(device=None):
    """(fn, example_args): the flagship decode step on ``device`` (default:
    the card)."""
    device = torch.device(device) if device is not None else default_device()
    code = load_code(CODE)
    fn = make_decoder(code, SPEC, device=device)
    rng = np.random.default_rng(0)
    llr = np.clip(8.0 * (-1.0 + 0.8 * rng.normal(size=(BATCH, code.N))), -31,
                  31).astype(np.int8)
    return fn, (torch.from_numpy(llr).to(device),)

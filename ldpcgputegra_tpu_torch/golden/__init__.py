"""Golden (reference-semantics) fixed-point decoder oracles: the port's
copy of ``ldpcgputegra_tpu/golden/``.

``decode_golden`` is the readable NumPy specification (slow, scalar);
``decode_oracle`` is the batched oracle, the native C++ one
(``golden/native.py``), which is bit for bit the NumPy model.  Unlike the
JAX package's, it has no NumPy fallback: a failed native build raises.
"""

from __future__ import annotations

import numpy as np

from .decoder import GoldenParams, decode_golden, syndrome_ok  # noqa: F401

__all__ = ["GoldenParams", "decode_golden", "decode_oracle", "syndrome_ok"]


def decode_oracle(code, llr_batch, params: GoldenParams = GoldenParams()):
    """Batched golden decode [B, N] -> (bits [B, N] int8, iters_used [B])."""
    from .native import decode_golden_native

    return decode_golden_native(code, np.asarray(llr_batch), params)

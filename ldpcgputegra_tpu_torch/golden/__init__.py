"""Golden (reference-semantics) fixed-point decoder oracle in NumPy: the
port's copy of ``ldpcgputegra_tpu/golden/``, without the native C++ bridge
(``golden/native.py``, ROADMAP queue 1 item 5)."""

from .decoder import GoldenParams, decode_golden, syndrome_ok  # noqa: F401

__all__ = ["GoldenParams", "decode_golden", "syndrome_ok"]

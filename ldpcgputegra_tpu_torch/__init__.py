"""ldpcgputegra_tpu_torch — the PyTorch + CUDA port of ldpcgputegra_tpu.

The JAX package ``ldpcgputegra_tpu`` is the reference; this package
mirrors its layout and names, imports torch and numpy, and never jax.

    from ldpcgputegra_tpu_torch import load_code, make_decoder, LayeredSpec
    code = load_code("1944x972")
    decode = make_decoder(code, LayeredSpec(algo="OMS", iters=10))
    bits, iters_used = decode(llr_int8)   # [B, N] int8 tensor -> bits

On a CUDA device the decode runs the hand-written kernel
(``csrc/layered_minsum.cu``, built with nvcc at first use); on the CPU it
runs the plain PyTorch version.
"""

__version__ = "0.1.0"

from .codes.registry import list_codes, load_code  # noqa: F401
from .decoder import LayeredSpec, make_decoder  # noqa: F401

__all__ = ["list_codes", "load_code", "LayeredSpec", "make_decoder"]

"""Hand-written CUDA kernels for Hopper — the hot decode path: the QC
kernel (``layered``) and the gather kernel for any layers (``gather``)."""

from .gather import make_gather_decoder
from .layered import cuda_supported, make_cuda_decoder

__all__ = ["make_cuda_decoder", "cuda_supported", "make_gather_decoder"]

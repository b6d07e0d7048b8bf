"""Hand-written CUDA kernels for Hopper — the hot decode path."""

from .layered import cuda_supported, make_cuda_decoder

__all__ = ["make_cuda_decoder", "cuda_supported"]

"""Hand-written CUDA kernels for Hopper — the hot decode path: the QC
kernel (``layered``), the gather kernel for any layers (``gather``) and the
kernel over committed edges for the QC views of the DVB-S2 codes and
synthqc (``streamed``)."""

from .gather import make_gather_decoder
from .layered import cuda_supported, make_cuda_decoder
from .streamed import make_streamed_decoder

__all__ = ["make_cuda_decoder", "cuda_supported", "make_gather_decoder",
           "make_streamed_decoder"]

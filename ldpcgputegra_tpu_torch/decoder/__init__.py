"""Decoder factory (the port's counterpart of
``ldpcgputegra_tpu/decoder/__init__.py``).

Backends:

* ``cuda`` — the hand-written QC kernel (``kernels/layered.py``): all-QC
  codes whose block-rows the schedule keeps;
* ``cuda-gather`` — the hand-written gather kernel (``kernels/gather.py``):
  the layers of any schedule, so the non-QC codes (4000x2000 ...);
* ``torch`` — the plain PyTorch layered decoder (``ops/layered.py``);
* ``auto`` — on a CUDA device ``cuda`` where the QC kernel takes the code,
  else ``cuda-gather``; ``torch`` on the CPU.  A code or spec neither
  kernel takes raises on a CUDA device: it is never sent to the plain
  version there.  Staircase (DVB-S2-family) codes raise on every device
  until their QC view is ported (ROADMAP queue 1 item 11).

All backends return ``decode(llr[B, N] int8) -> (bits[B, N] uint8,
iters_used)`` on tensors of the decoder's device.
"""

from __future__ import annotations

import torch

from ..codes.code import LdpcCode
from ..ops.layered import LayeredSpec, make_layered_decoder

__all__ = ["make_decoder", "LayeredSpec", "backend_for", "default_device"]


def default_device() -> torch.device:
    """The first CUDA device when there is one, else the CPU."""
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def backend_for(code: LdpcCode, spec: LayeredSpec, device=None,
                backend: str = "auto") -> str:
    """The backend ``make_decoder`` builds for this code, spec and device."""
    from ..kernels import gather, layered

    device = torch.device(device) if device is not None else default_device()
    if backend == "native":
        raise NotImplementedError(
            "backend='native' is not ported yet (ROADMAP queue 1 item 7)")
    if backend == "auto":
        if device.type != "cuda":
            return "torch"
        if layered.kernel_unsupported_reason(code, spec) is None:
            return "cuda"
        why = gather.kernel_unsupported_reason(code, spec)
        if why is not None:
            raise NotImplementedError(f"no CUDA kernel for this decode: {why}")
        return "cuda-gather"
    if backend in ("cuda", "cuda-gather", "torch"):
        return backend
    raise ValueError(f"unknown backend {backend!r}")


def make_decoder(
    code: LdpcCode,
    spec: LayeredSpec = LayeredSpec(),
    backend: str = "auto",
    device=None,
):
    """Build the decoder for ``code`` on ``device`` (default:
    ``default_device()``)."""
    device = torch.device(device) if device is not None else default_device()
    resolved = backend_for(code, spec, device, backend)
    if resolved == "cuda":
        from ..kernels import make_cuda_decoder

        return make_cuda_decoder(code, spec)
    if resolved == "cuda-gather":
        from ..kernels import make_gather_decoder

        return make_gather_decoder(code, spec)
    return make_layered_decoder(code, spec, device)

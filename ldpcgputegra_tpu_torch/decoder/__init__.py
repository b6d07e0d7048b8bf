"""Decoder factory (the port's counterpart of
``ldpcgputegra_tpu/decoder/__init__.py``).

Backends:

* ``cuda`` — the hand-written QC kernel (``kernels/layered.py``): all-QC
  codes whose block-rows the schedule keeps and whose 4-codeword APP tile
  fits shared memory;
* ``cuda-gather`` — the hand-written gather kernel (``kernels/gather.py``):
  the layers of any schedule, so the non-QC codes (4000x2000 ...);
* ``cuda-streamed`` — the hand-written kernel over committed edges
  (``kernels/streamed.py``), the APP in shared memory where a tile of it
  fits, else in device memory: the layers of any schedule, QC views
  included, so the QC views of the DVB-S2 family and synthqc;
* ``torch`` — the plain PyTorch layered decoder (``ops/layered.py``);
* ``torch-flooding`` — the flooding schedule (``ops/flooding.py``), plain
  PyTorch on any device and code, whatever the backend asked for: the JAX
  package decodes it in XLA, not in a Pallas kernel;
* ``auto`` — on a CUDA device ``cuda`` where the QC kernel takes the code,
  else ``cuda-gather`` where the gather kernel does, else
  ``cuda-streamed``; ``torch`` on the CPU.  A code or spec no kernel takes
  raises on a CUDA device: it is never sent to the plain version there.

Staircase (DVB-S2-family) codes are replaced by their Z=360 QC view
(``effective_code``), as in the JAX package; the view permutes columns
internally, so callers see the original column order.  The flooding
schedule decodes the original code (JAX ``decoder/__init__.py:134-142``).

All backends return ``decode(llr[B, N] int8) -> (bits[B, N] uint8,
iters_used)`` on tensors of the decoder's device.  With ``emit_mask`` they
return ``(bits, iters_used, ok[B] bool)``, ``ok`` true where the output
satisfies every check of the code the caller passed (the phase-1 output of
two-phase early termination, ``decoder/twophase.py``): ``cuda`` from the
QC kernel's own syndrome pass; the other backends from
``twophase.syndrome_fn`` on the original code, appended on the same stream
(``_with_mask``).  The JAX package computes that step in XLA, outside any
Pallas kernel, so its counterpart here is PyTorch operations on the device,
not a kernel.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..codes.code import LdpcCode
from ..ops.layered import LayeredSpec, make_layered_decoder

__all__ = ["make_decoder", "LayeredSpec", "backend_for", "default_device",
           "effective_code"]

_qc_view_cache: dict[str, Optional[LdpcCode]] = {}


def default_device() -> torch.device:
    """The CUDA device, the entry points' default: without a card this
    raises rather than run the plain version on the CPU unasked."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card by default; pass "
            "device='cpu' (--device cpu) to run the plain version on the CPU")
    return torch.device("cuda")


def effective_code(code: LdpcCode) -> LdpcCode:
    """The code actually decoded: the QC view for staircase codes."""
    if code.Z is not None or code.col_perm is not None:
        return code
    if code.name not in _qc_view_cache:
        from ..codes.dvbs2 import is_staircase, to_qc_form

        view = None
        if is_staircase(code):
            try:
                view = to_qc_form(code)
            except ValueError:
                view = None
        _qc_view_cache[code.name] = view
    return _qc_view_cache[code.name] or code


def backend_for(code: LdpcCode, spec: LayeredSpec, device=None,
                backend: str = "auto") -> str:
    """The backend ``make_decoder`` builds for this code (its QC view for
    a staircase code), spec and device."""
    from ..kernels import gather, layered, streamed

    device = torch.device(device) if device is not None else default_device()
    if backend == "native":
        raise NotImplementedError(
            "backend='native' is a host decoder, not a decoder factory "
            "backend (the JAX package's factory has none either): use "
            "run_sweep(SweepConfig(backend='native')) or "
            "golden.native.decode_simd_native")
    if spec.schedule == "flooding":
        return "torch-flooding"
    if backend == "auto":
        if device.type != "cuda":
            return "torch"
        code = effective_code(code)
        if layered.kernel_unsupported_reason(code, spec) is None:
            return "cuda"
        if gather.kernel_unsupported_reason(code, spec) is None:
            return "cuda-gather"
        why = streamed.kernel_unsupported_reason(code, spec)
        if why is not None:
            raise NotImplementedError(f"no CUDA kernel for this decode: {why}")
        return "cuda-streamed"
    if backend in ("cuda", "cuda-gather", "cuda-streamed", "torch"):
        return backend
    raise ValueError(f"unknown backend {backend!r}")


def make_decoder(
    code: LdpcCode,
    spec: LayeredSpec = LayeredSpec(),
    backend: str = "auto",
    device=None,
    emit_mask: bool = False,
):
    """Build the decoder for ``code`` (its QC view for a staircase code) on
    ``device`` (default: ``default_device()``); ``emit_mask`` adds the
    convergence mask (see the module's docstring)."""
    device = torch.device(device) if device is not None else default_device()
    resolved = backend_for(code, spec, device, backend)
    if resolved == "torch-flooding":
        from ..ops.flooding import make_flooding_decoder

        return _with_mask(make_flooding_decoder(code, spec, device), code,
                          emit_mask, device)
    orig_code, code = code, effective_code(code)
    if resolved == "cuda":
        from ..kernels import make_cuda_decoder

        return make_cuda_decoder(code, spec, emit_mask=emit_mask)
    if resolved == "cuda-gather":
        from ..kernels import make_gather_decoder

        dec = make_gather_decoder(code, spec)
    elif resolved == "cuda-streamed":
        from ..kernels import make_streamed_decoder

        dec = make_streamed_decoder(code, spec)
    else:
        dec = make_layered_decoder(code, spec, device)
    return _with_mask(dec, orig_code, emit_mask, device)


def _with_mask(dec, code: LdpcCode, emit_mask: bool, device):
    """Append the true syndrome of the output bits on ``code`` (the
    original code, in its own column order) to a ``(bits, iters)`` decoder:
    ``(bits, iters, ok[B])``, queued on the same stream, with no host
    read."""
    if not emit_mask:
        return dec
    from .twophase import syndrome_fn

    ok_fn = syndrome_fn(code, device)

    def dec_mask(llr):
        bits, iters = dec(llr)
        return bits, iters, ok_fn(bits)

    return dec_mask

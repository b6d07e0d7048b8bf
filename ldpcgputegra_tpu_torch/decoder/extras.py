"""Decoder extras (the port's counterpart of
``ldpcgputegra_tpu/decoder/extras.py``): a test double and the
heterogeneous host + device split.

* ``make_fake_decoder``: hard-decision passthrough, no message passing;
  the harness's test double (reference D14, ``CFakeDecoder.h:24-33``).
* ``make_hybrid_decoder``: each batch split between the device decoder and
  the host's native C++ oracle (``golden/native.py``), the analogue of the
  reference's ARM + GPU operation, where the NEON decoder routes a slice
  of the frames to an embedded GPU decoder
  (``CDecoder_OMS_fixed_NEON16_v2.cpp:106-116,288-327``).  The device
  slice is launched first, so on the card its kernel runs while the host
  decodes its slice.  The JAX package rounds the device slice to 128
  lanes, a TPU layout; here the split is exactly ``host_fraction``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..codes.code import LdpcCode
from ..ops.layered import LayeredSpec
from . import default_device, make_decoder

__all__ = ["make_fake_decoder", "make_hybrid_decoder"]


def make_fake_decoder(code: LdpcCode, device=None):
    """``decode(llr[B, N]) -> (bits = llr > 0, iters_used = 0)`` on
    ``device`` (default: the card)."""
    device = torch.device(device) if device is not None else default_device()

    def decode(llr):
        llr = torch.as_tensor(llr).to(device)
        if llr.dim() != 2 or llr.shape[1] != code.N:
            raise ValueError(f"llr must be [B, {code.N}], got "
                             f"{tuple(llr.shape)}")
        return ((llr > 0).to(torch.uint8),
                torch.zeros((), dtype=torch.int32, device=device))

    return decode


def make_hybrid_decoder(
    code: LdpcCode,
    spec: LayeredSpec = LayeredSpec(),
    host_fraction: float = 0.25,
    backend: str = "auto",
    device=None,
):
    """``decode(llr[B, N] int8) -> (bits[B, N] uint8, iters_used)`` on
    ``device`` (default: the card): the last ``int(B * host_fraction)``
    frames go through the host oracle (``golden.decode_oracle``), the rest
    through ``make_decoder(code, spec, backend, device)``.  ``iters_used``
    is the larger of the two slices' counts.

    The oracle decodes ``code``'s check table in order, so the two slices
    agree where that order is the device decoder's schedule (QC codes in
    the ``auto`` schedule), as in the JAX package.
    """
    from ..golden import GoldenParams, decode_oracle
    from ..golden.native import native_available

    if not 0.0 <= host_fraction <= 1.0:
        raise ValueError(f"host_fraction={host_fraction} is not in [0, 1]")
    native_available()  # build the oracle now: a failed build raises here
    device = torch.device(device) if device is not None else default_device()
    dev = make_decoder(code, spec, backend=backend, device=device)
    gp = GoldenParams(
        algo=spec.algo, iters=spec.iters, offset=spec.offset,
        nms_factor=spec.nms_f / 32.0, nms_factor2=spec.nms_f2 / 32.0,
        early_term=spec.early_term, minclamp=spec.minclamp,
        sat_var=spec.sat_var, sat_msg=spec.sat_msg,
    )

    def decode(llr):
        llr = torch.as_tensor(llr)
        b = llr.shape[0]
        nh = int(b * host_fraction)
        nd = b - nh
        # the host slice's copy before the device slice's launch, which on
        # the card is queued and not waited on while the host decodes
        host_llr = llr[nd:].cpu().numpy() if nh else None
        dev_out = dev(llr[:nd].to(device)) if nd else None
        if nh:
            host_bits, host_used = decode_oracle(code, host_llr, gp)
        parts, used = [], 0
        if dev_out is not None:
            parts.append(dev_out[0])
            used = int(dev_out[1])
        if nh:
            parts.append(torch.from_numpy(
                host_bits.view(np.uint8)).to(device))
            used = max(used, int(host_used.max()))
        return (torch.cat(parts) if len(parts) > 1 else parts[0],
                torch.tensor(used, dtype=torch.int32, device=device))

    return decode

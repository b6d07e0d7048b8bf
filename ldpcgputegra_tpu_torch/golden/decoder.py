"""NumPy golden model: scalar fixed-point layered min-sum decoding (the
port's copy of ``ldpcgputegra_tpu/golden/decoder.py``; NumPy only).

Re-implements, from its observable semantics, the reference's scalar oracle
``code/ldpc_decoder_arm/CDecoder/OMS/CDecoder_OMS_fixed_x86.cpp:60-150`` and
the GPU kernel family ``code/gpu_fixed/decoder_{ms,oms,nms,2nms}/cuda/*.cu``:

* horizontal layered (turbo) schedule: checks processed strictly in table
  order within each iteration, APP updated in place;
* 8-bit APP values saturated to SAT_VAR = +/-127, 6-bit messages saturated to
  SAT_MSG = +/-31 (``constantes_sse.h:43-49``);
* per check of degree d: contribution v_j = sat_var(app_j - msg_j); running
  two-min over |v| with sign (parity) accumulation; new message
  +/- f(min1, min2) with algorithm-specific f; APP_j = sat_var(v_j + msg'_j).

Algorithm variants (f and clamping follow the cited kernels exactly):
  MS    f1 = min(min2, 31),            f2 = min(min1, 31)
  OMS   f1 = min(max(min2-beta,0),31), f2 = min(max(min1-beta,0),31)
  NMS   f1 = trunc(0.75*min2),         f2 = trunc(0.75*min1)   (no 31-clamp,
         matching CUDA_NMS_SIMD.cu:73-85 where the clamp is commented out)
  2NMS  f1 = trunc(0.875*min2),        f2 = trunc(0.75*min1)

``minclamp='pre'`` reproduces the scalar x86 oracle, which clamps |v| to the
message range *before* the min reduction (``CDecoder_OMS_fixed_x86.cpp:94``:
``f_abs_fix(i_mesg_Saturate(vContr))``); ``'post'`` reproduces the GPU
kernels, which reduce over raw |v| (``CUDA_MS_SIMD.cu:168-170``).  The two
differ only when several contributions exceed the message saturation point.

This model is deliberately slow and explicit: it is the bit-exactness oracle
of the flooding decoder's oracle (``ops/flooding.py::flooding_golden``)
and of the encoders' tests (``syndrome_ok``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..codes.code import LdpcCode

SAT_VAR = 127
SAT_MSG = 31

__all__ = ["GoldenParams", "decode_golden", "syndrome_ok", "SAT_VAR", "SAT_MSG"]


@dataclasses.dataclass(frozen=True)
class GoldenParams:
    algo: str = "OMS"  # MS | OMS | NMS | 2NMS
    iters: int = 10
    offset: int = 1  # OMS beta
    # NMS factors; must be exact multiples of 1/32 (the reference's x86
    # fixed path is `-NMS <factor>` -> VECTOR_MUL + DIV32, main_p.cpp:293;
    # the accelerated paths and the native oracle compute (min*f*32)>>5)
    nms_factor: float = 0.75
    nms_factor2: float = 0.875  # 2NMS second factor
    early_term: bool = False
    minclamp: str = "pre"  # 'pre' = scalar x86 oracle, 'post' = GPU kernels
    # configurable quantization ranges (reference -var/-msg flags ->
    # setVarRange/setMsgRange, CDecoder_fixed.h:30-43)
    sat_var: int = SAT_VAR
    sat_msg: int = SAT_MSG


def _sat(v: int, s: int) -> int:
    return max(-s, min(s, v))


def _f_consts(min1: int, min2: int, p: GoldenParams) -> tuple[int, int]:
    if p.algo == "MS":
        return min(min2, p.sat_msg), min(min1, p.sat_msg)
    if p.algo == "OMS":
        return (
            min(max(min2 - p.offset, 0), p.sat_msg),
            min(max(min1 - p.offset, 0), p.sat_msg),
        )
    if p.algo == "NMS":
        return int(min2 * p.nms_factor), int(min1 * p.nms_factor)
    if p.algo == "2NMS":
        return int(min2 * p.nms_factor2), int(min1 * p.nms_factor)
    raise ValueError(f"unknown algo {p.algo!r}")


def decode_golden(
    code: LdpcCode,
    llr: np.ndarray,
    params: GoldenParams = GoldenParams(),
    return_final_parity: bool = False,
) -> tuple:
    """Decode one int8 LLR frame [N]; returns (hard bits [N], iters used).

    Sign convention follows the reference: negative LLR <=> bit 0, hard
    decision bit = (app > 0)  (``CDecoder_OMS_fixed_x86.cpp:199-201``).

    ``return_final_parity=True`` appends the LAST executed iteration's
    accumulated on-the-fly parity (the reference's EARLY_TERM convergence
    word, ``CUDA_MS_SIMD.cu:242-245``): 0 <=> converged.  NOTE: this
    extrinsic-sign criterion lags the hard decisions — the Pallas
    ``emit_mask`` output emits the TRUE syndrome of the output bits
    instead (see ``syndrome_ok``), which measured ~1 iteration less
    conservative on silicon.
    """
    assert llr.shape == (code.N,)
    sv, sm = params.sat_var, params.sat_msg
    v = llr.astype(np.int64).copy()
    msgs = [np.zeros_like(ci, dtype=np.int64) for ci in code.class_idx]
    it_used = params.iters
    ov_sign = 1
    for it in range(params.iters):
        ov_sign = 0
        for ci, mg in zip(code.class_idx, msgs):
            count, deg = ci.shape
            for c in range(count):
                contrib = np.empty(deg, dtype=np.int64)
                min1, min2 = sv + 1, sv + 1
                parity = 0
                for j in range(deg):
                    vc = _sat(int(v[ci[c, j]]) - int(mg[c, j]), sv)
                    contrib[j] = vc
                    a = abs(_sat(vc, sm)) if params.minclamp == "pre" else abs(vc)
                    if a < min1:
                        min2 = min1
                        min1 = a
                    elif a < min2:
                        min2 = a
                    parity ^= 1 if vc > 0 else 0
                f1, f2 = _f_consts(min1, min2, params)
                for j in range(deg):
                    vc = int(contrib[j])
                    a = abs(_sat(vc, sm)) if params.minclamp == "pre" else abs(vc)
                    mag = f1 if a == min1 else f2
                    s = parity ^ (1 if vc > 0 else 0)
                    m = mag if s == 1 else -mag
                    if params.minclamp == "pre":
                        m = _sat(m, sm)
                    mg[c, j] = m
                    v[ci[c, j]] = _sat(vc + m, sv)
                ov_sign |= parity
        if params.early_term and ov_sign == 0:
            it_used = it + 1
            break
    bits = (v > 0).astype(np.int8)
    if return_final_parity:
        return bits, it_used, ov_sign
    return bits, it_used


def syndrome_ok(code: LdpcCode, bits: np.ndarray) -> bool:
    """True if all parity checks are satisfied by the hard bits [N]."""
    for ci in code.class_idx:
        par = bits[ci].sum(axis=1) % 2
        if par.any():
            return False
    return True

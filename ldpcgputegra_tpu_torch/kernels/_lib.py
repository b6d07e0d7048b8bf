"""What the kernel wrappers share: building a ``csrc/`` source into a
shared library at first use, and checking a decoder's input.

A library is compiled with ``nvcc -gencode arch=compute_90a,code=sm_90a``
into a build directory (``ldpcgputegra_tpu_torch/_build/``, git-ignored),
from this checkout's sources only.  Its file name carries a hash of the
source and of every header in ``csrc/``, so an edited source or header is
rebuilt.  Nothing here needs nvcc or CUDA until ``build_library`` runs.
"""

from __future__ import annotations

import glob
import hashlib
import os
import shutil
import subprocess
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SMEM_MAX = 232448  # dynamic shared memory a block can use on Hopper
SM_SMEM = 233472  # shared memory of one SM, of which each CTA holds
CTA_SMEM_RESERVED = 1024  # this much more than it asks for
SM_THREADS = 2048  # resident threads an SM
SMS_H100 = 132  # an H100 SXM's SMs: the picks' count where no card is read
ALGO ={"MS": 0, "OMS": 1, "NMS": 2, "2NMS": 3}  # csrc/minsum_common.cuh

# Integer operations that one min-sum edge update needs, whichever kernel
# runs it (OMS with minclamp 'pre', csrc/minsum_common.cuh): the
# contribution (subtract, clamp: 3), its magnitude (clamp to sat_msg, |.|:
# 3), the two-min (3), the sign and parity (2), the message (min-edge
# compare and select 2, sign 3, clamp 2: 7) and the APP sum and clamp (3).
# Addressing, loads and stores are not counted, nor the per-check offset.
# chip_smoke.py's bound divides edge updates x this by the int32 rate.
OPS_PER_EDGE = 21


def ctas_per_sm(threads: int, smem: int, reg_ctas: int) -> int:
    """CTAs of ``threads`` threads and ``smem`` bytes of shared memory that
    one SM holds at once, where its registers allow ``reg_ctas`` (the
    kernel's launch bounds)."""
    return max(0, min(SM_THREADS // threads, reg_ctas,
                      SM_SMEM // (smem + CTA_SMEM_RESERVED)))


def sm_count(device) -> int:
    """The card's SM count."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return path


def build_library(source: str, build_dir: str) -> dict:
    """Compile ``source`` if this version of it has not been built yet.

    Returns ``{"path", "seconds", "log"}``; ``seconds`` is 0 and ``log``
    empty when the library was already there.
    """
    h = hashlib.sha1()
    for path in [source] + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(f.read())
    name = os.path.splitext(os.path.basename(source))[0]
    path = os.path.join(build_dir, f"{name}-{h.hexdigest()[:12]}.so")
    if os.path.exists(path):
        return {"path": path, "seconds": 0.0, "log": ""}
    nvcc = _nvcc()
    os.makedirs(build_dir, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
           "-I", CSRC, "-o", tmp, source]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
    os.replace(tmp, path)  # atomic: concurrent builds agree on one file
    return {"path": path, "seconds": seconds, "log": res.stdout + res.stderr}


def check_llr(llr, N: int) -> None:
    """Raise unless ``llr`` is a non-empty int8 ``[B, N]`` tensor on the CPU
    or on a CUDA device, contiguous when on the card."""
    if not isinstance(llr, torch.Tensor) or llr.dtype != torch.int8:
        raise TypeError("llr must be an int8 torch tensor")
    if llr.dim() != 2 or llr.shape[1] != N or llr.shape[0] == 0:
        raise ValueError(f"llr must be [B > 0, {N}], got {tuple(llr.shape)}")
    if llr.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {llr.device}")
    if llr.device.type == "cuda" and not llr.is_contiguous():
        raise ValueError("llr must be contiguous")

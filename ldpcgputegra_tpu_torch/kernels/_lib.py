"""What the kernel wrappers share: building a ``csrc/`` source into a
shared library at first use, checking a decoder's input, the cost
model by which the gather and streamed kernels pick a variant, and the
lookup by which each decoder computes its pick once a batch size and
card.

A library is compiled with ``nvcc -gencode arch=compute_90a,code=sm_90a``
into a build directory (``ldpcgputegra_tpu_torch/_build/``, git-ignored),
from this checkout's sources only.  Its file name carries a hash of the
source and of every header in ``csrc/``, so an edited source or header is
rebuilt.  Nothing here needs nvcc or CUDA until ``build_library`` runs.
``library_path`` and ``cached_build`` are that cache alone; the native
host library (``golden/native.py``) builds through them with g++.
"""

from __future__ import annotations

import glob
import hashlib
import os
import shutil
import subprocess
import time
from typing import Callable, Iterable, Sequence

import torch

from ..utils.profiling import span

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


def pick_by_rounds(variants: Iterable, B: int, sms: int,
                   shapes: Sequence[tuple], lanes: Callable,
                   per_sm: Callable, round_cost: Callable,
                   prefer: Callable):
    """The variant (a tuple with a ``tile``) of the least modelled time for
    a batch of ``B`` on a card of ``sms`` SMs; None when there is none.

    A layer of G checks of degree d takes r = ceil(G / lanes(v)) rounds of
    ``round_cost(v, d, busy)`` each, busy = resident x G / (r x lanes(v)):
    the CTAs an SM holds, resident = min(per_sm(v), ceil(CTAs / sms)),
    times the share of a round's lanes at work.  The CTAs, ceil(B / tile),
    run ceil(CTAs / (sms x per_sm(v))) waves after one another, and the
    time is waves x the rounds' sum.  Of equal times, the least
    ``prefer(v)``, then the first in ``variants``."""
    def cost(v):
        ctas = -(-B // v.tile)
        n = per_sm(v)
        waves = -(-ctas // (sms * n))
        resident = min(n, -(-ctas // sms))
        width = lanes(v)
        rounds = 0.0
        for G, d in shapes:
            r = -(-G // width)
            rounds += r * round_cost(v, d, resident * G / (r * width))
        return waves * rounds, prefer(v)

    return min(variants, key=cost, default=None)


def cached_pick(picks: dict, pick_tile: Callable, code, B: int, sms: int,
                *args):
    """``pick_tile(code, B, sms, *args)``, computed once a key ``(pick_tile,
    B, sms)`` and kept in ``picks``, one decoder's dict (its code and
    ``args`` fixed), for the calls after it.  The caller passes the
    module's ``pick_tile`` as it reads at the call, so a pick forced by
    replacing it (``bench/tiles.py``) is a key of its own, served only
    while the replacement is in place.  Inside the span
    ``ldpc.decode.pick``, whose count is 1 where the pick was computed and
    0 where it was looked up."""
    key = (pick_tile, B, sms)
    with span("decode.pick", count=0) as sp:
        if key not in picks:
            sp.count = 1
            picks[key] = pick_tile(code, B, sms, *args)
        return picks[key]


def sm_count(device) -> int:
    """The card's SM count."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return path


def library_path(name: str, files: Sequence[str], key: Sequence[str],
                 build_dir: str) -> str:
    """Where the build of ``files`` under ``key`` (strings such as flags
    that the library also depends on) goes: ``{name}-{hash}.so`` in
    ``build_dir``, so another version of either is another file."""
    h = hashlib.sha1()
    for k in key:
        h.update(k.encode() + b"\0")
    for path in files:
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(build_dir, f"{name}-{h.hexdigest()[:12]}.so")


def cached_build(path: str, compile_to: Callable[[str], str]) -> dict:
    """Build the library at ``path`` unless it is there: ``compile_to(out)``
    writes it to the temporary ``out`` and returns the compiler's log (it
    raises ``RuntimeError`` with that log when a step fails), and ``out``
    then replaces ``path`` at once, so concurrent builds agree on one file.
    A failed build leaves no build directory that it made.

    Returns ``{"path", "seconds", "log"}``; ``seconds`` is 0 and ``log``
    empty when the library was already there.
    """
    if os.path.exists(path):
        return {"path": path, "seconds": 0.0, "log": ""}
    build_dir = os.path.dirname(path)
    made = not os.path.isdir(build_dir)
    os.makedirs(build_dir, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    try:
        log = compile_to(tmp)
    except BaseException:
        if made and not os.listdir(build_dir):
            os.rmdir(build_dir)
        raise
    seconds = time.perf_counter() - t0
    os.replace(tmp, path)
    return {"path": path, "seconds": seconds, "log": log}


def build_library(source: str, build_dir: str,
                  defines: Sequence[str] = ()) -> dict:
    """Compile ``source`` with the nvcc flags ``defines`` (``-DNAME=VALUE``)
    if this version of it, of the ``csrc/`` headers and of ``defines`` has
    not been built yet (``cached_build``'s result)."""
    files = [source] + sorted(glob.glob(os.path.join(CSRC, "*.cuh")))
    name = os.path.splitext(os.path.basename(source))[0]

    def compile_to(out: str) -> str:
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-I", CSRC, *defines, "-o", out, source]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
        return res.stdout + res.stderr

    return cached_build(library_path(name, files, defines, build_dir),
                        compile_to)


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

"""What the kernel wrappers share: building a ``csrc/`` source into a
shared library at first use and loading it (``load``), checking a
decoder's input, the cost model by which the gather and streamed kernels
pick a variant, the lookup by which each decoder computes its pick once a
batch size and card, and the body of a decode call (``make_decode``).

A library is compiled with ``nvcc -gencode arch=compute_90a,code=sm_90a``
into a build directory (``ldpcgputegra_tpu_torch/_build/``, git-ignored),
from this checkout's sources only.  Its file name carries a hash of the
source, of every header in ``csrc/`` and of its ``-D`` flags, so an edited
source or header is rebuilt.  Nothing here needs nvcc or CUDA until
``build_library`` runs.  ``library_path`` and ``cached_build`` are that
cache alone; the native host library (``golden/native.py``) builds through
them with g++.

Every decode kernel (K1 ``layered_minsum``, K2 ``streamed_minsum``, the
gather kernel ``gather_minsum``) is built one library a (algorithm,
minclamp) pair (``PAIRS``, ``defines``): its source compiles that pair's
check-node arithmetic alone, and its C entry refuses any other pair.  A
decoder loads its spec's pair (``pair``) at its first call on the card.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import time
from typing import Callable, Iterable, Optional, Sequence

import torch

from ..ops.layered import make_layered_decoder
from ..utils.profiling import span

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SMEM_MAX = 232448  # dynamic shared memory a block can use on Hopper
SM_SMEM = 233472  # shared memory of one SM, of which each CTA holds
CTA_SMEM_RESERVED = 1024  # this much more than it asks for
SM_THREADS = 2048  # resident threads an SM
SMS_H100 = 132  # an H100 SXM's SMs: the picks' count where no card is read
ALGO = {"MS": 0, "OMS": 1, "NMS": 2, "2NMS": 3}  # csrc/minsum_common.cuh
# the (algorithm, minclamp) pairs, one library each for every decode kernel
PAIRS = tuple((a, m) for a in ALGO for m in ("pre", "post"))
DMAXES = (8, 16, 32)  # the decode kernels' unrolled contribution arrays

# Integer operations that one min-sum edge update needs, whichever kernel
# runs it (OMS with minclamp 'pre', csrc/minsum_common.cuh): the
# contribution (subtract, clamp: 3), its magnitude (clamp to sat_msg, |.|:
# 3), the two-min (3), the sign and parity (2), the message (min-edge
# compare and select 2, sign 3, clamp 2: 7) and the APP sum and clamp (3).
# Addressing, loads and stores are not counted, nor the per-check offset.
# chip_smoke.py's bound divides edge updates x this by the int32 rate.
OPS_PER_EDGE = 21


def pair(spec) -> tuple[str, str]:
    """The (algorithm, minclamp) pair whose library decodes ``spec``: the
    kernels read any minclamp but 'pre' as 'post', as the plain version
    does."""
    return spec.algo, "pre" if spec.minclamp == "pre" else "post"


def defines(algo: str = "OMS", minclamp: str = "pre") -> list[str]:
    """The nvcc flags of a decode library of one (algorithm, minclamp)
    pair, which ``csrc/minsum_common.cuh`` requires: the source compiles
    that pair's check-node arithmetic alone."""
    if algo not in ALGO or minclamp not in ("pre", "post"):
        raise ValueError(f"no build for {algo!r} with minclamp {minclamp!r}")
    return [f"-DMINSUM_ALGO={ALGO[algo]}",
            f"-DMINSUM_PRE={int(minclamp == 'pre')}"]


def dmax(groups) -> int:
    """The smallest unrolled contribution array that holds the degree of
    every one of ``groups`` (a code's layers or degree classes); 0 when
    none does."""
    deg = max(g.deg for g in groups)
    return next((d for d in DMAXES if d >= deg), 0)


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


# the loaded libraries by (source, pair); pair None: built without defines
_loaded: dict[tuple[str, Optional[tuple[str, str]]], ctypes.CDLL] = {}


def load(source: str, functions: dict,
         pair: Optional[tuple[str, str]] = None) -> ctypes.CDLL:
    """The library of ``source``, built for ``pair`` (an (algorithm,
    minclamp); None for a source without one, the probes) and loaded at its
    first use, with ``argtypes`` and ``restype`` set from ``functions``
    (name -> (argtypes, restype)); kept for the calls after it."""
    key = (source, pair)
    if key not in _loaded:
        flags = defines(*pair) if pair is not None else ()
        lib = ctypes.CDLL(build_library(source, BUILD_DIR, flags)["path"])
        for name, (argtypes, restype) in functions.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = list(argtypes), restype
        _loaded[key] = lib
    return _loaded[key]


# the C entries' last arguments, the same in every decode kernel: algo,
# minclamp_pre, iters, early_term, offset, nms_f, nms_f2, sat_var, sat_msg,
# stream
SPEC_ARGTYPES = [ctypes.c_int] * 9 + [ctypes.c_void_p]


def decode_functions(name: str, argtypes: Sequence) -> dict:
    """The C functions of the decode kernel ``name`` for ``load``: its
    launch, whose arguments are ``argtypes`` then ``SPEC_ARGTYPES``, and
    its error string."""
    return {f"{name}_launch": ([*argtypes, *SPEC_ARGTYPES], ctypes.c_int),
            f"{name}_error_string": ([ctypes.c_int], ctypes.c_char_p)}


def make_decode(code, spec, name: str, argtypes: Sequence, launches: dict,
                tables: Callable, pick_tile: Callable[[], Callable],
                pick_args: tuple, launch: Callable,
                plain: Optional[Callable] = None) -> Callable:
    """``decode(llr[B, N] int8)``, the body of every decode kernel's
    wrapper: the kernel ``name`` (source ``csrc/{name}.cu``, C entries
    ``{name}_launch`` and ``{name}_error_string``) on a CUDA tensor, the
    plain version on a CPU tensor, built on the first such call
    (``plain()``, by default ``ops/layered.py::make_layered_decoder``).

    ``llr`` is checked (``check_llr``), and the call records the span
    ``ldpc.decode`` (its frames).  On the card: ``tables(device)`` and the
    SM count are read once a card; the variant is ``cached_pick`` of
    ``pick_tile()``, the module's ``pick_tile`` as it reads at the call (a
    replacement, as ``bench/tiles.py`` forces a variant, is a key of its
    own), with ``pick_args`` after (code, B, sms); ``launch(t, llr, v)``
    allocates the outputs and scratch and returns (the C entry's arguments
    before the spec's, the outputs).  The entry of ``pair(spec)``'s library
    then runs on PyTorch's current stream, with no host synchronisation;
    an error it returns raises ``RuntimeError``, and ``launches[name]``
    counts each launch.  Returns the outputs."""
    spec_args = (ALGO[spec.algo], int(spec.minclamp == "pre"), spec.iters,
                 int(spec.early_term), spec.offset, spec.nms_f, spec.nms_f2,
                 spec.sat_var, spec.sat_msg)
    # the tables and the SM count, read on the first call per card
    per_card: dict[torch.device, tuple[dict, int]] = {}
    # the picks by (pick_tile, B, SMs) (cached_pick)
    picks: dict[tuple, object] = {}

    @functools.cache
    def on_cpu():
        return plain() if plain else make_layered_decoder(code, spec, "cpu")

    @functools.cache
    def entries():
        lib = load(os.path.join(CSRC, f"{name}.cu"),
                   decode_functions(name, argtypes), pair(spec))
        return (getattr(lib, f"{name}_launch"),
                getattr(lib, f"{name}_error_string"))

    def decode(llr: torch.Tensor):
        check_llr(llr, code.N)
        with span("decode", count=llr.shape[0]):
            if llr.device.type == "cpu":
                return on_cpu()(llr)
            entry, error_string = entries()
            dev = llr.device
            if dev not in per_card:
                per_card[dev] = (tables(dev), sm_count(dev))
            t, sms = per_card[dev]
            v = cached_pick(picks, pick_tile(), code, llr.shape[0], sms,
                            *pick_args)
            args, out = launch(t, llr, v)
            with torch.cuda.device(dev):
                stream = torch.cuda.current_stream(dev).cuda_stream
                err = entry(*args, *spec_args, stream)
            if err != 0:
                msg = error_string(err).decode()
                raise RuntimeError(f"{name} launch failed: {msg} ({err})")
            launches[name] += 1
            return out

    return decode


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

"""ctypes bridge to the native host library (the port's counterpart of
``ldpcgputegra_tpu/golden/native.py``): the scalar C++ oracle, the
AVX-512BW decoder and the Philox AWGN channel.

The library is built at first use from the port's own copies of the
sources (``native/oracle.cpp``, ``native/simd_decoder.cpp``,
``native/awgn.cpp``) with the JAX package's flags (``native/Makefile``
there): ``g++ -O3 -fPIC -std=c++17 -march=native -fopenmp``, ``awgn.cpp``
also with ``-ffast-math``, linked with ``-lmvec -lm``.  It goes into
``_build/`` (git-ignored) under a name that carries a hash of the sources,
the flags and what ``-march=native`` resolves to on this host, so an edited
source is rebuilt, and so is a build directory carried to a host with
another instruction set.  A failed build raises with the compiler's
output: there is no NumPy fallback.  ``decode_golden_native`` is bit for
bit ``golden/decoder.py::decode_golden``; ``decode_simd_native`` is the
same decode on 64 frames a vector where the host has AVX-512BW.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Optional

import numpy as np

from ..codes.code import LdpcCode
from ..kernels import _lib as kernel_lib
from .decoder import GoldenParams

__all__ = [
    "native_available",
    "decode_golden_native",
    "syndrome_ok_native",
    "encode_accumulate_native",
    "simd_available",
    "decode_simd_native",
    "awgn_quantize_native",
    "build",
    "library_path",
    "host_target",
]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.join(_PKG, "native")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("oracle.cpp", "simd_decoder.cpp", "awgn.cpp")
CXXFLAGS = ["-O3", "-Wall", "-fPIC", "-std=c++17", "-march=native",
            "-fopenmp"]
_ALGO_IDS = {"MS": 0, "OMS": 1, "NMS": 2, "2NMS": 3}

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def _cxx() -> str:
    # g++ from PATH, not $CXX: a CXX set for another toolchain (such as a
    # compiler wrapper without libgomp's spec file) may not link OpenMP
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH: the native library needs "
                           "it")
    return cxx


_targets: dict = {}


def host_target(cxx: str) -> str:
    """The target options that ``-march=native`` turns on here, as ``cxx``
    lists them (``-Q --help=target``)."""
    if cxx not in _targets:
        cmd = [cxx, "-march=native", "-Q", "--help=target"]
        res = subprocess.run(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"native build failed ({res.returncode}): "
                               f"{' '.join(cmd)}\n{res.stdout}")
        _targets[cxx] = res.stdout
    return _targets[cxx]


def library_path(build_dir: Optional[str] = None) -> str:
    """Where this version of the sources, built for this host, goes."""
    return kernel_lib.library_path(
        "liboracle", [os.path.join(NATIVE_DIR, n) for n in SOURCES],
        [*CXXFLAGS, host_target(_cxx())], build_dir or BUILD_DIR)


def build(build_dir: Optional[str] = None) -> dict:
    """Compile the library if this version of its sources has not been
    built for this host yet (``kernels/_lib.py::cached_build``'s result).
    Raises ``RuntimeError`` with the compiler's output when a step fails."""
    cxx = _cxx()

    def compile_to(out: str) -> str:
        log = []
        with tempfile.TemporaryDirectory(dir=os.path.dirname(out)) as tmp:
            procs = []
            for name in SOURCES:
                extra = ["-ffast-math"] if name == "awgn.cpp" else []
                obj = os.path.join(tmp, name.replace(".cpp", ".o"))
                cmd = [cxx, *CXXFLAGS, *extra, "-c",
                       os.path.join(NATIVE_DIR, name), "-o", obj]
                procs.append((cmd, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)))
            for cmd, p in procs:
                log.append(p.communicate()[0])
                if p.returncode != 0:
                    raise RuntimeError(f"native build failed ({p.returncode})"
                                       f": {' '.join(cmd)}\n{log[-1]}")
            cmd = [cxx, "-shared", "-o", out, *(c[-1] for c, _ in procs),
                   "-lmvec", "-lm", "-fopenmp"]
            res = subprocess.run(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
            log.append(res.stdout)
            if res.returncode != 0:
                raise RuntimeError(f"native link failed ({res.returncode}): "
                                   f"{' '.join(cmd)}\n{res.stdout}")
        return "".join(log)

    return kernel_lib.cached_build(library_path(build_dir), compile_to)


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build()["path"])
        i32p = ctypes.POINTER(ctypes.c_int32)
        i8p = ctypes.POINTER(ctypes.c_int8)
        decode_args = [
            i32p, i32p, ctypes.c_int, i32p, ctypes.c_int,
            i8p, ctypes.c_int, ctypes.c_int, i8p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, i32p,
        ]
        lib.ldpc_decode_golden.argtypes = decode_args
        lib.ldpc_decode_golden.restype = None
        lib.ldpc_syndrome_ok.argtypes = [
            i32p, i32p, ctypes.c_int, i32p, i8p,
            ctypes.c_int, ctypes.c_int, i8p,
        ]
        lib.ldpc_syndrome_ok.restype = ctypes.c_int
        lib.ldpc_encode_accumulate.argtypes = [
            i32p, i32p, ctypes.c_int64, i8p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, i8p, ctypes.c_int,
        ]
        lib.ldpc_encode_accumulate.restype = None
        lib.ldpc_simd_lanes.argtypes = []
        lib.ldpc_simd_lanes.restype = ctypes.c_int
        lib.ldpc_decode_simd.argtypes = decode_args
        lib.ldpc_decode_simd.restype = None
        lib.ldpc_awgn_quantize.argtypes = [
            ctypes.c_uint64, ctypes.c_uint64, i8p,
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
            ctypes.c_float, ctypes.c_int, i8p,
        ]
        lib.ldpc_awgn_quantize.restype = None
        _lib = lib
        return _lib


def native_available() -> bool:
    """True once the library is built and loaded; a failed build raises."""
    return _load() is not None


def _code_arrays(code: LdpcCode):
    degs = np.asarray([c.deg for c in code.classes], np.int32)
    counts = np.asarray([c.count for c in code.classes], np.int32)
    edges = np.ascontiguousarray(code.edges, np.int32)
    return degs, counts, edges


def _p32(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _p8(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int8))


def _frames(llr, n: int) -> np.ndarray:
    llr = np.ascontiguousarray(llr, np.int8)
    if llr.ndim == 1:
        llr = llr[None, :]
    if llr.ndim != 2 or llr.shape[1] != n:
        raise ValueError(f"llr must be [B, {n}], got {llr.shape}")
    return llr


def _decode(fn, code: LdpcCode, llr: np.ndarray, params: GoldenParams,
            used: np.ndarray) -> np.ndarray:
    b, n = llr.shape
    degs, counts, edges = _code_arrays(code)
    out = np.empty((b, n), np.int8)
    fn(
        _p32(degs), _p32(counts), len(code.classes),
        _p32(edges), edges.size,
        _p8(llr), b, n, _p8(out),
        _ALGO_IDS[params.algo], params.iters, params.offset,
        1 if params.minclamp == "pre" else 0,
        1 if params.early_term else 0,
        params.sat_var, params.sat_msg,
        # the factors are /32-exact by contract (GoldenParams); the library
        # computes (min * f32) >> 5
        int(round(params.nms_factor * 32)),
        int(round(params.nms_factor2 * 32)),
        _p32(used),
    )
    return out


def decode_golden_native(
    code: LdpcCode,
    llr: np.ndarray,
    params: GoldenParams = GoldenParams(),
) -> tuple[np.ndarray, np.ndarray]:
    """Batched golden decode: llr [B, N] int8 -> (bits [B, N] int8,
    iters_used [B] int32)."""
    lib = _load()
    llr = _frames(llr, code.N)
    used = np.empty(llr.shape[0], np.int32)
    return _decode(lib.ldpc_decode_golden, code, llr, params, used), used


def encode_accumulate_native(
    scatter_pos: np.ndarray,
    scatter_bit: np.ndarray,
    info: np.ndarray,
    n: int,
    k: int,
) -> np.ndarray:
    """Batched accumulate+staircase encode: info [B, K] -> codewords [B, N]."""
    lib = _load()
    pos = np.ascontiguousarray(scatter_pos, np.int32)
    bit = np.ascontiguousarray(scatter_bit, np.int32)
    info = np.ascontiguousarray(info, np.int8)
    if info.ndim != 2 or info.shape[1] != k:
        raise ValueError(f"info must be [B, {k}], got {info.shape}")
    b = info.shape[0]
    out = np.empty((b, n), np.int8)
    lib.ldpc_encode_accumulate(
        _p32(pos), _p32(bit), pos.size, _p8(info), b, k, n - k, _p8(out), n
    )
    return out


def syndrome_ok_native(code: LdpcCode, bits: np.ndarray) -> np.ndarray:
    """Per-frame syndrome satisfaction for bits [B, N] -> bool [B]."""
    lib = _load()
    bits = _frames(bits, code.N)
    b, n = bits.shape
    degs, counts, edges = _code_arrays(code)
    ok = np.empty(b, np.int8)
    lib.ldpc_syndrome_ok(
        _p32(degs), _p32(counts), len(code.classes), _p32(edges),
        _p8(bits), b, n, _p8(ok),
    )
    return ok.astype(bool)


def simd_available() -> bool:
    """True when the library was built with AVX-512BW (64 lanes)."""
    return int(_load().ldpc_simd_lanes()) > 0


def decode_simd_native(
    code: LdpcCode,
    llr: np.ndarray,
    params: GoldenParams = GoldenParams(),
) -> tuple[np.ndarray, int]:
    """Batched AVX-512 decode: llr [B, N] int8 -> (bits [B, N] int8,
    iters_used int), 64 frames a vector, OpenMP over blocks of 64, each
    lane frozen at its own convergence; bit for bit ``decode_golden``."""
    lib = _load()
    if int(lib.ldpc_simd_lanes()) == 0:
        raise RuntimeError("the SIMD decoder needs a host with AVX-512BW; "
                           "this library was built without it")
    llr = _frames(llr, code.N)
    used = np.zeros(1, np.int32)
    return _decode(lib.ldpc_decode_simd, code, llr, params, used), int(used[0])


def awgn_quantize_native(
    seed: int,
    stream: int,
    frames: int,
    n: int,
    sigma: float,
    factor: float,
    sat: int = 31,
    coded: Optional[np.ndarray] = None,
    amp: float = 1.0,
) -> np.ndarray:
    """Counter-based Philox AWGN + BPSK/QPSK(amp) + truncating quantizer:
    int8 LLRs [frames, n], a pure function of (seed, stream, frame,
    position).  ``sigma`` and ``factor`` go to C as floats: pass the Python
    floats of ``channel.awgn.sigma_for_snr`` and the quantizer's factor, as
    the JAX package does, so the LLRs are the same byte for byte."""
    lib = _load()
    out = np.empty((frames, n), np.int8)
    if coded is not None:
        coded = np.ascontiguousarray(coded, np.int8)
        if coded.shape != (frames, n):
            raise ValueError(f"coded must be [{frames}, {n}], "
                             f"got {coded.shape}")
        cptr = _p8(coded)
    else:
        cptr = ctypes.POINTER(ctypes.c_int8)()
    lib.ldpc_awgn_quantize(
        ctypes.c_uint64(seed), ctypes.c_uint64(stream), cptr,
        frames, n, ctypes.c_float(amp), ctypes.c_float(sigma),
        ctypes.c_float(factor), int(sat), _p8(out),
    )
    return out

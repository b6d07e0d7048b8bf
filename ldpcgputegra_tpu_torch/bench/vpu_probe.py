"""Measured ceilings of the card for the roofline (the port's counterpart of
``ldpcgputegra_tpu/bench/vpu_probe.py``), with the hand-written CUDA probe
kernels of ``csrc/probes.cu``.

* ``probe_mix`` (K6, ``_mix_kernel``): ``chains`` independent chains of the
  decoder's 14-operation mix per element, ``reps`` repetitions; with
  ``packed`` the same mix on four int8 lanes of each int32 word, saturating
  (4 x 14 operations a repetition).
* ``probe_peak`` (K6, ``_peak_kernel``): ``chains`` clip-accumulate chains,
  3 operations a repetition.
* ``probe_copy`` (K7, ``_copy_fn``): ``y = x + 1`` over int32, streamed
  through device memory.

``measure_alu_rate`` sweeps CTAs an SM x chains and keeps the best rate of
the mix and of the peak, each from the slope over two repetition counts, so
launch and load costs cancel; ``measure_hbm_bw`` times the copy of 256 MiB
(five times the L2).  Both need a CUDA device and raise without one.

nvcc fuses and folds the algorithmic operations (``VIADDMNMX`` is an add
and a max), so the rates are in the probes' algorithmic operations and the
checks are in SASS instructions (``cuobjdump -sass``): a configuration
whose integer-ALU instructions issue faster than ``ALU_SANITY`` x SMs x 64
x the max SM clock lost work to the compiler, and raises.

Each wrapper runs its plain PyTorch version on a CPU tensor and launches its
kernel, or raises, on a CUDA tensor; ``launches`` counts the kernel launches
by name.  The library is compiled at first use (``kernels/_lib.py``);
importing this module needs neither nvcc nor CUDA.
"""

from __future__ import annotations

import ctypes
import os
import re
from typing import Optional

import numpy as np
import torch

from ..kernels import _lib
from .harness import measure_call
from .roofline import TABLE_HBM_BYTES_PER_S, hw_spec

__all__ = ["OPS_PER_REP", "PEAK_OPS_PER_REP", "MIX_CHAINS", "PEAK_CHAINS",
           "probe_mix", "probe_peak", "probe_copy", "mix_plain", "peak_plain",
           "copy_plain", "measure_alu_rate", "measure_hbm_bw", "slope_rate",
           "sweep_reps", "sass_per_rep", "sass_per_chain_rep",
           "parse_sass_loop", "alu_pipe", "check_issue_rate", "launches", "build", "SOURCE", "REPLACES"]

SOURCE = os.path.join(_lib.CSRC, "probes.cu")
BUILD_DIR = _lib.BUILD_DIR
REPLACES = {
    "probe_mix": "ldpcgputegra_tpu/bench/vpu_probe.py:67",  # _mix_kernel
    "probe_peak": "ldpcgputegra_tpu/bench/vpu_probe.py:44",  # _peak_kernel
    "probe_copy": "ldpcgputegra_tpu/bench/vpu_probe.py:210",  # _copy_fn
}

# Element operations per repetition, the JAX probe's algorithmic counts:
# the mix's sub, clip(2), abs, cmp, xor, max, min, min, cmp, select, add,
# clip(2); the peak's add, max, min.
OPS_PER_REP = 14
PEAK_OPS_PER_REP = 3
PACKED_LANES = 4  # int8 lanes of an int32 word

# the template instantiations of csrc/probes.cu
MIX_CHAINS = (1, 2, 4, 8, 16)
PEAK_CHAINS = (1, 2, 4, 8, 16, 32)
BLOCK = 256  # threads per CTA
UNROLL = 4  # repetitions per loop body

OPS_PER_CALL = 5e10  # about 3 ms at the H100's data-sheet int32 rate
HBM_SANITY = 1.05 * TABLE_HBM_BYTES_PER_S
ALU_SANITY = 1.05  # x the data sheet's integer-ALU instruction rate
COPY_MIB = 256  # five times the H100's 50 MB L2

# Kernel launches in this process, by kernel name: a wrapper adds one where
# it launches its kernel, and nowhere else.
launches = {"probe_mix": 0, "probe_peak": 0, "probe_copy": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
# the library's C functions: (argtypes, restype)
_FUNCTIONS = {
    "probe_mix_launch": ([_P, _P, _I, _I, _I, _I, _P], _I),
    "probe_peak_launch": ([_P, _P, _I, _I, _I, _P], _I),
    "probe_copy_launch": ([_P, _P, ctypes.c_longlong, _P], _I),
    "probes_error_string": ([_I], ctypes.c_char_p),
}


def build() -> dict:
    """Compile the probe library if this source has not been built yet;
    ``{"path", "seconds", "log"}`` (see ``_lib.build_library``)."""
    return _lib.build_library(SOURCE, BUILD_DIR)


def _library() -> ctypes.CDLL:
    return _lib.load(SOURCE, _FUNCTIONS)


def _check(x: torch.Tensor) -> None:
    if not isinstance(x, torch.Tensor) or x.dtype != torch.int32:
        raise TypeError("x must be an int32 torch tensor")
    if x.dim() != 1 or x.numel() == 0:
        raise ValueError(f"x must be 1-D and non-empty, got {tuple(x.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {x.device}")
    if x.device.type == "cuda" and not x.is_contiguous():
        raise ValueError("x must be contiguous")


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        msg = _library().probes_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: {msg} ({err})")


# ---------------------------------------------------------------- plain --

def mix_plain(x: torch.Tensor, chains: int, reps: int,
              packed: bool = False) -> torch.Tensor:
    """The mix probe in PyTorch: for each element, ``chains`` chains of
    ``reps`` repetitions, reduced as ``acc + v + p + mn`` per chain."""
    if packed:
        return _mix4_plain(x, chains, reps)
    lane = torch.arange(chains, dtype=torch.int32, device=x.device)[:, None]
    v = x[None, :] + lane
    m = 3 + lane
    p = torch.zeros_like(v)
    mn = torch.full_like(v, 128)
    for _ in range(reps):
        c = torch.clamp(v - m, -127, 127)
        a = c.abs()
        p = p ^ (c > 0).to(torch.int32)
        mn2 = torch.clamp(torch.maximum(a, mn), max=31)
        mn3 = torch.minimum(mn2, a)
        mag = torch.where(a == mn3, mn2, mn3)
        v = torch.clamp(c + mag, -127, 127)
        mn = mn3
    return (v + p + mn).sum(0, dtype=torch.int32)


def _mix4_plain(x: torch.Tensor, chains: int, reps: int) -> torch.Tensor:
    """The packed mix: each int8 lane of each word in int16, saturating as
    the ``__v*4`` intrinsics do; the packed words summed as 32-bit
    integers."""
    def sat(t):
        return torch.clamp(t, -128, 127)

    b = x.contiguous().view(torch.int8).view(-1, PACKED_LANES).to(torch.int16)
    lane = torch.arange(chains, dtype=torch.int16, device=x.device)[:, None, None]
    v = sat(b[None] + lane)
    m = 3 + lane
    p = torch.zeros_like(v)
    mn = torch.full_like(v, 127)
    for _ in range(reps):
        c = torch.clamp(sat(v - m), -127, 127)
        a = torch.clamp(c.abs(), max=127)
        p = p ^ torch.where(c > 0, -1, 0).to(torch.int16)
        mn2 = torch.clamp(torch.maximum(a, mn), max=31)
        mn3 = torch.minimum(mn2, a)
        mag = torch.where(a == mn3, mn2, mn3)
        v = torch.clamp(sat(c + mag), -127, 127)
        mn = mn3
    total = torch.zeros(b.shape[0], dtype=torch.int64, device=x.device)
    shift = torch.tensor([0, 8, 16, 24], dtype=torch.int64, device=x.device)
    for t in (v, p, mn):
        words = ((t.to(torch.int64) & 0xFF) << shift).sum(-1)  # [chains, n]
        total = total + words.sum(0)
    total = ((total + 2**31) % 2**32) - 2**31  # wrap to int32
    return total.to(torch.int32)


def peak_plain(x: torch.Tensor, chains: int, reps: int) -> torch.Tensor:
    """The peak probe in PyTorch: ``chains`` clip-accumulate chains per
    element, summed."""
    lane = torch.arange(chains, dtype=torch.int32, device=x.device)[:, None]
    a = x[None, :] + lane
    for _ in range(reps):
        a = torch.clamp(a + 3, -127, 127)
    return a.sum(0, dtype=torch.int32)


def copy_plain(x: torch.Tensor) -> torch.Tensor:
    """The copy probe in PyTorch."""
    return x + 1


# -------------------------------------------------------------- kernels --

def probe_mix(x: torch.Tensor, chains: int, reps: int,
              packed: bool = False) -> torch.Tensor:
    """One element a thread, ``chains`` chains of the mix, ``reps``
    repetitions; int32 ``[n]`` out."""
    _check(x)
    if chains not in MIX_CHAINS:
        raise ValueError(f"chains must be one of {MIX_CHAINS}, got {chains}")
    if reps < 0:
        raise ValueError("reps must be >= 0")
    if x.device.type == "cpu":
        return mix_plain(x, chains, reps, packed)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _library().probe_mix_launch(x.data_ptr(), out.data_ptr(),
                                          x.numel(), chains, reps,
                                          int(packed), stream)
    _raise_on(err, "probe_mix")
    launches["probe_mix"] += 1
    return out


def probe_peak(x: torch.Tensor, chains: int, reps: int) -> torch.Tensor:
    """One element a thread, ``chains`` clip-accumulate chains, ``reps``
    repetitions; int32 ``[n]`` out."""
    _check(x)
    if chains not in PEAK_CHAINS:
        raise ValueError(f"chains must be one of {PEAK_CHAINS}, got {chains}")
    if reps < 0:
        raise ValueError("reps must be >= 0")
    if x.device.type == "cpu":
        return peak_plain(x, chains, reps)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _library().probe_peak_launch(x.data_ptr(), out.data_ptr(),
                                           x.numel(), chains, reps, stream)
    _raise_on(err, "probe_peak")
    launches["probe_peak"] += 1
    return out


def probe_copy(x: torch.Tensor) -> torch.Tensor:
    """``x + 1`` through device memory; int32 ``[n]`` out.  On the card x
    must start on a 16-byte boundary."""
    _check(x)
    if x.device.type == "cpu":
        return copy_plain(x)
    if x.data_ptr() % 16:
        raise ValueError("x must start on a 16-byte boundary")
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _library().probe_copy_launch(x.data_ptr(), out.data_ptr(),
                                           x.numel(), stream)
    _raise_on(err, "probe_copy")
    launches["probe_copy"] += 1
    return out


# ----------------------------------------------------------- the sweeps --

def _card(device) -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError("the probes measure the card: no CUDA device")
    return torch.device(device if device is not None else "cuda")


def _inputs(n: int, dev, seed: int, low: int = -31, high: int = 32):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.integers(low, high, n, dtype=np.int32)).to(dev)
            for _ in range(4)]


def slope_rate(fn, inputs, ops_per_rep_call: float, r_small: int,
               r_large: int) -> tuple[Optional[float], int, int]:
    """Operations per second of ``fn(x, reps)`` from the slope between two
    repetition counts, or None when no trustworthy slope emerged.

    The difference must exceed both half the small call's time and 2 ms
    (the JAX probe's rule); otherwise the repetitions are quadrupled, up to
    four times.  Returns ``(rate, r_small, r_large)`` as last timed."""
    for _ in range(4):
        t_small = measure_call(lambda x: fn(x, r_small), inputs, k_small=2,
                               k_large=8)
        t_large = measure_call(lambda x: fn(x, r_large), inputs, k_small=2,
                               k_large=8)
        dt = t_large - t_small
        if dt > max(0.5 * t_small, 2e-3):
            return ops_per_rep_call * (r_large - r_small) / dt, r_small, r_large
        r_small, r_large = r_small * 4, r_large * 4
    return None, r_small, r_large


def sweep_reps(per_rep_call: float) -> tuple[int, int]:
    """(r_small, r_large): r_large carries about ``OPS_PER_CALL``
    operations, r_small an eighth of it."""
    r_large = max(16, int(OPS_PER_CALL / per_rep_call))
    return max(2, r_large // 8), r_large


def check_issue_rate(instr_rate: float, issue_rate: float, tag: str) -> None:
    """Raise if integer-ALU instructions issued faster than ``ALU_SANITY``
    x ``issue_rate`` (SMs x 64 x the max SM clock): nvcc folded work."""
    if instr_rate > ALU_SANITY * issue_rate:
        raise RuntimeError(
            f"alu probe {tag}: {instr_rate / 1e12:.4f} T ALU instructions/s "
            f"is above {ALU_SANITY} x the card's {issue_rate / 1e12:.4f}: "
            "the compiler dropped work")


def measure_alu_rate(device=None, packed: bool = False) -> dict:
    """The best sustained rates, in the probes' algorithmic operations per
    second, over blocks of 256 threads at 1, 2, 4 and 8 CTAs an SM x the
    chain counts: ``"mix"`` at 1-16 chains and ``"peak"`` at 8-32
    (``packed``: the int8x4 mix alone, four operations a lane), and
    ``"instructions"``, the best integer-ALU instruction rate any
    configuration issued (``sass_per_rep``).  Prints each configuration's
    rate beside its SASS instructions a repetition.  A configuration whose
    slope stays untrustworthy is printed and dropped; if all of a kind
    are, raises; one that issued above the card (``check_issue_rate``)
    raises."""
    dev = _card(device)
    hw = hw_spec(dev)
    sms = hw.sm_count
    sweeps = [("mix", c) for c in MIX_CHAINS]
    if not packed:
        sweeps += [("peak", c) for c in (8, 16, 32)]
    best = {kind: 0.0 for kind, _ in sweeps}
    best["instructions"] = 0.0
    for ctas in (1, 2, 4, 8):
        n = BLOCK * sms * ctas
        inputs = _inputs(n, dev, seed=ctas, **(
            dict(low=-2**31, high=2**31 - 1) if packed else {}))
        for kind, chains in sweeps:
            if kind == "peak":
                per_rep = PEAK_OPS_PER_REP

                def fn(x, r, c=chains):
                    return probe_peak(x, c, r)
            else:
                per_rep = OPS_PER_REP * (PACKED_LANES if packed else 1)

                def fn(x, r, c=chains):
                    return probe_mix(x, c, r, packed)
            per_call = per_rep * n * chains
            rate, r_small, r_large = slope_rate(fn, inputs, per_call,
                                                *sweep_reps(per_call))
            tag = f"{'int8x4 ' if packed else ''}{kind} {ctas} CTAs/SM x{chains}"
            if rate is None:
                print(f"(WW) alu probe {tag}: no trustworthy slope up to "
                      f"{r_large} reps, dropped", flush=True)
                continue
            sass = sass_per_rep("mix4" if packed and kind == "mix" else kind,
                                chains)
            instr_rate = rate / (per_rep * chains) * sass[1]
            print(f"(II) alu probe {tag}: {rate / 1e12:.4f} Tops/s "
                  f"(reps {r_small}/{r_large}, SASS {sass[0]:.2f} "
                  f"instructions a repetition, {sass[1]:.2f} on the integer "
                  f"ALU pipe: {instr_rate / 1e12:.4f} T ALU instructions/s)",
                  flush=True)
            check_issue_rate(instr_rate, hw.alu_rate, tag)
            best[kind] = max(best[kind], rate)
            best["instructions"] = max(best["instructions"], instr_rate)
    for kind, rate in best.items():
        if rate == 0.0:
            raise RuntimeError(f"alu probe: no {kind} configuration gave a "
                               "trustworthy slope")
    return best


def measure_hbm_bw(device=None) -> float:
    """Sustained device-memory bytes/s (read + write) of ``probe_copy`` on
    ``COPY_MIB`` MiB of int32.  The call count is escalated while the
    reading is above 1.05 x the data sheet's 3.35 TB/s; if it stays there,
    raises."""
    dev = _card(device)
    n = COPY_MIB << 18
    inputs = _inputs(n, dev, seed=1, low=-100, high=100)
    for ks, kl in ((4, 32), (8, 64), (16, 128)):
        sec = measure_call(probe_copy, inputs, k_small=ks, k_large=kl)
        bw = 2 * (COPY_MIB << 20) / sec
        if bw < HBM_SANITY:
            return bw
        print(f"(WW) hbm probe k={kl}: {bw:.4g} B/s is above the card "
              "(slope under the timer's noise); escalating the call count",
              flush=True)
    raise RuntimeError("hbm probe: the reading stayed above the card")


# ------------------------------------------------------------- the SASS --

_FUNC = re.compile(r"Function\s*:\s*(\S+)")
_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?);")
_BRA = re.compile(r"\bBRA\b.*?(0x[0-9a-f]+)")
_PRED = re.compile(r"^@!?U?P\w+\s+")


def parse_sass_loop(sass: str, symbol: str) -> Optional[list[str]]:
    """The opcodes of the largest backward-branch loop of the function
    whose mangled name contains ``symbol`` in ``cuobjdump -sass`` text
    (``NOP`` left out), or None when there is no such function or loop."""
    body = None
    for block in re.split(r"(?=\n\s*Function\s*:)", sass):
        m = _FUNC.search(block)
        if m and symbol in m.group(1):
            body = block
            break
    if body is None:
        return None
    instrs, best = [], None
    for line in body.splitlines():
        mi = _INSTR.search(line)
        if not mi:
            continue
        addr, text = int(mi.group(1), 16), mi.group(2).strip()
        op = _PRED.sub("", text).split()[0]
        if op == "NOP":
            continue
        instrs.append((addr, op))
        mb = _BRA.search(text)
        if mb and int(mb.group(1), 16) <= addr:
            target = int(mb.group(1), 16)
            loop = [o for a, o in instrs if target <= a <= addr]
            if best is None or len(loop) > len(best):
                best = loop
    return best


def alu_pipe(op: str) -> bool:
    """Whether an opcode issues on the integer ALU pipe: not the uniform
    datapath (``U*``), the FMA pipe (``IMAD*``), a plain ``VIADD`` or a
    branch.  nvcc moves adds to ``VIADD`` as it does to ``IMAD.IADD``:
    counted on the ALU pipe, the int8x4 mix (10 ``VIADD`` in 128.75
    instructions a repetition at 2 chains) would issue 1.063x SMs x 64 x
    the max clock on an H100, 0.98x without them (PERF.md §6); the
    fused ``VIADDMNMX`` stays, the peak is 1.000x with it."""
    return op.split(".")[0] != "VIADD" and not op.startswith(
        ("U", "IMAD", "BRA", "EXIT"))


_sass_text: Optional[str] = None


def sass_per_rep(kind: str, chains: int) -> tuple[float, float]:
    """SASS instructions per repetition of a probe kernel (``kind`` "mix",
    "mix4" or "peak") at ``chains``, all of them and those on the integer
    ALU pipe (``alu_pipe``): its unrolled loop body, loop control included,
    over ``UNROLL``.  Reads the built library with the toolkit's
    ``cuobjdump``; raises where it cannot."""
    global _sass_text
    if _sass_text is None:
        from .sass import sass_text

        _sass_text = sass_text(build()["path"])
    loop = parse_sass_loop(_sass_text, f"probe_{kind}_kernelILi{chains}E")
    if loop is None:
        raise RuntimeError(f"no loop in the SASS of probe_{kind} x{chains}")
    return len(loop) / UNROLL, sum(map(alu_pipe, loop)) / UNROLL


def sass_per_chain_rep(kind: str, chains: int) -> float:
    """Integer-ALU instructions that one repetition of one chain needs,
    without the loop control: the body's count at ``chains`` less its
    count at half as many, over the chains added (``chains`` >= 2).  The
    probe's work in the unit the card issues it."""
    if chains < 2:
        raise ValueError("needs two chain counts: chains >= 2")
    half = chains // 2
    return (sass_per_rep(kind, chains)[1]
            - sass_per_rep(kind, half)[1]) / (chains - half)

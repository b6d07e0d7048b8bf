"""What the decode kernels compile to: SASS instructions per edge update,
registers, stack and spills (``cuobjdump`` on the built libraries).

    python -m ldpcgputegra_tpu_torch.bench.sass [--root DIR]

A decode kernel's check loop is the largest loop of its function that
holds no barrier (``BAR``): the round of one check on one lane, between
two ``__syncthreads()`` of a layer.  Its own instructions over the edges
one pass updates (its unrolled edge slots, ``DMAX / k`` times the
codewords a thread packs; the code's degree where the edges run in loops
nested in it, as in a QC kernel with runtime edge loops), plus a nested
edge loop's body over its int8 accesses, is the count per edge update; the
second count keeps those on the integer-ALU pipe (``vpu_probe.alu_pipe``), the unit of the
probes' ceilings.  A static count: in the QC and streamed kernels the
check-node arithmetic of all four algorithms and both minclamp placements
sits in the loop (the gather kernel builds one pair each, and its
``gather_symbol`` names the pair), and an unrolled slot above the code's
degree is skipped at run time.  ``--root`` reads
another checkout's built libraries (``bench/ab.py`` builds them) beside
this one's.  Needs ``cuobjdump`` (the CUDA toolkit).
"""

from __future__ import annotations

import argparse
import glob
import os
import re
import shutil
import subprocess
import sys
from typing import Optional

from ..kernels import _lib
from .vpu_probe import _BRA, _FUNC, _INSTR, _PRED, alu_pipe

__all__ = ["sass_text", "resources", "per_edge", "report", "VARIANTS",
           "layered_symbol", "streamed_symbol", "gather_symbol"]

_RES = re.compile(r"Function\s+(\S+):\s*(.*)")

_cache: dict[str, str] = {}
_functions: dict[str, dict[str, list[tuple[int, str]]]] = {}


def _tool() -> str:
    return shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(_lib._nvcc()), "cuobjdump")


def sass_text(path: str) -> str:
    """``cuobjdump -sass`` of a built library."""
    if path not in _cache:
        res = subprocess.run([_tool(), "-sass", path], capture_output=True,
                             text=True)
        if res.returncode != 0:
            raise RuntimeError(f"cuobjdump failed: {res.stderr}")
        _cache[path] = res.stdout
    return _cache[path]


def resources(path: str) -> dict[str, dict[str, int]]:
    """Mangled function name -> {"REG", "STACK", "SHARED", "LOCAL", ...}
    (``cuobjdump -res-usage``)."""
    res = subprocess.run([_tool(), "-res-usage", path], capture_output=True,
                         text=True)
    if res.returncode != 0:
        raise RuntimeError(f"cuobjdump failed: {res.stderr}")
    out = {}
    for m in _RES.finditer(res.stdout):
        out[m.group(1)] = {k: int(v) for k, v in
                           re.findall(r"(\w+(?:\[\d+\])?):(\d+)", m.group(2))}
    return out


def _function(path: str, symbol: str) -> Optional[list[tuple[int, str]]]:
    """(address, instruction text) of the function in the library at
    ``path`` whose mangled name contains ``symbol``.  The library's SASS is
    split into functions once: the gather kernel's holds over a hundred."""
    if path not in _functions:
        _functions[path] = {}
        for block in re.split(r"(?=\n\s*Function\s*:)", sass_text(path)):
            m = _FUNC.search(block)
            if m:
                _functions[path][m.group(1)] = block
    for name, block in _functions[path].items():
        if symbol in name:
            return [(int(a, 16), t.strip()) for a, t in _INSTR.findall(block)]
    return None


def _op(text: str) -> str:
    return _PRED.sub("", text).split()[0]


def _loops(instrs: list[tuple[int, str]]) -> list[tuple[int, int]]:
    """(first, last address) of each loop: a branch back."""
    out = []
    for addr, text in instrs:
        mb = _BRA.search(text)
        if mb and int(mb.group(1), 16) <= addr:
            out.append((int(mb.group(1), 16), addr))
    return out


def _edge_ops(ops: list[str]) -> int:
    """The int8 message and APP accesses of a loop body: one an edge."""
    return sum(o.startswith(("LDG.E.S8", "LDG.E.U8", "STG.E.U8"))
               for o in ops)


def per_edge(path: str, symbol: str, edges: float) -> tuple[float, float]:
    """SASS instructions, all and on the integer-ALU pipe, per edge update
    of the kernel in ``path`` whose mangled name contains ``symbol``.

    The check loop is the largest loop without a barrier; ``edges`` edges
    share one pass of its own instructions (its unrolled edge slots, or the
    degree where the edges run in loops nested in it).  A nested edge loop
    (the compiler unrolls a runtime loop and adds remainder loops) counts
    its body over the int8 accesses in it, the largest of the loops that
    load and of those that store; ``NOP`` is not counted."""
    fn = _function(path, symbol)
    if fn is None:
        raise RuntimeError(f"no function {symbol} in {path}")
    ops = {a: _op(t) for a, t in fn if _op(t) != "NOP"}
    loops = _loops(fn)

    def body(lo, hi):
        return [ops[a] for a in ops if lo <= a <= hi]

    free = [(lo, hi) for lo, hi in loops
            if not any(o.startswith("BAR") for o in body(lo, hi))]
    if not free:
        raise RuntimeError(f"no barrier-free loop in {symbol}")
    lo, hi = max(free, key=lambda lh: len(body(*lh)))
    nested = [(a, b) for a, b in loops if lo <= a and b <= hi and (a, b) != (lo, hi)]
    inner = {x for a, b in nested for x in ops if a <= x <= b}
    outer = [ops[a] for a in ops if lo <= a <= hi and a not in inner]
    n_all = len(outer) / edges
    n_alu = sum(map(alu_pipe, outer)) / edges
    for stores in (False, True):
        group = [body(a, b) for a, b in nested
                 if any(o.startswith("STG") for o in body(a, b)) == stores
                 and _edge_ops(body(a, b))]
        if group:
            b = max(group, key=_edge_ops)
            n_all += len(b) / _edge_ops(b)
            n_alu += sum(map(alu_pipe, b)) / _edge_ops(b)
    return n_all, n_alu


def _libs(root: str) -> dict[str, str]:
    """Kernel name -> the newest built library of it under ``root``."""
    out = {}
    for name in ("layered_minsum", "streamed_minsum", "gather_minsum"):
        paths = glob.glob(os.path.join(root, "ldpcgputegra_tpu_torch",
                                       "_build", f"{name}-*.so"))
        if paths:
            out[name] = max(paths, key=os.path.getmtime)
    return out


# (kernel, mangled-name fragment, edges one pass of the check loop's own
# instructions updates, what it is): the variants the picks take on the
# main paths (2304x1152 B=8192 and 1944x972 B=1024; 64800x32400 B=512,
# 64800x6480-dvbs2 B=256, 16200x7560 B=1024 and synthqc B=256; the gather
# kernel's below), and the builds of an earlier design where another
# checkout is read (one QC kernel with runtime edge loops, a streamed kernel
# templated on the tile and DMAX only, a gather kernel with the algorithm
# chosen at run time)
VARIANTS = [
    ("layered_minsum", "kernelILi16ELi4ELi8EE", 32, "tile 16, 4 a thread"),
    ("layered_minsum", "kernelILi8ELi4ELi8EE", 32, "tile 8, 4 a thread"),
    # runtime edge loops: the degree, 7296 / 1152 at 2304x1152
    ("layered_minsum", "layered_minsum_kernelEN", 7296 / 1152,
     "tile 32, runtime edge loops"),
    ("streamed_minsum", "kernelILi1ELi8ELi1ELb1EE", 8,
     "shared-memory APP, tile 1, 1 lane a check, DMAX 8"),
    ("streamed_minsum", "kernelILi1ELi32ELi4ELb1EE", 8,
     "shared-memory APP, tile 1, 4 lanes a check, DMAX 32"),
    ("streamed_minsum", "kernelILi2ELi16ELi2ELb1EE", 8,
     "shared-memory APP, tile 2, 2 lanes a check, DMAX 16"),
    ("streamed_minsum", "kernelILi1ELi8ELi1ELb0EE", 8,
     "device-memory APP, tile 1, DMAX 8"),
    ("streamed_minsum", "kernelILi2ELi8EEEv", 8,
     "device-memory APP, tile 2, DMAX 8, one lane a check"),
    ("streamed_minsum", "kernelILi2ELi32EEEv", 32,
     "device-memory APP, tile 2, DMAX 32, one lane a check"),
    ("gather_minsum", "kernelILi8ELi8EEEv", 8, "tile 8, DMAX 8, runtime algorithm"),
    # OMS with minclamp 'pre' (ALGO 1, PRE true): the picks at 4000x2000
    # B=4096 and at B <= 1024 (20000x10000, phase 2), at 1200x600 and at
    # 2048x384 B=8192
    ("gather_minsum", "kernelILi16ELi2ELi8ELi1ELb1EE", 16,
     "tile 16, 4 a thread, 2 lanes a check, DMAX 8, OMS pre"),
    ("gather_minsum", "kernelILi4ELi2ELi8ELi1ELb1EE", 16,
     "tile 4, 4 a thread, 2 lanes a check, DMAX 8, OMS pre"),
    ("gather_minsum", "kernelILi32ELi4ELi16ELi1ELb1EE", 16,
     "tile 32, 4 a thread, 4 lanes a check, DMAX 16, OMS pre"),
    ("gather_minsum", "kernelILi32ELi4ELi32ELi1ELb1EE", 32,
     "tile 32, 4 a thread, 4 lanes a check, DMAX 32, OMS pre"),
]


def layered_symbol(code, tile: int) -> tuple[str, int]:
    """The mangled-name fragment of the QC kernel's build for ``code`` at
    ``tile``, and the edges one pass of its check loop updates."""
    from ..kernels import layered

    dmax, pack = layered._dmax(code), layered.pack(code)
    return f"kernelILi{tile}ELi{pack}ELi{dmax}EE", dmax * pack


def gather_symbol(code, v, algo: str = "OMS",
                  minclamp: str = "pre") -> tuple[str, int]:
    """The same for the gather kernel's variant ``v``, built for ``algo``
    and ``minclamp``: its check loop updates DMAX / k edges of four
    codewords."""
    from ..kernels import gather

    dmax = gather._dmax(code)
    return (f"kernelILi{v.tile}ELi{v.k}ELi{dmax}"
            f"ELi{_lib.ALGO[algo]}ELb{int(minclamp == 'pre')}EE",
            dmax // v.k * gather.W)


def streamed_symbol(code, v) -> tuple[str, int]:
    """The same for the streamed kernel's variant ``v``."""
    from ..kernels import streamed

    dmax = streamed._dmax(code)
    smem = int(v.placement == "smem")
    return f"kernelILi{v.tile}ELi{dmax}ELi{v.k}ELb{smem}EE", dmax // v.k


def report(root: str, log=print) -> dict:
    """Per edge update, registers, stack and local memory of each variant
    in ``VARIANTS`` found in the libraries built under ``root``."""
    out = {}
    for kernel, path in _libs(root).items():
        res = resources(path)
        for k, symbol, edges, what in VARIANTS:
            if k != kernel or _function(path, symbol) is None:
                continue
            n_all, n_alu = per_edge(path, symbol, edges)
            r = next((v for f, v in res.items() if symbol in f), {})
            out[(kernel, what)] = (n_all, n_alu, r)
            log(f"[sass] {kernel} {what}: {n_all:.2f} SASS instructions an "
                f"edge update, {n_alu:.2f} on the integer-ALU pipe; "
                f"registers {r.get('REG')}, stack {r.get('STACK')} B, local "
                f"{r.get('LOCAL')} B")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", action="append", default=[])
    args = ap.parse_args(argv)
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    for root in [here] + args.root:
        print(f"[sass] {os.path.relpath(root, here) if root != here else '.'}")
        report(root)
    return 0


if __name__ == "__main__":
    sys.exit(main())

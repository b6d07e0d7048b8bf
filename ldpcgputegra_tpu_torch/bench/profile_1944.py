"""The odd-Z profile on the card (the port's counterpart of
``tools/profile_1944.py``).

    python -m ldpcgputegra_tpu_torch.bench.profile_1944 [--out PATH]

1944x972 (Z=81) decodes slower per edge than its neighbours 576x288
(Z=24) and 2304x1152 (Z=96).  Two measurements separate the candidates:

* the roll probe ``probe_roll`` (K8, ``roll_microkernel``, hand-written in
  ``csrc/roll_probe.cu``): ns per rotation of an int32 [Z][256] slab along
  Z at Z in {24, 81, 88, 96}, in two index forms, "wrap" (compare and
  correct, as the QC kernel indexes) and "mod" (``%`` by a runtime Z), beside
  the shared-memory bound of a rotation;
* decode rows at OMS 10, ET off: 576x288, 2304x1152 and 1944x972 through
  the QC kernel (``cuda``, the JAX ``pallas``), 1944x972's own base matrix
  re-expanded at Z=88 and Z=96 (``z_twin``), and 1944x972 through the
  gather kernel (``cuda-gather``, the JAX ``pallas-gather``) and the plain
  decoder (``torch``, the JAX ``xla``).

Prints each row and writes a Markdown table to ``--out`` (default
``bench_results/PROFILE_1944.md``, git-ignored).  Needs a CUDA device:
without one it exits non-zero and writes nothing.

``probe_roll`` runs its plain PyTorch version on a CPU tensor and launches
its kernel, or raises, on a CUDA tensor; ``launches["probe_roll"]`` counts
the kernel launches.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys
from typing import Optional

import numpy as np
import torch

from ..channel.awgn import AwgnChannel
from ..codes.code import LdpcCode
from ..codes.registry import load_code, make_qc_code
from ..decoder import make_decoder
from ..kernels import _lib
from ..ops.layered import LayeredSpec
from .harness import measure_call, throughput_report
from .roofline import smi_query

__all__ = ["probe_roll", "roll_plain", "roll_shifts", "roll_ns",
           "roll_bound_ns", "decode_row", "decode_row_code", "z_twin", "main",
           "launches", "build", "SOURCE", "REPLACES", "ZS", "FORMS"]

SOURCE = os.path.join(_lib.CSRC, "roll_probe.cu")
BUILD_DIR = _lib.BUILD_DIR
REPLACES = "tools/profile_1944.py:51"  # roll_microkernel

TB = 256  # slab width (csrc/roll_probe.cu)
N_ROLLS = 512
ITERS = 10  # decode rows: OMS, ET off
ZS = (24, 81, 88, 96)
FORMS = ("wrap", "mod")
SMEM_BYTES_PER_CLOCK = 128  # shared-memory bandwidth of one SM
OUT = os.path.join("bench_results", "PROFILE_1944.md")

# the JAX profile's backends and their counterparts here
BACKENDS = {"pallas": "cuda", "pallas-gather": "cuda-gather", "xla": "torch"}

# Kernel launches in this process: the wrapper adds one where it launches
# the kernel, and nowhere else.
launches = {"probe_roll": 0}

_lib_handle: Optional[ctypes.CDLL] = None


def build() -> dict:
    """Compile the roll probe if this source has not been built yet;
    ``{"path", "seconds", "log"}`` (see ``_lib.build_library``)."""
    return _lib.build_library(SOURCE, BUILD_DIR)


def _library() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is None:
        lib = ctypes.CDLL(build()["path"])
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.probe_roll_launch.argtypes = [p, p, p, i, i, i, i, p]
        lib.probe_roll_launch.restype = i
        lib.roll_probe_error_string.argtypes = [i]
        lib.roll_probe_error_string.restype = ctypes.c_char_p
        _lib_handle = lib
    return _lib_handle


def roll_shifts(Z: int, n_rolls: int) -> list[int]:
    """The JAX probe's shifts: (7k) mod Z, or 1 where that is 0, for
    k = 1..n_rolls."""
    return [(7 * k) % Z or 1 for k in range(1, n_rolls + 1)]


def roll_smem_bytes(Z: int, n_rolls: int) -> int:
    """Dynamic shared memory of one CTA: two slabs and the shifts."""
    return 4 * (2 * Z * TB + n_rolls)


def roll_plain(x: torch.Tensor, n_rolls: int) -> torch.Tensor:
    """The roll chain in PyTorch: each slab of ``x`` [S, Z, W] rotated along
    Z by each shift (``np.roll``'s direction), +1 after each."""
    Z = x.shape[1]
    for s in roll_shifts(Z, n_rolls):
        x = torch.roll(x, s, dims=1) + 1
    return x


def probe_roll(x: torch.Tensor, n_rolls: int = N_ROLLS,
               form: str = "wrap") -> torch.Tensor:
    """``n_rolls`` dependent rotations of each int32 [Z, 256] slab of ``x``
    [S, Z, 256], one CTA a slab; ``form`` "wrap" or "mod" is the kernel's
    index form (the results agree)."""
    if not isinstance(x, torch.Tensor) or x.dtype != torch.int32:
        raise TypeError("x must be an int32 torch tensor")
    if x.dim() != 3 or x.shape[0] == 0 or x.shape[1] == 0 or x.shape[2] != TB:
        raise ValueError(f"x must be [S > 0, Z > 0, {TB}], got "
                         f"{tuple(x.shape)}")
    if form not in FORMS:
        raise ValueError(f"form must be one of {FORMS}, got {form!r}")
    if n_rolls < 1:
        raise ValueError("n_rolls must be >= 1")
    if x.device.type == "cpu":
        return roll_plain(x, n_rolls)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    S, Z = x.shape[0], x.shape[1]
    if roll_smem_bytes(Z, n_rolls) > _lib.SMEM_MAX:
        raise ValueError(f"Z={Z}, {n_rolls} rolls: "
                         f"{roll_smem_bytes(Z, n_rolls)} B of shared memory")
    shifts = torch.tensor(roll_shifts(Z, n_rolls), dtype=torch.int32,
                          device=x.device)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _library().probe_roll_launch(
            x.data_ptr(), out.data_ptr(), shifts.data_ptr(), Z, n_rolls, S,
            FORMS.index(form), stream)
    if err != 0:
        msg = _library().roll_probe_error_string(err).decode()
        raise RuntimeError(f"probe_roll launch failed: {msg} ({err})")
    launches["probe_roll"] += 1
    return out


def slabs(Z: int, dev, seed: int) -> torch.Tensor:
    """One random int32 [Z, 256] slab per SM of the card, from a numpy
    seed."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        rng.integers(-31, 31, (sms, Z, TB), dtype=np.int32)).to(dev)


def roll_ns(Z: int, form: str = "wrap", dev=None) -> float:
    """ns per rotation: the time of one call of ``N_ROLLS`` rotations
    (``measure_call``) over ``N_ROLLS``, every SM rolling its own slab."""
    dev = torch.device(dev if dev is not None else "cuda")
    inputs = [slabs(Z, dev, seed=i) for i in range(4)]
    sec = measure_call(lambda x: probe_roll(x, N_ROLLS, form), inputs,
                       k_small=4, k_large=20)
    return sec / N_ROLLS * 1e9


def roll_bound_ns(Z: int, clock_hz: float) -> float:
    """The shared-memory bound of one rotation: a slab read and a slab
    written (2 x Z x 256 x 4 bytes) on each SM at 128 bytes a clock."""
    return 2 * Z * TB * 4 / SMEM_BYTES_PER_CLOCK / clock_hz * 1e9


def decode_row_code(code: LdpcCode, backend: str, batch: int,
                    dev=None) -> dict:
    """ms per decode of ``batch`` frames at OMS 10, ET off, 2.0 dB,
    through ``backend`` (a JAX backend name maps to its counterpart), and
    the time per edge, iteration and frame."""
    dev = torch.device(dev if dev is not None else "cuda")
    backend = BACKENDS.get(backend, backend)
    spec = LayeredSpec(algo="OMS", iters=ITERS, early_term=False)
    dec = make_decoder(code, spec, backend=backend, device=dev)
    chan = AwgnChannel(code.N, code.K, device=dev)
    chan.configure(2.0)
    inputs = [chan.generate_zero_int8(chan.generator(50 + i), batch)
              for i in range(6)]
    sec = measure_call(dec, inputs, k_small=4, k_large=20)
    rep = throughput_report(sec, batch, code.N)
    row = {
        "code": code.name,
        "backend": backend,
        "batch": batch,
        "ms_per_call": rep["ms_per_call"],
        "coded_mbps": rep["coded_mbps"],
        "ps_per_edge_iter_frame": sec / (batch * code.M * ITERS) * 1e12,
    }
    print("(PERF) " + json.dumps(row), flush=True)
    return row


def decode_row(name: str, backend: str, batch: int, dev=None) -> dict:
    """``decode_row_code`` of a registry code."""
    return decode_row_code(load_code(name), backend, batch, dev)


def z_twin(Z2: int) -> LdpcCode:
    """1944x972's own base matrix (12 block-rows, 86 block-edges) expanded
    at ``Z2``: the same structure at another Z, which separates the cost of
    Z=81 from the cost of the code's structure."""
    code = load_code("1944x972")
    nb = code.N // code.Z
    base = np.full((len(code.layers), nb), -1, dtype=np.int64)
    for r, lay in enumerate(code.layers):
        for c, s in zip(np.asarray(lay.qc.cols), np.asarray(lay.qc.shifts)):
            base[r, int(c)] = int(s) % Z2
    return make_qc_code(f"1944twin-Z{Z2}", base, Z2)


def roll_table(dev, clock_hz: float) -> list[dict]:
    """ns per rotation at each Z in both forms, and the bound."""
    rows = []
    for Z in ZS:
        row = {"Z": Z, "bound_ns": roll_bound_ns(Z, clock_hz)}
        for form in FORMS:
            row[form] = roll_ns(Z, form, dev=dev)
        print(f"(PERF) roll Z={Z}: wrap {row['wrap']:.4f} ns, mod "
              f"{row['mod']:.4f} ns, bound {row['bound_ns']:.4f} ns",
              flush=True)
        rows.append(row)
    return rows


def decode_rows(dev) -> list[dict]:
    """The seven decode rows of the JAX profile (``profile_1944.py:195-205``)."""
    return [
        decode_row("576x288", "pallas", 16384, dev=dev),
        decode_row("2304x1152", "pallas", 8192, dev=dev),
        decode_row("1944x972", "pallas", 8192, dev=dev),
        decode_row_code(z_twin(88), "pallas", 8192, dev=dev),
        decode_row_code(z_twin(96), "pallas", 8192, dev=dev),
        decode_row("1944x972", "pallas-gather", 8192, dev=dev),
        decode_row("1944x972", "xla", 8192, dev=dev),
    ]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_1944: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    name, limit, clock_mhz = smi_query("name,power.limit,clocks.max.sm")
    card = f"{name}, {limit} W"
    clock_hz = float(clock_mhz) * 1e6
    lines = ["# 1944x972 efficiency on the card\n\n",
             f"{card}, max SM clock {clock_mhz} MHz "
             "(`python -m ldpcgputegra_tpu_torch.bench.profile_1944`).\n\n",
             "## Roll probe (ns per rotation of a [Z, 256] int32 slab, "
             "one slab an SM)\n\n",
             "| Z | multiple of 8 | wrap ns | mod ns | shared-memory bound ns |\n",
             "|---|---|---|---|---|\n"]
    for r in roll_table(dev, clock_hz):
        lines.append(f"| {r['Z']} | {'yes' if r['Z'] % 8 == 0 else 'no'} "
                     f"| {r['wrap']:.4f} | {r['mod']:.4f} "
                     f"| {r['bound_ns']:.4f} |\n")
    lines += ["\n## Full decode, time per edge (OMS 10, ET off, 2.0 dB)\n\n",
              "| code | backend | batch | ms/call | coded Mbit/s "
              "| ps/edge/iter/frame |\n",
              "|---|---|---|---|---|---|\n"]
    for r in decode_rows(dev):
        lines.append(f"| {r['code']} | {r['backend']} | {r['batch']} "
                     f"| {r['ms_per_call']:.4f} | {r['coded_mbps']:.1f} "
                     f"| {r['ps_per_edge_iter_frame']:.4f} |\n")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.writelines(lines)
    print(f"(II) wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

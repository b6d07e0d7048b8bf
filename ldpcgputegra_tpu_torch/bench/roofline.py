"""Roofline accounting for the decode kernels on the card (the port's
counterpart of ``ldpcgputegra_tpu/bench/roofline.py``).

A decode's bound is the least time the card could take for it: the larger
of its operations over the int32 rate and its bytes over the device-memory
rate.

* Operations: the real edge updates of the code actually decoded (its QC
  view for a staircase code; a deficient circulant's pinned edge is no
  work) x iterations x batch x the integer operations one min-sum edge
  update needs (``kernels/_lib.py::OPS_PER_EDGE``, 21, one count for every
  kernel).
* Bytes: the LLRs read once and the bits written once.  The messages are
  the kernel's own traffic, not the function's: they are reported as a
  note (``msg_bytes``), not bounded.
* Rates: the ones the probes measure on this card
  (``bench/vpu_probe.py``), passed in as ``alu_rate`` and ``hbm_rate``.
  Where a rate is not given, the data sheet's is used (``table_spec``:
  SMs x 64 int32 lanes x the max SM clock, 3.35 TB/s) and the result says
  ``ceiling="table"``.

``bound`` is the one formula: every bound of the card, the probes' too, is
computed there.
"""

from __future__ import annotations

import dataclasses
import subprocess

import torch

from ..codes.code import LdpcCode, committed_edges
from ..decoder import effective_code
from ..kernels._lib import OPS_PER_EDGE
from ..ops.layered import LayeredSpec

__all__ = ["HwSpec", "hw_spec", "table_spec", "smi_query", "edge_updates",
           "kernel_model", "bound", "roofline_report", "TABLE_HBM_BYTES_PER_S",
           "INT32_LANES_PER_SM"]

TABLE_HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA's data sheet)
INT32_LANES_PER_SM = 64  # int32 issue rate: SMs x 64 lanes x max SM clock


@dataclasses.dataclass(frozen=True)
class HwSpec:
    """The card's data-sheet ceilings."""

    name: str
    sm_count: int
    clock_hz: float  # max SM clock
    alu_rate: float  # int32 operations / s
    hbm_bw: float  # bytes / s


def table_spec(sm_count: int, clock_hz: float,
               name: str = "NVIDIA H100 (data sheet)") -> HwSpec:
    """The data-sheet ceilings of a card with ``sm_count`` SMs at
    ``clock_hz``."""
    return HwSpec(name, sm_count, clock_hz,
                  sm_count * INT32_LANES_PER_SM * clock_hz,
                  TABLE_HBM_BYTES_PER_S)


def smi_query(fields: str) -> list[str]:
    """The first card's ``nvidia-smi --query-gpu=<fields>`` values, without
    units."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    return [v.strip() for v in out.split(",")]


def hw_spec(device=None) -> HwSpec:
    """The data-sheet ceilings of the card: its SM count and its max SM
    clock (``nvidia-smi``).  Needs a CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError("hw_spec reads the card: no CUDA device")
    device = torch.device(device if device is not None else "cuda")
    props = torch.cuda.get_device_properties(device)
    clock_mhz = float(smi_query("clocks.max.sm")[0])
    return table_spec(props.multi_processor_count, clock_mhz * 1e6,
                      torch.cuda.get_device_name(device))


def edge_updates(code: LdpcCode) -> int:
    """The edge updates of one iteration over one codeword: the committed
    edges of the code actually decoded, less the pinned ones."""
    edges = 0
    for lay in effective_code(code).layers:
        idx, pinned = committed_edges(lay)
        edges += idx.size - (0 if pinned is None else int(pinned.sum()))
    return edges


def kernel_model(code: LdpcCode, spec: LayeredSpec, batch: int) -> dict:
    """Operations and bytes of one decode call of ``batch`` codewords at
    ``spec.iters`` iterations, ET off."""
    updates = edge_updates(code) * batch * spec.iters
    return {
        "edge_updates": updates,
        "ops": updates * OPS_PER_EDGE,
        "bytes": 2 * batch * code.N,  # LLRs in, bits out
        "msg_bytes": 2 * updates,  # an int8 message read and written
    }


def bound(ops: float, nbytes: float, alu_rate: float, hbm_rate: float,
          smem_seconds: float = 0.0) -> tuple[float, str]:
    """The least time, in seconds, for ``ops`` operations at ``alu_rate``
    and ``nbytes`` device-memory bytes at ``hbm_rate``, and what sets it:
    "operations", "bytes" or, where a kernel's own shared-memory traffic
    takes longer (``smem_seconds``), "shared memory"."""
    t_ops, t_bytes = ops / alu_rate, nbytes / hbm_rate
    return max((t_ops, "operations"), (t_bytes, "bytes"),
               (smem_seconds, "shared memory"), key=lambda t: t[0])


def roofline_report(code: LdpcCode, spec: LayeredSpec, batch: int,
                    seconds: float, alu_rate: float | None = None,
                    hbm_rate: float | None = None,
                    hw: HwSpec | None = None) -> dict:
    """A decode time of ``seconds`` against its bound.

    ``alu_rate`` and ``hbm_rate`` come from the probes; where one is not
    given the data sheet's is taken from ``hw`` (default ``hw_spec()``,
    which needs the card).  ``ceiling`` is "probed" when the rate that
    sets the bound was given, else "table"."""
    if hw is None and (alu_rate is None or hbm_rate is None):
        hw = hw_spec()
    ar = alu_rate if alu_rate is not None else hw.alu_rate
    hr = hbm_rate if hbm_rate is not None else hw.hbm_bw
    m = kernel_model(code, spec, batch)
    t_bound, by = bound(m["ops"], m["bytes"], ar, hr)
    probed = (alu_rate is not None) if by == "operations" else (
        hbm_rate is not None)
    return {
        **m,
        "hw": hw.name if hw is not None else "probed",
        "ceiling": "probed" if probed else "table",
        "bound": by,
        "ops_per_edge": OPS_PER_EDGE,
        "t_ops_ms": m["ops"] / ar * 1e3,
        "t_bytes_ms": m["bytes"] / hr * 1e3,
        "t_msg_ms": m["msg_bytes"] / hr * 1e3,
        "t_roofline_ms": t_bound * 1e3,
        "t_measured_ms": seconds * 1e3,
        "roofline_frac": t_bound / seconds if seconds else 0.0,
        "alu_util": (m["ops"] / seconds) / ar if seconds else 0.0,
        "hbm_util": (m["bytes"] / seconds) / hr if seconds else 0.0,
    }

"""Buffer dump/compare helpers (reference M5, ``tools/debug_fx.h:1-16``;
the port's counterpart of ``ldpcgputegra_tpu/utils/debug.py``).

The reference's ``CheckMemoryDataSet``/``DumpFloatMemoryDataSet`` compare
device buffers against dumped files while bringing a kernel up; these
compare any two tensors (on any device) or arrays, dump and load npz
snapshots, and print small LLR/APP frames.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["check_dataset", "dump_dataset", "load_dataset", "print_frame"]


def _np(x) -> np.ndarray:
    """A tensor (fetched from its device) or array-like as a NumPy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def check_dataset(name: str, got, expect, max_report: int = 10) -> bool:
    """Elementwise compare; prints the first differing positions like the
    reference's CheckMemoryDataSet. Returns True when identical."""
    got = _np(got)
    expect = _np(expect)
    if got.shape != expect.shape:
        print(f"(EE) {name}: shape mismatch {got.shape} vs {expect.shape}")
        return False
    diff = np.nonzero(got.ravel() != expect.ravel())[0]
    if diff.size == 0:
        print(f"(II) {name}: OK ({got.size} values)")
        return True
    print(f"(EE) {name}: {diff.size}/{got.size} values differ")
    for i in diff[:max_report]:
        print(
            f"(EE)   [{i}] got={got.ravel()[i]} expect={expect.ravel()[i]}"
        )
    return False


def dump_dataset(path: str, **arrays) -> None:
    np.savez_compressed(path, **{k: _np(v) for k, v in arrays.items()})


def load_dataset(path: str) -> dict:
    with np.load(path) as d:
        return dict(d)


def print_frame(v, per_line: int = 16, limit: int = 128) -> None:
    v = _np(v).ravel()[:limit]
    for i in range(0, v.size, per_line):
        row = " ".join(f"{int(x):4d}" for x in v[i : i + per_line])
        print(f"(DBG) {i:5d}: {row}")

"""State carried across from the JAX package, and onto the device.

``code_from_numpy`` rebuilds the port's ``LdpcCode`` from the fields of the
JAX package's ``LdpcCode`` (plain numpy arrays and ints), so tests can
hold the port's own ``load_code`` against the reference code object.

``qc_tables`` turns a code's QC block-rows into the small int32 tables
the QC kernel walks; ``edge_tables`` turns the committed edges of the
layers of any schedule (QC views included) into the per-edge tables the
gather and streamed kernels walk.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .code import DegreeClass, LdpcCode, committed_edges
from .schedule import build_layers

__all__ = ["code_from_numpy", "qc_tables", "edge_tables", "layer_shapes",
           "PINNED"]

PINNED = -1  # edge_tables' wide VN id of a deficient-circulant edge


def code_from_numpy(
    name: str,
    N: int,
    K: int,
    Z: Optional[int],
    classes: Sequence,
    class_idx: Sequence[np.ndarray],
    col_perm: Optional[np.ndarray] = None,
) -> LdpcCode:
    """Port-side ``LdpcCode`` from reference fields.  ``classes`` holds
    objects with ``deg``/``count`` attributes or ``(deg, count)`` pairs."""
    cls = tuple(
        DegreeClass(int(c.deg), int(c.count)) if hasattr(c, "deg")
        else DegreeClass(int(c[0]), int(c[1]))
        for c in classes
    )
    return LdpcCode(
        name=name,
        N=int(N),
        K=int(K),
        classes=cls,
        class_idx=tuple(np.asarray(ci, dtype=np.int32) for ci in class_idx),
        Z=None if Z is None else int(Z),
        col_perm=None if col_perm is None else np.asarray(col_perm),
    )


def qc_tables(code: LdpcCode, device) -> dict[str, torch.Tensor]:
    """The code's QC layers as int32 device tensors, in schedule order.

    ``row_ptr[l]:row_ptr[l+1]`` are layer l's edges in ``cols``/``shifts``
    (so ``deg[l] = row_ptr[l+1] - row_ptr[l]``).  Layer l's c2v message
    slots start at ``edge_offset[l] == Z * row_ptr[l]``: check z's edge j
    is slot ``edge_offset[l] + z * deg[l] + j``, the reference's flat
    check-major edge order.
    """
    if not code.is_qc:
        raise ValueError(f"{code.name}: not every layer is a QC block-row")
    Z = code.Z
    deg = np.asarray([lay.deg for lay in code.layers], dtype=np.int32)
    row_ptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    edge_offset = np.asarray([lay.edge_offset for lay in code.layers],
                             dtype=np.int32)
    if not np.array_equal(edge_offset, Z * row_ptr[:-1]):
        raise ValueError(f"{code.name}: layer edge offsets are not Z*row_ptr")
    cols = np.concatenate([lay.qc.cols for lay in code.layers]).astype(np.int32)
    shifts = np.concatenate(
        [lay.qc.shifts for lay in code.layers]).astype(np.int32)

    def t(a):
        return torch.as_tensor(a, dtype=torch.int32, device=device)

    return {"row_ptr": t(row_ptr), "deg": t(deg), "edge_offset": t(edge_offset),
            "cols": t(cols), "shifts": t(shifts)}


def edge_tables(code: LdpcCode, spec, device,
                wide: bool = True) -> dict[str, torch.Tensor]:
    """The committed edges of ``build_layers(code, spec.schedule)``
    (``codes/code.py::committed_edges``) as device tensors, in schedule
    order: the per-edge tables that the gather and streamed kernels walk.

    Layer l has ``n_checks[l]`` committed checks of degree ``deg[l]`` (a
    sub-pass layer's commit rows, else all of its checks); its edge slots
    are ``row_ptr[l] : row_ptr[l+1]``, degree-major: edge j of check g is
    slot ``row_ptr[l] + j * n_checks[l] + g``, and ``vn[slot]`` is its VN.
    ``perm`` is the view's ``col_perm`` (the streamed kernel loads
    ``app[n] = llr[col_perm[n]]`` and stores ``bits[col_perm[n]] = app[n] >
    0``), or empty.

    ``wide`` VN ids are int32, ``PINNED`` for a deficient-circulant edge
    (its contribution is -sat_var, it writes nothing, and its message slot
    is never read or written): the streamed kernel's.  Narrow ones are
    uint16 values stored as int16, for N < 65536 and no pinned edge: the
    gather kernel's.
    """
    if not wide and code.N > 65535:
        raise ValueError(f"{code.name}: N={code.N} does not fit uint16 VN ids")
    n_checks, deg, vns = [], [], []
    for lay in build_layers(code, spec.schedule):
        idx, pinned = committed_edges(lay)
        vn = idx.T.astype(np.int32)  # [deg, G]
        if pinned is not None:
            if not wide:
                raise ValueError(f"{code.name}: a pinned edge needs wide VN ids")
            vn[pinned.T] = PINNED
        n_checks.append(idx.shape[0])
        deg.append(idx.shape[1])
        vns.append(vn.ravel())
    n_checks = np.asarray(n_checks, dtype=np.int32)
    deg = np.asarray(deg, dtype=np.int32)
    row_ptr = np.concatenate([[0], np.cumsum(n_checks * deg)])
    if row_ptr[-1] >= 2**31:
        raise ValueError(f"{code.name}: {row_ptr[-1]} edge slots overflow int32")
    vn = np.concatenate(vns)
    vn = vn if wide else vn.astype(np.uint16).view(np.int16)
    perm = np.zeros(0) if code.col_perm is None else code.col_perm

    def t(a, dtype=np.int32):
        return torch.as_tensor(np.asarray(a, dtype=dtype), device=device)

    return {"row_ptr": t(row_ptr), "n_checks": t(n_checks), "deg": t(deg),
            "vn": t(vn, vn.dtype), "perm": t(perm)}


def layer_shapes(code: LdpcCode, schedule: str = "auto") -> list[tuple]:
    """(committed checks, degree) of each layer of the schedule: the layers
    that ``edge_tables`` lays out."""
    return [committed_edges(lay)[0].shape
            for lay in build_layers(code, schedule)]

"""State carried across from the JAX package, and onto the device.

``code_from_numpy`` rebuilds the port's ``LdpcCode`` from the fields of the
JAX package's ``LdpcCode`` (plain numpy arrays and ints), so tests can
hold the port's own ``load_code`` against the reference code object.

``qc_tables`` turns a code's QC block-rows into the small int32 tables
the QC kernel walks; ``gather_tables`` turns the layers of any schedule
into the per-edge tables the gather kernel walks.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .code import DegreeClass, LdpcCode
from .schedule import build_layers

__all__ = ["code_from_numpy", "qc_tables", "gather_tables"]


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


def gather_tables(code: LdpcCode, spec, device) -> dict[str, torch.Tensor]:
    """The layers of ``build_layers(code, spec.schedule)`` as device
    tensors, in schedule order.

    Layer l has ``n_checks[l]`` checks of degree ``deg[l]``; its edge slots
    are ``row_ptr[l] : row_ptr[l+1]``, degree-major: edge j of check g is
    slot ``row_ptr[l] + j * n_checks[l] + g``, and ``vn[slot]`` is its VN
    (uint16 values stored as int16, so N < 65536).
    """
    if code.N > 65535:
        raise ValueError(f"{code.name}: N={code.N} does not fit uint16 VN ids")
    layers = build_layers(code, spec.schedule)
    n_checks = np.asarray([lay.n_checks for lay in layers], dtype=np.int32)
    deg = np.asarray([lay.deg for lay in layers], dtype=np.int32)
    row_ptr = np.concatenate([[0], np.cumsum(n_checks * deg)]).astype(np.int32)
    vn = np.concatenate([lay.idx.T.ravel() for lay in layers])
    return {
        "row_ptr": torch.as_tensor(row_ptr, device=device),
        "n_checks": torch.as_tensor(n_checks, device=device),
        "deg": torch.as_tensor(deg, device=device),
        "vn": torch.as_tensor(vn.astype(np.uint16).view(np.int16),
                              device=device),
    }

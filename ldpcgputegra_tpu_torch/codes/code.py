"""QC-LDPC code definitions (NumPy; the PyTorch port's own copy).

Same semantics as ``ldpcgputegra_tpu/codes/code.py``.  The port carries
its own copy because importing anything under ``ldpcgputegra_tpu`` runs
that package's ``__init__``, which imports jax.

The reference framework (boiseHPSim/ldpcGpuTegra) bakes each parity-check
matrix into compiled C headers: a flat, check-major edge table
``PosNoeudsVariable[_M]`` with checks grouped by degree class
(``code/gpu_fixed/matrix/1944x972/constantes_decoder.h:3``,
``constantes_gpu.h:6-22``).  Here codes are *data*, loaded at runtime.

Two representations coexist:

* the flat edge table (``edges`` / per-class ``[count, deg]`` index arrays) —
  the general representation, semantically identical to the reference order;
* a quasi-cyclic (QC) view — block-rows of ``Z`` consecutive checks where the
  edge at position ``j`` of check ``z`` reads VN ``col_j*Z + (shift_j+z) % Z``.
  On the GPU it is a plain mod-Z index computed inside the kernel.

Layered (turbo) scheduling correctness: the reference processes checks
strictly sequentially within an iteration (one CUDA thread walks all checks
for its own codewords, ``CUDA_MS_SIMD.cu:138-246``).  A group of consecutive
checks touching pairwise-disjoint VNs can be processed in parallel with a
result bit-identical to sequential processing.  ``compute_layers`` performs
that greedy run partition; for QC codes the runs coincide with block-rows.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

__all__ = ["DegreeClass", "QCRow", "Layer", "LdpcCode", "committed_edges",
           "compute_layers", "detect_Z"]


@dataclasses.dataclass(frozen=True)
class DegreeClass:
    """A run of checks sharing one degree, in reference schedule order.

    Mirrors the reference's DEG_x / DEG_x_COMPUTATIONS pairs
    (``constantes_gpu.h:17-22``).
    """

    deg: int
    count: int


@dataclasses.dataclass(frozen=True)
class QCRow:
    """QC descriptor for one layer: edge position j of check z reads VN
    ``cols[j]*Z + (shifts[j] + z) % Z``.

    ``mask_edge``/``mask_rows`` describe a *deficient circulant*: at edge
    position ``mask_edge``, the checks listed in ``mask_rows`` have no such
    edge in the true H (e.g. the DVB-S2 staircase wrap at check 0).
    Decoders neutralize those (check, edge) contributions: the contribution
    pinned to -sat_var (parity-neutral) and no APP/message writeback.

    ``commit_rows``, when set, marks this layer as one *sub-pass* of a
    block-row whose checks are NOT mutually conflict-free (a repeated
    block-column makes checks z and z + s_j1 - s_j2 touch the same VN).
    The full block-row is computed, but only the listed checks commit
    their APP/message updates; the block-row's other sub-passes follow in
    schedule order, each seeing the previous commits — exactly equivalent
    to sequential processing in group order.  Messages live in each
    sub-pass's own slab (only its committed rows are ever meaningful).
    """

    cols: np.ndarray  # [deg] int32 block-column ids
    shifts: np.ndarray  # [deg] int32 cyclic shifts
    mask_edge: Optional[int] = None
    mask_rows: Optional[np.ndarray] = None
    commit_rows: Optional[np.ndarray] = None


@dataclasses.dataclass(frozen=True)
class Layer:
    """A conflict-free group of consecutive same-degree checks.

    ``idx`` is the [n_checks, deg] VN index table (reference order).
    ``qc`` is set when the layer is one QC block-row of size Z.
    ``edge_offset`` is the index of this layer's first edge in the flat table
    (== its first message slot in the reference's edge-major message memory).
    """

    idx: np.ndarray
    edge_offset: int
    qc: Optional[QCRow] = None

    @property
    def n_checks(self) -> int:
        return self.idx.shape[0]

    @property
    def deg(self) -> int:
        return self.idx.shape[1]


def committed_edges(layer: Layer) -> tuple[np.ndarray, Optional[np.ndarray]]:
    """What a decode step of ``layer`` computes and commits.

    Returns ``(idx, pinned)``: ``idx`` [G, deg] holds the layer's committed
    checks (a sub-pass layer's ``commit_rows``, else all of them), which
    touch pairwise-disjoint VNs; ``pinned`` [G, deg] bool marks the
    deficient-circulant edges (``mask_edge`` at ``mask_rows``), whose
    contribution is pinned to -sat_var and which write nothing, or is None
    when the layer has none.
    """
    qc = layer.qc
    rows = np.arange(layer.n_checks)
    if qc is not None and qc.commit_rows is not None:
        rows = np.asarray(qc.commit_rows, dtype=np.int64)
    idx = layer.idx[rows]
    if qc is None or qc.mask_edge is None:
        return idx, None
    pinned = np.zeros(idx.shape, dtype=bool)
    pinned[np.isin(rows, qc.mask_rows), qc.mask_edge] = True
    return idx, (pinned if pinned.any() else None)


def _runs_conflict_free(idx: np.ndarray) -> bool:
    """True if no VN appears twice within the whole group of checks."""
    flat = idx.ravel()
    return np.unique(flat).size == flat.size


def _detect_qc_row(idx: np.ndarray, Z: int) -> Optional[QCRow]:
    """Check whether a [Z, deg] index block follows the QC roll pattern."""
    if idx.shape[0] != Z:
        return None
    first = idx[0]
    cols = first // Z
    shifts = first % Z
    z = np.arange(Z, dtype=np.int64)[:, None]
    expect = cols[None, :] * Z + (shifts[None, :] + z) % Z
    if np.array_equal(expect, idx):
        return QCRow(cols=cols.astype(np.int32), shifts=shifts.astype(np.int32))
    return None


def detect_Z(class_idx: Sequence[np.ndarray], N: int) -> Optional[int]:
    """Detect the QC expansion factor from per-class [count, deg] tables.

    Tries divisors of N from large to small; accepts the largest Z for which
    every full block of Z consecutive checks within each degree class is a
    valid QC row (trailing partial blocks are tolerated — e.g. the single
    odd-degree staircase check of the DVB-S2 codes).
    """
    cands = [z for z in range(2, N + 1) if N % z == 0]
    for Z in sorted(cands, reverse=True):
        ok = True
        full_rows = 0
        for idx in class_idx:
            n = idx.shape[0]
            for s in range(0, (n // Z) * Z, Z):
                if _detect_qc_row(idx[s : s + Z], Z) is None:
                    ok = False
                    break
                full_rows += 1
            if not ok:
                break
        if ok and full_rows > 0:
            return Z
    return None


def compute_layers(
    class_idx: Sequence[np.ndarray], Z: Optional[int]
) -> list[Layer]:
    """Partition the reference check sequence into parallel-safe layers.

    If ``Z`` is given, cuts each degree class at Z boundaries and attaches QC
    descriptors where the roll pattern holds; remaining checks fall back to
    greedy maximal conflict-free runs (processed by the gather path).
    """
    layers: list[Layer] = []
    edge_offset = 0
    for idx in class_idx:
        n, deg = idx.shape
        s = 0
        while s < n:
            made = False
            if Z is not None and s % Z == 0 and s + Z <= n:
                qc = _detect_qc_row(idx[s : s + Z], Z)
                if qc is not None:
                    layers.append(
                        Layer(idx=idx[s : s + Z], edge_offset=edge_offset, qc=qc)
                    )
                    edge_offset += Z * deg
                    s += Z
                    made = True
            if not made:
                # greedy maximal conflict-free run
                e = s + 1
                seen = set(idx[s].tolist())
                while e < n:
                    row = idx[e]
                    if any(v in seen for v in row.tolist()):
                        break
                    seen.update(row.tolist())
                    e += 1
                layers.append(Layer(idx=idx[s:e], edge_offset=edge_offset))
                edge_offset += (e - s) * deg
                s = e
    for lay in layers:
        assert _runs_conflict_free(lay.idx), "layer has VN conflicts"
    return layers


@dataclasses.dataclass(frozen=True)
class LdpcCode:
    """A QC-LDPC code, runtime equivalent of one reference matrix/ directory."""

    name: str
    N: int  # codeword length (_N)
    # info length = N - n_checks.  NOTE: the reference's ``_K`` macro is the
    # CHECK count, not the info length (``CTrame::nb_vars`` returns
    # ``nb_data() - nb_checks()``, code/gpu_fixed/trame/CTrame.cpp:65-67);
    # loaders translate, so ``K`` here is always true info length.
    K: int
    classes: tuple[DegreeClass, ...]
    class_idx: tuple[np.ndarray, ...]  # per class: [count, deg] int32
    Z: Optional[int] = None
    layers: tuple[Layer, ...] = ()
    # Encoder side (DVB-S2-style QC accumulate tables), optional:
    enc_rows: Optional[tuple[np.ndarray, ...]] = None  # per table line: positions
    enc_q: Optional[int] = None
    # Set on QC-ified views of another code (codes/dvbs2.py::to_qc_form):
    # this code's VN i is the base code's VN col_perm[i].  Decoders permute
    # input LLRs by col_perm and inverse-permute output bits.
    col_perm: Optional[np.ndarray] = None

    def __post_init__(self):
        if not self.layers:
            object.__setattr__(
                self, "layers", tuple(compute_layers(self.class_idx, self.Z))
            )

    @property
    def M(self) -> int:  # number of edges (_M in the reference)
        return int(sum(c.deg * c.count for c in self.classes))

    @property
    def n_checks(self) -> int:
        return int(sum(c.count for c in self.classes))

    @property
    def edges(self) -> np.ndarray:
        """Flat check-major edge table == reference PosNoeudsVariable[_M]."""
        return np.concatenate([ci.ravel() for ci in self.class_idx]).astype(
            np.int32
        )

    @property
    def rate(self) -> float:
        return self.K / self.N

    @property
    def is_qc(self) -> bool:
        return self.Z is not None and all(l.qc is not None for l in self.layers)

    def check_valid(self) -> None:
        assert self.K == self.N - self.n_checks, "K must be info length"
        for ci, c in zip(self.class_idx, self.classes):
            assert ci.shape == (c.count, c.deg)
            assert ci.min() >= 0 and ci.max() < self.N

    @staticmethod
    def from_edges(
        name: str,
        N: int,
        K: Optional[int],
        classes: Sequence[tuple[int, int]],
        edges: np.ndarray,
        detect_qc: bool = True,
    ) -> "LdpcCode":
        """Build from the reference's flat representation
        (deg/count pairs + flat PosNoeudsVariable table).  ``K`` is the info
        length; pass None to derive it as N - total checks (the reference's
        ``_K`` is the check count, NOT the info length)."""
        if K is None:
            K = N - sum(count for _, count in classes)
        edges = np.asarray(edges, dtype=np.int32)
        class_idx = []
        off = 0
        for deg, count in classes:
            class_idx.append(edges[off : off + deg * count].reshape(count, deg))
            off += deg * count
        assert off == edges.size, "edge table size mismatch"
        Z = detect_Z(class_idx, N) if detect_qc else None
        return LdpcCode(
            name=name,
            N=N,
            K=K,
            classes=tuple(DegreeClass(d, c) for d, c in classes),
            class_idx=tuple(class_idx),
            Z=Z,
        )

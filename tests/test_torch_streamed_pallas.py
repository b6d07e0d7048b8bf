"""The plain PyTorch decoder against the JAX package's K2
(``kernels/pallas_streamed.py::make_streamed_decoder``, run in interpret
mode on the CPU as ``tests/test_streamed_cpu.py`` runs it), which the
port's ``csrc/streamed_minsum.cu`` replaces.  Bit-exact in bits and
``iters_used``, B=128, from the same seeded numpy int8 LLRs.

The cases: the toy QC code, a code of sub-pass layers, a random QC code
with early termination, OMS/pre and 2NMS/post, and a small staircase code
built here and QC-ified by each package's ``to_qc_form`` (``col_perm``,
the deficient circulant and sub-pass layers together through K2).
"""

import dataclasses

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ldpcgputegra_tpu.codes.code import DegreeClass as JDegreeClass
from ldpcgputegra_tpu.codes.code import Layer as JLayer
from ldpcgputegra_tpu.codes.code import LdpcCode as JLdpcCode
from ldpcgputegra_tpu.codes.code import QCRow as JQCRow
from ldpcgputegra_tpu.codes.dvbs2 import _conflict_groups as j_conflict_groups
from ldpcgputegra_tpu.codes.dvbs2 import to_qc_form as j_to_qc_form
from ldpcgputegra_tpu.codes.registry import make_qc_code as j_make_qc_code
from ldpcgputegra_tpu.codes.registry import (
    make_random_qc_code as j_make_random_qc_code,
)
from ldpcgputegra_tpu.codes.schedule import color_layers as j_color_layers
from ldpcgputegra_tpu.kernels.pallas_streamed import make_streamed_decoder
from ldpcgputegra_tpu.ops.layered import LayeredSpec as JSpec
from ldpcgputegra_tpu_torch.codes.code import DegreeClass, Layer, LdpcCode, QCRow
from ldpcgputegra_tpu_torch.codes.dvbs2 import _conflict_groups, to_qc_form
from ldpcgputegra_tpu_torch.codes.registry import make_qc_code, make_random_qc_code
from ldpcgputegra_tpu_torch.decoder import make_decoder
from ldpcgputegra_tpu_torch.ops.layered import LayeredSpec, make_layered_decoder


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the cores, and the
    many small tensor ops here run far slower on a pool of threads that
    competes with them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_BASE = np.array([
    [0, 2, -1, 5, 1, -1, 3, 0],
    [4, -1, 1, 0, -1, 2, 0, 6],
    [-1, 3, 0, -1, 6, 0, 2, 1],
])


def _dup_col_code(pkg):
    """Two block-rows with repeated block-columns (sub-pass split), sharing
    a column (``tests/test_streamed_cpu.py::_dup_col_code``), built from
    the classes of one package."""
    dc, layer, code, qcrow, groups = pkg
    Z = 8
    rows = [
        (np.array([0, 1, 1], np.int32), np.array([0, 1, 4], np.int32)),
        (np.array([1, 2, 2], np.int32), np.array([2, 0, 3], np.int32)),
    ]
    zz = np.arange(Z, dtype=np.int64)[:, None]
    layers, classes, class_idx = [], [], []
    off = 0
    for cols, shifts in rows:
        idx = (cols[None, :] * Z + (shifts[None, :] + zz) % Z).astype(np.int32)
        for g in groups(cols, shifts, Z):
            layers.append(layer(idx=idx, edge_offset=off,
                                qc=qcrow(cols=cols, shifts=shifts,
                                         commit_rows=g)))
        classes.append(dc(3, Z))
        class_idx.append(idx)
        off += idx.size
    return code(name="dup2", N=24, K=8, classes=tuple(classes),
                class_idx=tuple(class_idx), Z=Z, layers=tuple(layers))


PORT = (DegreeClass, Layer, LdpcCode, QCRow, _conflict_groups)
JAX = (JDegreeClass, JLayer, JLdpcCode, JQCRow, j_conflict_groups)

# a small staircase code: z=8, q=3 (M=24 checks), two info groups (K=16);
# info bit t of group g scatters to rows (p + t*q) mod M for each p of the
# group's table line (``codes/dvbs2.py``).  Block-row p mod q gets a
# circulant of shift p div q; group 0 repeats block-rows 0 and 1, group 1
# block-row 2, so every block-row splits into sub-passes, and block-row 0
# holds the deficient circulant.
_Z, _Q, _TABLE = 8, 3, [[0, 3, 4, 7], [2, 5, 6]]


def _staircase_code(code_cls):
    M = _Z * _Q
    K = _Z * len(_TABLE)
    rows = [{K + r} | ({K + r - 1} if r else set()) for r in range(M)]
    for g, line in enumerate(_TABLE):
        for t in range(_Z):
            for p in line:
                rows[(p + t * _Q) % M].add(g * _Z + t)
    degs = sorted({len(r) for r in rows}, reverse=True)
    classes = [(d, sum(len(r) == d for r in rows)) for d in degs]
    edges = np.concatenate([sorted(r) for d in degs for r in rows
                            if len(r) == d]).astype(np.int32)
    return code_cls.from_edges("stair40", K + M, K, classes, edges,
                               detect_qc=False)


def _llrs(n, b, seed, std=0.8):
    rng = np.random.default_rng(seed)
    std = np.linspace(0.5, std, b)[:, None]
    return np.clip(8.0 * (-1.0 + std * rng.standard_normal((b, n))),
                   -31, 31).astype(np.int8)


def _codes(case):
    """(port code, JAX code) of one case."""
    if case == "toy":
        return make_qc_code("toy8", _BASE, Z=8), j_make_qc_code("toy8", _BASE, Z=8)
    if case == "subpass":
        return _dup_col_code(PORT), _dup_col_code(JAX)
    if case == "random-qc":
        return (make_random_qc_code(24, 12, 5, Z=32, seed=3),
                j_make_random_qc_code(24, 12, 5, Z=32, seed=3))
    return (to_qc_form(_staircase_code(LdpcCode), z=_Z),
            j_to_qc_form(_staircase_code(JLdpcCode), z=_Z))


@pytest.mark.parametrize("case,kw", [
    ("toy", dict(algo="OMS", minclamp="pre", iters=3)),
    ("toy", dict(algo="2NMS", minclamp="post", iters=3, early_term=True)),
    ("subpass", dict(algo="OMS", iters=3)),
    ("random-qc", dict(algo="OMS", iters=4, early_term=True)),
    ("staircase", dict(algo="OMS", iters=4, early_term=True)),
])
def test_plain_matches_pallas_streamed_interpret(case, kw):
    port, ref = _codes(case)
    llr = _llrs(port.N, 128, seed=len(case) + kw["iters"])
    bits, iters = make_layered_decoder(port, LayeredSpec(**kw))(
        torch.from_numpy(llr))
    with pltpu.force_tpu_interpret_mode():
        rb, ri = make_streamed_decoder(ref, JSpec(**kw), batch_tile=128)(llr)
    np.testing.assert_array_equal(bits.numpy(), np.asarray(rb))
    assert int(iters) == int(ri)
    if kw.get("early_term"):
        assert int(iters) > 1  # the batch does not converge at once


def test_small_staircase_view_has_every_feature():
    """The staircase case really exercises col_perm, the deficient
    circulant and sub-passes in one layer; the view's decoder takes and
    gives the base code's column order."""
    view = to_qc_form(_staircase_code(LdpcCode), z=_Z)
    assert view.name == "stair40-qc"
    assert not np.array_equal(view.col_perm, np.arange(view.N))
    both = [lay for lay in view.layers
            if lay.qc.mask_edge is not None and lay.qc.commit_rows is not None
            and 0 in lay.qc.commit_rows]
    assert len(both) == 1
    assert all(lay.qc.commit_rows is not None for lay in view.layers)
    llr = torch.from_numpy(_llrs(view.N, 16, seed=2))
    spec = LayeredSpec(iters=4)
    bits, _ = make_decoder(view, spec, device="cpu")(llr)
    unperm = dataclasses.replace(view, col_perm=None)
    vb, _ = make_layered_decoder(unperm, spec)(llr[:, view.col_perm])
    assert torch.equal(bits, vb[:, np.argsort(view.col_perm)])


def test_jax_colors_the_spurious_edge_of_a_view():
    """JAX's colored schedule of a QC view colors ``class_idx``, which
    still holds the deficient circulant's spurious wrap edge at check 0 of
    block-row 0: that decode has one edge more than the code (ROADMAP
    section 3).  The port refuses that schedule on a view."""
    view = j_to_qc_form(_staircase_code(JLdpcCode), z=_Z)
    spurious = set(view.layers[0].idx[0].tolist())
    true_check0 = spurious - {int(view.layers[0].idx[0, view.layers[0].qc.mask_edge])}
    colored = [set(row.tolist()) for lay in j_color_layers(view)
               for row in lay.idx]
    assert spurious in colored and true_check0 not in colored
    with pytest.raises(NotImplementedError, match="spurious"):
        make_layered_decoder(to_qc_form(_staircase_code(LdpcCode),
                                        z=_Z), LayeredSpec(schedule="colored"))

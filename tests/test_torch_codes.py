"""The port's NumPy code layer against the JAX package's.

``code_from_numpy`` rebuilds a port-side code from the reference code's
fields; the port's own ``load_code`` must build the same layers from the
shared data files: the same ``idx``, ``edge_offset``, ``qc.cols`` and
``qc.shifts``.
"""

import numpy as np
import pytest
import torch

from ldpcgputegra_tpu.codes import registry as jreg
from ldpcgputegra_tpu.codes.schedule import build_layers as j_build_layers
from ldpcgputegra_tpu_torch.codes import registry as preg
from ldpcgputegra_tpu_torch.codes.code import detect_Z
from ldpcgputegra_tpu_torch.codes.convert import code_from_numpy, qc_tables
from ldpcgputegra_tpu_torch.codes.schedule import build_layers

QC_CODES = ["576x288", "1944x972", "2304x1152", "155x93", "1248x624",
            "802_11e_576x288", "802_11e_1920x960", "802_11e_2304x1152",
            "802_11n-1944x972"]


def _assert_same_layers(a, b):
    assert len(a) == len(b)
    for la, lb in zip(a, b):
        np.testing.assert_array_equal(la.idx, lb.idx)
        assert la.edge_offset == lb.edge_offset
        assert (la.qc is None) == (lb.qc is None)
        if la.qc is not None:
            np.testing.assert_array_equal(la.qc.cols, lb.qc.cols)
            np.testing.assert_array_equal(la.qc.shifts, lb.qc.shifts)
            assert la.qc.mask_edge == lb.qc.mask_edge
            assert la.qc.commit_rows is None and lb.qc.commit_rows is None


def _from_ref(jc):
    return code_from_numpy(jc.name, jc.N, jc.K, jc.Z, jc.classes,
                           jc.class_idx, jc.col_perm)


@pytest.mark.parametrize("name", QC_CODES + ["200x100", "816x408",
                                             "synthqc-8x4x3-z16-s2"])
def test_load_code_matches_reference(name):
    jc = jreg.load_code(name)
    pc = preg.load_code(name)
    conv = _from_ref(jc)
    for c in (pc, conv):
        assert (c.name, c.N, c.K, c.Z, c.M, c.n_checks, c.is_qc) == (
            jc.name, jc.N, jc.K, jc.Z, jc.M, jc.n_checks, jc.is_qc)
        np.testing.assert_array_equal(c.edges, jc.edges)
        _assert_same_layers(c.layers, jc.layers)
    _assert_same_layers(pc.layers, conv.layers)


def test_list_codes_matches_reference():
    assert preg.list_codes() == jreg.list_codes()


@pytest.mark.parametrize("name,schedule", [("200x100", "colored"),
                                           ("816x408", "auto"),
                                           ("576x288", "auto")])
def test_schedules_match_reference(name, schedule):
    _assert_same_layers(build_layers(preg.load_code(name), schedule),
                        j_build_layers(jreg.load_code(name), schedule))


def test_make_qc_code_and_detect_z():
    base = np.array([[0, 3, -1, 1], [2, -1, 0, 5]])
    pc = preg.make_qc_code("t", base, 7)
    jc = jreg.make_qc_code("t", base, 7)
    _assert_same_layers(pc.layers, jc.layers)
    assert pc.Z == 7 and pc.is_qc
    assert detect_Z(pc.class_idx, pc.N) == 7


@pytest.mark.parametrize("name", ["1944x972", "155x93"])
def test_qc_tables_rebuild_the_layers(name):
    code = preg.load_code(name)
    t = {k: v.numpy() for k, v in qc_tables(code, "cpu").items()}
    assert all(v.dtype == np.int32 for v in t.values())
    Z = code.Z
    z = np.arange(Z)
    for li, lay in enumerate(code.layers):
        e0, e1 = t["row_ptr"][li], t["row_ptr"][li + 1]
        assert e1 - e0 == t["deg"][li] == lay.deg
        assert t["edge_offset"][li] == lay.edge_offset == Z * e0
        idx = t["cols"][e0:e1][None, :] * Z + (
            t["shifts"][e0:e1][None, :] + z[:, None]) % Z
        np.testing.assert_array_equal(idx, lay.idx)
    assert t["row_ptr"][-1] * Z == code.M


def test_qc_tables_refuse_non_qc():
    with pytest.raises(ValueError):
        qc_tables(preg.load_code("200x100"), torch.device("cpu"))


def test_unported_inputs_raise():
    # the name is historical: alist files load now (codes/alist.py), so
    # what raises is a missing file and an unknown name
    with pytest.raises(FileNotFoundError):
        preg.load_code("some/code.alist")
    with pytest.raises(KeyError):
        preg.load_code("no-such-code")

"""The port's alist loader and writer (``codes/alist.py``, and the
registry's ``*.alist`` branch) against the JAX package's, and the
profiling and debugging helpers (``utils/``)."""

import os

import numpy as np
import pytest
import torch

from ldpcgputegra_tpu.codes.alist import load_alist as j_load_alist
from ldpcgputegra_tpu.codes.alist import save_alist as j_save_alist
from ldpcgputegra_tpu.codes.registry import load_code as j_load_code
from ldpcgputegra_tpu_torch.codes.alist import load_alist, save_alist
from ldpcgputegra_tpu_torch.codes.registry import load_code
from ldpcgputegra_tpu_torch.utils import (
    check_dataset,
    dump_dataset,
    load_dataset,
    print_frame,
    span,
    spans,
    trace,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the cores, and the
    many small tensor ops here run far slower on a pool of threads that
    competes with them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same_code(a, b):
    assert (a.name, a.N, a.K, a.Z) == (b.name, b.N, b.K, b.Z)
    assert [(c.deg, c.count) for c in a.classes] == [
        (c.deg, c.count) for c in b.classes]
    for x, y in zip(a.class_idx, b.class_idx):
        np.testing.assert_array_equal(x, y)
    assert len(a.layers) == len(b.layers)


@pytest.mark.parametrize("name", ["576x288", "200x100"])
def test_alist_loads_as_jax_does(name, tmp_path):
    path = str(tmp_path / f"{name}.alist")
    j_save_alist(j_load_code(name), path)
    _same_code(load_alist(path), j_load_alist(path))
    # the port's writer writes the same file, and the registry loads it
    mine = str(tmp_path / "mine.alist")
    save_alist(load_code(name), mine)
    with open(path) as a, open(mine) as b:
        assert a.read() == b.read()
    _same_code(load_code(path), j_load_alist(path))


def test_alist_refuses_a_bad_degree(tmp_path):
    path = str(tmp_path / "bad.alist")
    save_alist(load_code("200x100"), path)
    with open(path) as f:
        lines = f.read().splitlines()
    lines[-1] = " ".join(["0"] * len(lines[-1].split()))  # empty last check
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    with pytest.raises(ValueError, match="degree mismatch"):
        load_alist(path)


def test_profiling_helpers(tmp_path):
    d = str(tmp_path / "trace")
    before = len(spans())
    with trace(d) as where:
        with span("helpers", count=64):
            torch.ones(64).cumsum(0)
    assert where == d
    (name,) = [f for f in os.listdir(d) if f.endswith(".pt.trace.json")]
    (rec,) = spans()[before:]
    assert (rec.name, rec.count, rec.parent) == ("ldpc.helpers", 64, None)
    assert 0 < rec.end - rec.start
    with open(os.path.join(d, name)) as f:
        assert '"ldpc.helpers"' in f.read()


def test_debug_helpers(tmp_path, capfd):
    a = torch.arange(20, dtype=torch.int8)
    b = a.clone()
    b[3] = 7
    assert check_dataset("same", a, a.numpy())
    assert not check_dataset("diff", a, b)
    assert not check_dataset("shape", a, a[:5])
    out = capfd.readouterr().out
    assert "(II) same: OK (20 values)" in out
    assert "1/20 values differ" in out and "[3] got=3 expect=7" in out
    path = str(tmp_path / "d.npz")
    dump_dataset(path, llr=a, bits=np.ones(3, np.uint8))
    d = load_dataset(path)
    np.testing.assert_array_equal(d["llr"], a.numpy())
    assert d["bits"].tolist() == [1, 1, 1]
    print_frame(a, per_line=8, limit=16)
    assert capfd.readouterr().out.count("(DBG)") == 2

"""``ldpcgputegra_tpu_torch/entry.py`` against the JAX package's
``__graft_entry__.py`` on the CPU: the same configuration, the same int8
LLRs (``np.array_equal``), and the JAX step's bits and ``iters_used``
equal to ``entry(device="cpu")``'s exactly.  The JAX module is loaded by
path (it is not a package module); its step is the XLA layered decoder,
run once for the module."""

import ast
import importlib.util
import os

import numpy as np
import pytest
import torch

from ldpcgputegra_tpu_torch import entry as E
from ldpcgputegra_tpu_torch.codes.registry import load_code
from ldpcgputegra_tpu_torch.decoder import backend_for
from ldpcgputegra_tpu_torch.parallel import dryrun

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_ENTRY = os.path.join(ROOT, "__graft_entry__.py")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_step():
    """JAX's ``entry()`` on the CPU and its step: (llr, bits, iters)."""
    spec = importlib.util.spec_from_file_location("_jax_graft_entry",
                                                  JAX_ENTRY)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    fn, (llr,) = mod.entry()
    bits, iters = fn(llr)
    return np.asarray(llr), np.asarray(bits), int(iters)


@pytest.fixture(scope="module")
def torch_step():
    fn, (llr,) = E.entry(device="cpu")
    bits, iters = fn(llr)
    return llr, bits, int(iters)


def test_llrs_equal_jax(jax_step, torch_step):
    llr, _, _ = torch_step
    assert llr.device.type == "cpu" and llr.dtype == torch.int8
    assert tuple(llr.shape) == (E.BATCH, load_code(E.CODE).N) == (128, 1944)
    assert np.array_equal(jax_step[0], llr.numpy())


def test_bits_and_iters_equal_jax(jax_step, torch_step):
    _, jbits, jiters = jax_step
    _, bits, iters = torch_step
    assert bits.dtype == torch.uint8
    assert np.array_equal(jbits, bits.numpy())
    assert jiters == iters == E.SPEC.iters
    # the step corrects the channel's errors, in both packages
    assert int(bits.sum()) < int((torch_step[0] > 0).sum()) // 50


def _jax_entry_config():
    """(code name, batch, LayeredSpec keywords) of the JAX ``entry()``,
    read from its source."""
    tree = ast.parse(open(JAX_ENTRY).read())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == "entry")
    calls = [n for n in ast.walk(fn) if isinstance(n, ast.Call)]
    code = next(c.args[0].value for c in calls
                if getattr(c.func, "id", None) == "load_code")
    spec = next(c for c in calls if getattr(c.func, "id", None) == "LayeredSpec")
    kw = {k.arg: k.value.value for k in spec.keywords}
    size = next(c for c in calls if getattr(c.func, "attr", None) == "normal")
    batch = size.keywords[0].value.elts[0].value
    return code, batch, kw


def test_configuration_equals_jax():
    code, batch, kw = _jax_entry_config()
    assert (code, batch) == (E.CODE, E.BATCH)
    assert kw == {"algo": "OMS", "iters": 10, "early_term": False,
                  "minclamp": "pre", "schedule": "auto"}
    assert {k: getattr(E.SPEC, k) for k in kw} == kw


def test_the_step_is_k1_on_the_card_and_plain_on_the_cpu():
    code = load_code(E.CODE)
    assert backend_for(code, E.SPEC, "cuda") == "cuda"
    assert backend_for(code, E.SPEC, "cpu") == "torch"


def test_without_a_card_entry_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        E.entry()


def test_dryrun_multichip_is_the_ported_one():
    assert E.dryrun_multichip is dryrun.dryrun_multichip

"""The ported JAX tools against the JAX tools on the CPU: their tables, the
convergence statistics of ``tools/run_et_study.py::convergence_stats`` on
the same int8 LLRs, and the clean input of ``tools/et_skip_diag.py``
through fixed 10 iterations.  Exact everywhere."""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

from ldpcgputegra_tpu.codes.registry import load_code as j_load_code
from ldpcgputegra_tpu.decoder import make_decoder as j_make_decoder
from ldpcgputegra_tpu.ops.layered import LayeredSpec as JSpec
from ldpcgputegra_tpu_torch.bench import (
    et_skip_diag,
    et_study,
    hw_validate,
    kernel_et,
    vectors_check,
)
from ldpcgputegra_tpu_torch.codes.registry import load_code
from ldpcgputegra_tpu_torch.decoder import make_decoder
from ldpcgputegra_tpu_torch.ops.layered import LayeredSpec

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tool(name):
    """A JAX tool of ``tools/``, loaded once a process."""
    key = "jax_tool_" + name
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            key, os.path.join(ROOT, "tools", name + ".py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules[key] = mod
    return sys.modules[key]


@pytest.mark.parametrize("ours,tool,attr,n", [
    (hw_validate.QC, "hw_validate", "QC", None),
    (hw_validate.STREAMED, "hw_validate", "STREAMED", None),
    (hw_validate.STREAMED_ONLY, "hw_validate", "STREAMED_ONLY", None),
    (hw_validate.GATHER, "hw_validate", "GATHER", None),
    (hw_validate.TAIL, "hw_validate", "TAIL", None),
    (kernel_et.CONFIGS, "run_kernel_et", "CONFIGS", 13),
    (et_skip_diag.CONFIGS, "et_skip_diag", "CONFIGS", 2),
    (et_study.CONV_CONFIGS, "run_et_study", "CONFIGS", None),
    (et_study.ALGOS, "run_et_study", "ALGOS", None),
    (vectors_check.CASES, "gen_vectors", "CASES", None),
])
def test_tables_equal_the_jax_tools(ours, tool, attr, n):
    theirs = getattr(_tool(tool), attr)
    assert list(ours[:n]) == list(theirs)


def _llrs(n, B, snr_db, seed, rate=0.5):
    sigma = np.sqrt(10 ** (-0.1 * (snr_db + 10 * np.log10(rate))) / 2)
    rng = np.random.default_rng(seed)
    return np.clip(8.0 * (-1.0 + sigma * rng.standard_normal((B, n))),
                   -31, 31).astype(np.int8)


@pytest.mark.parametrize("algo,mc,snr", [("2NMS", "post", 3.0),
                                         ("OMS", "pre", 2.5)])
def test_convergence_stats_equal_jax(algo, mc, snr):
    llr = _llrs(576, 128, snr, seed=11)
    theirs = _tool("run_et_study").convergence_stats(
        j_load_code("576x288"), algo, mc, [llr])
    ours = et_study.convergence_stats(load_code("576x288"), algo, mc,
                                      torch.from_numpy(llr), "cpu")
    assert ours == theirs
    p = [ours[k] for k in et_study.CONV_KS]
    assert p == sorted(p) and 0 < p[0] and p[-1] <= 1


def test_clean_fixed10_equals_jax():
    """The clean input of the skip diagnosis leaves ones after 10 fixed
    iterations of 2NMS with minclamp post (the saturated APP): the JAX
    package decodes it to the same bits, and ET stops at iteration 1."""
    code = load_code("576x288")
    x = et_skip_diag.clean_inputs(code, 4, 1, "cpu")[0]
    spec = dict(algo="2NMS", iters=10, minclamp="post")
    bits, iters = make_decoder(code, LayeredSpec(**spec), device="cpu")(x)
    j_bits, _ = j_make_decoder(j_load_code("576x288"), JSpec(**spec))(
        x.numpy())
    np.testing.assert_array_equal(bits.numpy(), np.asarray(j_bits))
    assert int(bits.sum()) > 0 and int(iters) == 10
    j_bits, j_iters = j_make_decoder(j_load_code("576x288"), JSpec(
        **spec, early_term=True))(x.numpy())
    assert not np.asarray(j_bits).any() and int(j_iters) == 1

"""``bench/air.py`` on the CPU: the decode and count of ``build_parts``
give the JAX tool's counts on the same int8 LLRs, and the graphed step's
counts (a loop of S on the CPU) equal the eager step's, batch by batch."""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

from ldpcgputegra_tpu.codes.registry import load_code as j_load_code
from ldpcgputegra_tpu.ops.layered import LayeredSpec as JSpec
from ldpcgputegra_tpu_torch.bench import air
from ldpcgputegra_tpu_torch.codes.registry import load_code
from ldpcgputegra_tpu_torch.ops.layered import LayeredSpec

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 128


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_parts():
    """The JAX tool's ``build_parts`` at 576x288, built once a module."""
    key = "jax_tool_run_air_bench"
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            key, os.path.join(ROOT, "tools", "run_air_bench.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules[key] = mod
    return sys.modules[key].build_parts(
        j_load_code("576x288"), JSpec(algo="OMS", iters=10, early_term=False),
        B)


def _llrs(n, snr_db, seed, rate=0.5):
    sigma = np.sqrt(10 ** (-0.1 * (snr_db + 10 * np.log10(rate))) / 2)
    rng = np.random.default_rng(seed)
    return np.clip(8.0 * (-1.0 + sigma * rng.standard_normal((B, n))),
                   -31, 31).astype(np.int8)


@pytest.mark.parametrize("snr", [1.0, 1.5, 2.5])
def test_decode_and_count_equal_jax(jax_parts, snr):
    _, _, _, j_dec, j_cnt, _ = jax_parts
    code = load_code("576x288")
    _, _, _, dec_fn, cnt_fn, _ = air.build_parts(
        code, LayeredSpec(algo="OMS", iters=10, early_term=False), B, "cpu")
    llr = _llrs(code.N, snr, seed=int(10 * snr))
    got = cnt_fn(dec_fn(torch.from_numpy(llr))).tolist()
    want = [int(x) for x in j_cnt(j_dec(llr))]
    assert got == want
    assert snr > 2.0 or got[1] > 0


def test_graphed_step_counts_equal_eager():
    code = load_code("576x288")
    spec = LayeredSpec(algo="OMS", iters=10, early_term=False)
    step, chan, chan_fn, _, _, step_x = air.build_parts(code, spec, 64, "cpu")
    chan.configure(1.0)
    scan, schan = air.build_scan_step(code, spec, 64, 3, "cpu")
    schan.configure(1.0)
    seeds = [11, 12, 13]
    eager = torch.stack([step(chan.generator(s)) for s in seeds])
    assert torch.equal(scan(seeds), eager)
    assert int(eager[:, 1].sum()) > 0
    assert air.run_loop(step, chan, 2, 5, seed0=0) > 0
    assert air.run_loop_scan(scan, 2, 2, seed0=0) > 0
    # the stage callables: the whole step on the all-zero codeword
    tx = torch.zeros((64, code.N), dtype=torch.int8)
    assert step_x(tx).shape == (2,) and chan_fn(tx).dtype == torch.int8

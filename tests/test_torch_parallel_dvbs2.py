"""The port's row-sharded decode of ONE 16200x7560 frame (its Z=360 QC
view: deficient circulants and sub-pass layers) over 2 and 4 gloo ranks,
against the JAX package's one-device decode of the same view (XLA), ET on
and off.  Apart from ``tests/test_torch_parallel.py`` because JAX's
compiles of this view are slow."""

import functools

import numpy as np
import pytest
import torch

from ldpcgputegra_tpu.codes.registry import load_code as j_load_code
from ldpcgputegra_tpu.decoder import make_decoder as j_make_decoder
from ldpcgputegra_tpu.ops.layered import LayeredSpec as JSpec
from ldpcgputegra_tpu_torch.ops.layered import LayeredSpec
from ldpcgputegra_tpu_torch.parallel.dryrun import decode_cases
from ldpcgputegra_tpu_torch.parallel.launch import run_ranks

NAME = "16200x7560"
KW = {False: dict(algo="OMS", iters=2),
      True: dict(algo="OMS", iters=3, early_term=True)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _llr():
    rng = np.random.default_rng(7)
    return np.clip(8.0 * rng.normal(-1.0, 0.8, size=(1, 16200)), -31, 31
                   ).astype(np.int8)


@functools.lru_cache(maxsize=None)
def _ranks(world):
    cases = [{"kind": "rowshard", "code": NAME, "spec": LayeredSpec(**KW[et]),
              "llr": _llr()} for et in (False, True)]
    return run_ranks(decode_cases, world, (cases, "cpu"))


@functools.lru_cache(maxsize=None)
def _jax(et):
    bits, it = j_make_decoder(j_load_code(NAME), JSpec(**KW[et]),
                              backend="xla")(_llr())
    return np.asarray(bits), int(it)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("et", [False, True])
def test_rowshard_view_matches_jax(et, world):
    jbits, jit = _jax(et)
    for r in _ranks(world):
        np.testing.assert_array_equal(r[et]["bits"], jbits)
        assert r[et]["iters"] == jit
    assert jbits.sum() > 0  # two or three iterations leave errors here

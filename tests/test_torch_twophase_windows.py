"""Two-phase early termination over a window of batches on the CPU against
the JAX package, at ``tests/test_extras.py``'s window (576x288, OMS 8,
k1=4, three 256-frame batches): ``pipelined`` and ``pipelined_fused`` (a
tail of 128 that overflows, one of 256 that does not) equal JAX's in bits
and in every stats value, and the port's serial ``decode``; the warm
functions keep their contract.  The JAX reference is computed once.
"""

import numpy as np
import pytest
import torch

from ldpcgputegra_tpu.codes.registry import load_code as j_load_code
from ldpcgputegra_tpu.decoder.twophase import (
    make_twophase_decoder as j_make_twophase_decoder,
)
from ldpcgputegra_tpu.ops.layered import LayeredSpec as JSpec
from test_torch_twophase import _port


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the cores, and the
    many small tensor ops here run far slower on a pool of threads that
    competes with them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _window(n, seed):
    """Three 256-frame batches at std 0.8 (``test_extras.py``'s windows)."""
    rng = np.random.default_rng(seed)
    return [np.clip(8.0 * rng.normal(-1.0, 0.8, size=(256, n)), -31, 31)
            .astype(np.int8) for _ in range(3)]


@pytest.fixture(scope="module")
def windows():
    """576x288, OMS 8, k1=4, the window of seed 11: JAX's serial bits, and
    its pipelined and fused (tail 128 and 256) bits and stats."""
    code = j_load_code("576x288")
    llrs = _window(code.N, 11)
    tp = j_make_twophase_decoder(code, JSpec(algo="OMS", iters=8), k1=4,
                                 backend="xla")
    serial = [np.asarray(tp(x)[0]) for x in llrs]
    runs = {"pipelined": tp.pipelined(llrs)}
    for tail in (128, 256):
        runs[tail] = tp.pipelined_fused(llrs, tail=tail)
    return llrs, serial, {k: ([np.asarray(b) for b in outs], agg)
                          for k, (outs, agg) in runs.items()}


def test_pipelined_matches_jax_and_serial(windows):
    llrs, serial, runs = windows
    tp = _port(4, 8)
    xs = [torch.from_numpy(x) for x in llrs]
    outs, agg = tp.pipelined(xs)
    want_outs, want_agg = runs["pipelined"]
    for got, want, ser in zip(outs, want_outs, serial):
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got.numpy(), ser)
    assert agg == want_agg and agg["frames"] == 3 * 256
    for x, ser in zip(xs, serial):
        np.testing.assert_array_equal(tp(x)[0].numpy(), ser)


@pytest.mark.parametrize("tail", [128, 256])
def test_pipelined_fused_matches_jax_and_serial(windows, tail):
    """Tail 128 overflows (most batches hold more unconverged frames), so
    the repair path runs; tail 256 does not."""
    llrs, serial, runs = windows
    outs, agg = _port(4, 8).pipelined_fused(
        [torch.from_numpy(x) for x in llrs], tail=tail)
    want_outs, want_agg = runs[tail]
    for got, want, ser in zip(outs, want_outs, serial):
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got.numpy(), ser)
    assert agg == want_agg
    assert (agg["overflows"] > 0) == (tail == 128)


def test_warm_functions_keep_their_contract(windows):
    x = torch.from_numpy(windows[0][0])
    tp = _port(4, 8)
    assert tp.warm_buckets(x) == [128, 256]
    assert tp.warm_buckets(x[:64]) == [128]
    assert tp.warm_fused(x, 128) is None

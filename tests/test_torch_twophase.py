"""Two-phase early termination (``decoder/twophase.py``) on the CPU against
the JAX package's, at ``tests/test_extras.py``'s inputs and seeds: the
port's plain path (``backend="torch"``) against JAX's ``backend="xla"``,
equal in bits and in every stats value for ``decode`` (``pipelined`` and
``pipelined_fused`` are in ``test_torch_twophase_windows.py``, so that
the two modules' XLA compiles run on different workers); and
``syndrome_fn`` against JAX's, on the original code of a staircase code
too.  Each JAX reference is computed once per module.
"""

import numpy as np
import pytest
import torch

from ldpcgputegra_tpu.codes.registry import load_code as j_load_code
from ldpcgputegra_tpu.decoder.twophase import (
    make_twophase_decoder as j_make_twophase_decoder,
)
from ldpcgputegra_tpu.decoder.twophase import syndrome_fn as j_syndrome_fn
from ldpcgputegra_tpu.ops.layered import LayeredSpec as JSpec
from ldpcgputegra_tpu_torch.codes.registry import load_code
from ldpcgputegra_tpu_torch.decoder.twophase import (
    make_twophase_decoder,
    syndrome_fn,
)
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


@pytest.fixture(scope="module")
def per_frame():
    """576x288, OMS 10, k1=3, 64 frames from seed 17: the inputs, and JAX's
    bits and stats."""
    code = j_load_code("576x288")
    rng = np.random.default_rng(17)
    llr = np.clip(8.0 * (-1.0 + 0.75 * rng.normal(size=(64, code.N))), -31,
                  31).astype(np.int8)
    tp = j_make_twophase_decoder(code, JSpec(algo="OMS", iters=10), k1=3,
                                 backend="xla")
    bits, stats = tp(llr)
    return llr, np.asarray(bits), stats


def _port(k1, iters):
    return make_twophase_decoder(load_code("576x288"),
                                 LayeredSpec(algo="OMS", iters=iters), k1=k1,
                                 backend="torch", device="cpu")


def test_decode_matches_jax(per_frame):
    llr, want, want_stats = per_frame
    bits, stats = _port(3, 10)(torch.from_numpy(llr))
    np.testing.assert_array_equal(bits.numpy(), want)
    assert stats == want_stats
    assert 0 < stats["phase2_frames"] < 64  # the test is not trivial


def test_decode_keeps_converged_frames_and_redecodes_the_rest(per_frame):
    """Frames converged at k1 keep their k1-iteration bits; the rest get
    the full budget's (the output contract, on the port alone)."""
    llr = torch.from_numpy(per_frame[0])
    code = load_code("576x288")
    bits, stats = _port(3, 10)(llr)
    b3 = make_layered_decoder(code, LayeredSpec(algo="OMS", iters=3))(llr)[0]
    b10 = make_layered_decoder(code, LayeredSpec(algo="OMS", iters=10))(llr)[0]
    ok3 = syndrome_fn(code, "cpu")(b3)
    assert stats["phase2_frames"] == int((~ok3).sum())
    assert torch.equal(bits[ok3], b3[ok3]) and torch.equal(bits[~ok3],
                                                           b10[~ok3])


@pytest.mark.parametrize("name", ["576x288", "4000x2000", "16200x7560"])
def test_syndrome_fn_matches_jax(name):
    """Random bits, the all-zero codeword, and single-bit errors of it; on
    16200x7560 the original code's edges and column order, not its QC
    view's."""
    code = load_code(name)
    rng = np.random.default_rng(23)
    bits = np.zeros((12, code.N), np.uint8)
    bits[:6] = rng.integers(0, 2, (6, code.N), dtype=np.uint8)
    bits[np.arange(7, 12), rng.integers(0, code.N, 5)] = 1
    got = syndrome_fn(code, "cpu")(torch.from_numpy(bits))
    want = np.asarray(j_syndrome_fn(j_load_code(name))(bits))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[6] and not want[7:].any()

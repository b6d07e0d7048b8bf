"""The plain PyTorch layered decoder against the JAX package's Pallas
kernel (K1, ``make_pallas_decoder``) run in interpret mode on the CPU:
bit-exact in bits and ``iters_used``, with early termination off and on.

The Pallas kernel pads the batch to 128 lanes and odd Z to a multiple of
8; neither may change a result, so a ragged batch is used.
"""

import numpy as np
import pytest
import torch

from ldpcgputegra_tpu.codes.registry import load_code as j_load_code
from ldpcgputegra_tpu.kernels import make_pallas_decoder
from ldpcgputegra_tpu.ops.layered import LayeredSpec as JSpec
from ldpcgputegra_tpu_torch.codes.registry import load_code
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


@pytest.mark.parametrize("et", [False, True])
@pytest.mark.parametrize("name", ["576x288", "1944x972", "2304x1152"])
def test_plain_matches_pallas_interpret(name, et):
    code = load_code(name)
    B = 100
    rng = np.random.default_rng(17)
    std = np.linspace(0.35, 0.8, B)[:, None]
    llr = np.clip(8.0 * (-1.0 + std * rng.standard_normal((B, code.N))),
                  -31, 31).astype(np.int8)
    kw = dict(algo="OMS", iters=3, early_term=et)
    bits, iters = make_layered_decoder(code, LayeredSpec(**kw))(
        torch.from_numpy(llr))
    rb, ri = make_pallas_decoder(j_load_code(name), JSpec(**kw),
                                 interpret=True)(llr)
    np.testing.assert_array_equal(bits.numpy(), np.asarray(rb))
    assert int(iters) == int(ri)

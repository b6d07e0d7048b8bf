"""The plain PyTorch decoder against the JAX package's Pallas gather
kernels run in interpret mode on the CPU: K3 (the unrolled
``_build_kernel``) and K4 (the chunked ``_build_chunked_kernel``), which
the port's one CUDA gather kernel replaces.  Bit-exact in bits and
``iters_used``.

Each case decodes a random (3, 6)-regular code in the colored schedule
with early termination on and a ragged batch (the Pallas kernels pad the
batch to whole tiles; that must not change a result).  Interpret mode is
slow (tens of seconds per decode), so there is one case per kernel; K5 is
in ``test_torch_gather_pallas_stream.py``.
"""

import numpy as np
import pytest
import torch

from ldpcgputegra_tpu.codes.registry import make_random_regular_code as j_code
from ldpcgputegra_tpu.kernels.pallas_gather import make_gather_decoder
from ldpcgputegra_tpu.ops.layered import LayeredSpec as JSpec
from ldpcgputegra_tpu_torch.codes.registry import make_random_regular_code
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


KW = dict(algo="OMS", iters=2, early_term=True, schedule="colored")


def check_against_pallas(**pallas_kw):
    code = make_random_regular_code(256, 128, 6, seed=9)
    rng = np.random.default_rng(21)
    std = np.linspace(0.3, 0.8, 5)[:, None]
    llr = np.clip(8.0 * (-1.0 + std * rng.standard_normal((5, code.N))),
                  -31, 31).astype(np.int8)
    bits, iters = make_layered_decoder(code, LayeredSpec(**KW))(
        torch.from_numpy(llr))
    rb, ri = make_gather_decoder(j_code(256, 128, 6, seed=9), JSpec(**KW),
                                 interpret=True, **pallas_kw)(llr)
    np.testing.assert_array_equal(bits.numpy(), np.asarray(rb))
    assert int(iters) == int(ri)


@pytest.mark.parametrize("kernel,pallas_kw", [
    ("K3", dict(chunked=False)),
    ("K4", dict(chunked=True, sublanes=2)),
])
def test_plain_matches_pallas_gather_interpret(kernel, pallas_kw):
    check_against_pallas(**pallas_kw)

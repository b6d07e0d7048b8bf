"""The plain PyTorch decoder against the JAX package's XLA decoder on
2048x384, the registry's code of check degree 32: bit-exact in bits and
``iters_used``.  In a file of its own because the XLA compile of 32-edge
checks takes about a minute here.
"""

import pytest

from test_torch_gather import _check, _one_torch_thread  # noqa: F401


@pytest.mark.parametrize("et", [False, True])
def test_plain_matches_jax_degree_32(et):
    _check("2048x384", dict(algo="OMS", iters=3, early_term=et))

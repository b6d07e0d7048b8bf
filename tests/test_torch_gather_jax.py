"""The plain PyTorch decoder against the JAX package's XLA decoder on the
registry's non-QC codes in the auto (colored) schedule: bit-exact in bits
and ``iters_used``.  In a file of its own so that these XLA compiles and
the rest of ``test_torch_gather.py`` run on different workers.
"""

import pytest

from test_torch_gather import _check, _one_torch_thread  # noqa: F401


@pytest.mark.parametrize("et", [False, True])
@pytest.mark.parametrize("name", ["4000x2000", "8000x4000", "9972x4986",
                                  "20000x10000", "1024x518"])
def test_plain_matches_jax_non_qc(name, et):
    """B=16, 3 iterations."""
    _check(name, dict(algo="OMS", iters=3, early_term=et))

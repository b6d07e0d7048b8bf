"""The convergence mask (``emit_mask``) on the CPU against the JAX package:
the QC kernel's wrapper (``make_cuda_decoder(..., emit_mask=True)``, whose
plain version runs on CPU tensors) against K1 in interpret mode
(``make_pallas_decoder(..., interpret=True, emit_mask=True)``) at
``tests/test_pallas.py``'s settings, in bits, ``iters_used`` and ``ok``;
``make_decoder(emit_mask=True)`` on the other backends against JAX's
``_with_mask``, a staircase code's original edges included; and the
refusal to combine the mask with early termination.  Each JAX reference is
computed once per module.
"""

import functools

import numpy as np
import pytest
import torch

from ldpcgputegra_tpu.codes.registry import load_code as j_load_code
from ldpcgputegra_tpu.decoder import make_decoder as j_make_decoder
from ldpcgputegra_tpu.kernels import make_pallas_decoder
from ldpcgputegra_tpu.ops.layered import LayeredSpec as JSpec
from ldpcgputegra_tpu_torch.codes.registry import load_code
from ldpcgputegra_tpu_torch.decoder import backend_for, make_decoder
from ldpcgputegra_tpu_torch.decoder.twophase import syndrome_fn
from ldpcgputegra_tpu_torch.kernels.layered import make_cuda_decoder
from ldpcgputegra_tpu_torch.ops.layered import LayeredSpec

# (B, OMS iterations, seed, noise std): test_pallas.py's mixed batch (about
# 35 of 48 frames converged at 4 iterations) and its ragged one


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the cores, and the
    many small tensor ops here run far slower on a pool of threads that
    competes with them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


PALLAS_CASES = {"mixed-128": (128, 4, 21, 0.75), "ragged-70": (70, 2, 3, 0.8)}


@functools.cache
def _pallas(case):
    B, iters, seed, std = PALLAS_CASES[case]
    code = j_load_code("576x288")
    llr = np.clip(8.0 * np.random.default_rng(seed).normal(-1.0, std,
                                                           (B, code.N)),
                  -31, 31).astype(np.int8)
    dec = make_pallas_decoder(code, JSpec(algo="OMS", iters=iters),
                              batch_tile=128, interpret=True, emit_mask=True)
    bits, it, ok = dec(llr)
    return llr, np.asarray(bits), int(it), np.asarray(ok)


@pytest.mark.parametrize("case", sorted(PALLAS_CASES))
def test_mask_matches_pallas_interpret(case):
    llr, want_bits, want_iters, want_ok = _pallas(case)
    B, iters, _, _ = PALLAS_CASES[case]
    dec = make_cuda_decoder(load_code("576x288"),
                            LayeredSpec(algo="OMS", iters=iters),
                            emit_mask=True)
    bits, it, ok = dec(torch.from_numpy(llr))
    np.testing.assert_array_equal(bits.numpy(), want_bits)
    assert int(it) == want_iters
    assert ok.dtype == torch.bool and ok.shape == (B,)
    np.testing.assert_array_equal(ok.numpy(), want_ok)
    if case == "mixed-128":
        assert 0 < int(ok.sum()) < B, "the batch must be mixed"


def _spread(n, b, seed):
    rng = np.random.default_rng(seed)
    std = np.linspace(0.2, 0.9, b)[:, None]
    return np.clip(8.0 * (-1.0 + std * rng.standard_normal((b, n))), -31,
                   31).astype(np.int8)


@functools.cache
def _with_mask(name):
    """JAX's ``make_decoder(emit_mask=True)`` (XLA, then ``_with_mask``
    on the original code) on 16 frames of spread noise, OMS 3."""
    code = j_load_code(name)
    llr = _spread(code.N, 16, seed=3)
    bits, it, ok = j_make_decoder(code, JSpec(algo="OMS", iters=3),
                                  emit_mask=True)(llr)
    return llr, np.asarray(bits), int(it), np.asarray(ok)


@pytest.mark.parametrize("name,backend", [
    ("16200x7560", "torch"), ("16200x7560", "cuda-streamed"),
    ("4000x2000", "torch"), ("4000x2000", "cuda-gather")])
def test_make_decoder_mask_matches_jax(name, backend):
    """A staircase code decodes through its QC view, and the mask is the
    syndrome of the original code (the view's table still holds the
    deficient circulant's spurious edge); the kernel backends run their
    plain versions on CPU tensors."""
    llr, want_bits, want_iters, want_ok = _with_mask(name)
    code = load_code(name)
    dec = make_decoder(code, LayeredSpec(algo="OMS", iters=3), backend,
                       device="cpu", emit_mask=True)
    bits, it, ok = dec(torch.from_numpy(llr))
    np.testing.assert_array_equal(bits.numpy(), want_bits)
    assert int(it) == want_iters
    np.testing.assert_array_equal(ok.numpy(), want_ok)
    assert torch.equal(ok, syndrome_fn(code, "cpu")(bits))
    assert 0 < int(ok.sum()) < 16, "the batch must be mixed"


def test_mask_refuses_early_termination():
    code = load_code("576x288")
    spec = LayeredSpec(early_term=True)
    with pytest.raises(ValueError, match="early_term"):
        make_cuda_decoder(code, spec, emit_mask=True)
    assert backend_for(code, spec, "cuda") == "cuda"
    with pytest.raises(ValueError, match="early_term"):
        make_decoder(code, spec, device="cuda", emit_mask=True)

"""The port's ``DecodeStream`` (``decoder/stream.py``) on the CPU: results
in submission order equal to direct decodes, a bounded window, ``pending``
and ``drain``; the same API as the JAX package's."""

import inspect

import numpy as np
import pytest
import torch

from ldpcgputegra_tpu.decoder.stream import DecodeStream as JStream
from ldpcgputegra_tpu_torch.codes.registry import load_code
from ldpcgputegra_tpu_torch.decoder import make_decoder
from ldpcgputegra_tpu_torch.decoder.stream import DecodeStream
from ldpcgputegra_tpu_torch.ops.layered import LayeredSpec


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the cores, and the
    many small tensor ops here run far slower on a pool of threads that
    competes with them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batches(n, count, b=16):
    rng = np.random.default_rng(9)
    return [torch.from_numpy(np.clip(
        8.0 * (-1.0 + (0.9 + 0.1 * i) * rng.standard_normal((b, n))),
        -31, 31).astype(np.int8)) for i in range(count)]


def test_stream_results_in_order_and_equal_direct_decodes():
    code = load_code("576x288")
    spec = LayeredSpec(algo="OMS", iters=5, early_term=True)
    xs = _batches(code.N, 5)
    direct = make_decoder(code, spec, device="cpu")
    st = DecodeStream(code, spec, depth=2, device="cpu")
    assert st.pending == 0 and st.get() is None
    for i, x in enumerate(xs):
        st.submit(x)
        assert st.pending == i + 1
        assert len(st._inflight) <= 2  # the window holds at most depth
    got = [st.get()]
    assert st.pending == 4
    got += list(st.drain())
    assert st.pending == 0 and st.get() is None
    assert len(got) == 5
    for x, (bits, iters) in zip(xs, got):
        ref_bits, ref_iters = direct(x)
        assert isinstance(bits, np.ndarray) and isinstance(iters, int)
        np.testing.assert_array_equal(bits, ref_bits.numpy())
        assert iters == int(ref_iters)
    assert len({b.tobytes() for b, _ in got}) == 5  # five distinct results


def test_stream_api_matches_jax():
    for name in ("submit", "get", "drain"):
        assert list(inspect.signature(getattr(JStream, name)).parameters) == \
            list(inspect.signature(getattr(DecodeStream, name)).parameters)
    assert isinstance(DecodeStream.pending, property)
    jp = list(inspect.signature(JStream.__init__).parameters)
    assert list(inspect.signature(DecodeStream.__init__).parameters)[
        :len(jp)] == jp

"""The port's encoders (``channel/encoder.py``, PyTorch on the info bits'
device) against the JAX package's on the same NumPy info bits, bit for
bit; every codeword checked against H by the port's ``syndrome_ok``; the
info-bit generator (``channel/bitgen.py``)."""

import numpy as np
import pytest
import torch

from ldpcgputegra_tpu.channel.encoder import make_encoder as j_make_encoder
from ldpcgputegra_tpu.codes.registry import load_code as j_load_code
from ldpcgputegra_tpu_torch.channel.bitgen import generate_info_bits
from ldpcgputegra_tpu_torch.channel.encoder import (
    FakeEncoder,
    GF2Encoder,
    QCAccumulateEncoder,
    StaircaseEncoder,
    make_encoder,
)
from ldpcgputegra_tpu_torch.codes.registry import load_code
from ldpcgputegra_tpu_torch.golden import syndrome_ok


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the cores, and the
    many small tensor ops here run far slower on a pool of threads that
    competes with them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CASES = [
    ("576x288", "gf2", GF2Encoder),
    ("1944x972", "gf2", GF2Encoder),
    ("2048x384", "gf2", GF2Encoder),  # rank-deficient H
    ("16200x7560", "staircase", StaircaseEncoder),
    ("16200x10800", "table", QCAccumulateEncoder),
    ("576x288", "fake", FakeEncoder),
]


@pytest.mark.parametrize("name,kind,cls", CASES)
def test_encoder_matches_jax(name, kind, cls):
    code = load_code(name)
    info = np.random.default_rng(len(name)).integers(0, 2, (6, code.K),
                                                     dtype=np.int8)
    enc = make_encoder(code, kind)
    assert type(enc) is cls
    got = enc.encode(torch.from_numpy(info))
    assert got.dtype == torch.int8 and got.shape == (6, code.N)
    ref = j_make_encoder(j_load_code(name), kind).encode(info)
    np.testing.assert_array_equal(got.numpy(), ref)
    for frame in got.numpy():
        assert syndrome_ok(code, frame)
    if kind != "fake":
        assert got.any()


def test_gf2_rank_deficient_keeps_info_and_zero_columns():
    code = load_code("2048x384")
    enc = GF2Encoder(code)
    assert enc.zero_cols.size > 0  # more free columns than K
    info = np.ones((2, code.K), np.int8)
    out = enc.encode(torch.from_numpy(info)).numpy()
    assert (out[:, enc.info_cols] == 1).all()
    assert not out[:, enc.zero_cols].any()


def test_make_encoder_auto_and_refusals():
    assert isinstance(make_encoder(load_code("16200x10800"), "auto"),
                      QCAccumulateEncoder)
    assert isinstance(make_encoder(load_code("16200x7560"), "auto"),
                      StaircaseEncoder)
    assert isinstance(make_encoder(load_code("576x288"), "auto"), GF2Encoder)
    with pytest.raises(ValueError, match="not staircase"):
        make_encoder(load_code("576x288"), "staircase")
    with pytest.raises(ValueError, match="too large"):
        make_encoder(load_code("64800x32400"), "gf2")
    with pytest.raises(ValueError, match="unknown encoder"):
        make_encoder(load_code("576x288"), "bogus")
    enc = make_encoder(load_code("576x288"), "gf2")
    with pytest.raises(ValueError):
        enc.encode(torch.zeros((2, 287), dtype=torch.int8))


def test_info_bits_from_a_generator():
    gen = torch.Generator().manual_seed(5)
    a = generate_info_bits(gen, 64, 1000)
    b = generate_info_bits(torch.Generator().manual_seed(5), 64, 1000)
    assert a.dtype == torch.int8 and a.shape == (64, 1000)
    assert torch.equal(a, b)  # a seed fixes the bits
    assert set(a.unique().tolist()) == {0, 1}
    # 64000 fair bits: the mean within 5 sigma of 1/2
    assert abs(float(a.float().mean()) - 0.5) < 5 * 0.5 / 64000 ** 0.5
    z = generate_info_bits(gen, 4, 10, random_bits=False)
    assert not z.any() and z.dtype == torch.int8

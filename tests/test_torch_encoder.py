"""The port's encoders (``channel/encoder.py``, PyTorch on the info bits'
device) against the JAX package's on the same NumPy info bits, bit for
bit; every codeword checked against H by the port's ``syndrome_ok``; the
table and staircase encoders' parity table (``kernels/encoder.py::
parity_table``) against the standard's table and H's rows, and their
plain form against the JAX encoders at B = 1, 3 and 512, with the digests
of the JAX codewords that the card test holds the kernel to
(``tests/vectors/accumulate_encoder_sha256.json``); the info-bit
generator (``channel/bitgen.py``)."""

import hashlib
import json
import os

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
    _check_rows_in_parity_order,
    make_encoder,
)
from ldpcgputegra_tpu_torch.codes.registry import DATA_DIR, load_code
from ldpcgputegra_tpu_torch.golden import syndrome_ok
from ldpcgputegra_tpu_torch.kernels.encoder import accumulate_plain


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
    ("64800x32400", "staircase", StaircaseEncoder),
    ("64800x6480-dvbs2", "staircase", StaircaseEncoder),  # K > 32767
]
ACCUMULATE = [(name, kind) for name, kind, _ in CASES
              if kind in ("table", "staircase")]
DIGESTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "vectors",
                       "accumulate_encoder_sha256.json")


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


def _pairs(row_ptr, cols):
    """A parity table's (row, info bit) pairs, sorted."""
    rows = np.repeat(np.arange(row_ptr.size - 1), np.diff(row_ptr))
    return sorted(zip(rows.tolist(), cols.tolist()))


def test_parity_table_holds_every_pair_once():
    """The table encoder's parity table at 16200x10800 holds each pair of
    the standard's table (info bit x of group g at parity row (a + (x mod
    360) q) mod 5400, a on line g) exactly once: 5400 rows of degree 8,
    43200 entries, int16 columns."""
    code = load_code("16200x10800")
    enc = make_encoder(code, "table")
    with open(os.path.join(DATA_DIR, "encoder_16200x10800.json")) as f:
        doc = json.load(f)
    m, q = doc["M"], doc["Q"]
    want = sorted(((a + (x % m) * q) % (code.N - code.K), x)
                  for g, line in enumerate(doc["rows"])
                  for x in range(g * m, (g + 1) * m) for a in line)
    assert enc._row_ptr.dtype == np.int32 and enc._cols.dtype == np.int16
    assert enc._row_ptr.size == 5401 and enc._row_ptr[-1] == 43200
    assert (np.diff(enc._row_ptr) == 8).all()
    assert _pairs(enc._row_ptr, enc._cols) == want


@pytest.mark.parametrize("name", [n for n, k in ACCUMULATE
                                  if k == "staircase"])
def test_staircase_rows_keep_their_degrees(name):
    """A staircase encoder's parity table holds each check row's info
    bits in H's row order, row j's degree its row's; int16 columns where
    K < 32768, else int32."""
    code = load_code(name)
    enc = make_encoder(code, "staircase")
    rows = _check_rows_in_parity_order(code)
    assert enc._cols.dtype == (np.int16 if code.K < 32768 else np.int32)
    assert np.diff(enc._row_ptr).tolist() == [r.size for r in rows]
    for j in (0, 1, len(rows) // 2, len(rows) - 1):
        got = enc._cols[enc._row_ptr[j]:enc._row_ptr[j + 1]]
        assert got.tolist() == rows[j].tolist()
    assert _pairs(enc._row_ptr, enc._cols) == sorted(
        (j, int(c)) for j, r in enumerate(rows) for c in r)


@pytest.mark.parametrize("name,kind", ACCUMULATE)
def test_plain_form_matches_jax(name, kind):
    """The plain form on the encoder's parity table gives the JAX
    encoder's codewords at B = 1, 3 and 512, whose digests are the file's
    that the card test holds the kernel to."""
    code = load_code(name)
    enc = make_encoder(code, kind)
    jenc = j_make_encoder(j_load_code(name), kind)
    with open(DIGESTS) as f:
        want = json.load(f)["codewords"][f"{name} {kind}"]
    row_ptr, cols = torch.from_numpy(enc._row_ptr), torch.from_numpy(enc._cols)
    for batch in (1, 3, 512):
        info = np.random.default_rng(27000 + batch).integers(
            0, 2, (batch, code.K), dtype=np.int8)
        ref = jenc.encode(info)
        got = accumulate_plain(torch.from_numpy(info), row_ptr, cols, code.N)
        np.testing.assert_array_equal(got.numpy(), ref)
        assert hashlib.sha256(ref.tobytes()).hexdigest() == want[str(batch)]


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

"""The accumulate encoders' kernel on the card (``kernels/encoder.py``,
``csrc/encoder.cu``) against its plain PyTorch version and the JAX
package's encoders: the table and staircase encoders' codewords at B = 1,
3 and 512, byte for byte against the plain version on the card and by
SHA-256 against the JAX encoders' codewords of the same info bits
(``tests/vectors/accumulate_encoder_sha256.json``, which
``tests/test_torch_encoder.py`` holds to the JAX encoders on the CPU);
tables of any degree, an odd K and misaligned rows against the plain
version; a CUDA graph of ``encode`` replayed to the eager bytes; the
launches counted a call and 16 a replay of ``sim/scan.py``'s graph; a
K past a CTA's shared memory refused.  Every test here needs an NVIDIA
GPU and skips without one.

On a machine with a card (and without jax, which ``tests/conftest.py``
imports), run:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_encoder.py -q
"""

import functools
import hashlib
import json
import os

import numpy as np
import pytest
import torch

from ldpcgputegra_tpu_torch.channel.encoder import make_encoder
from ldpcgputegra_tpu_torch.codes.registry import load_code
from ldpcgputegra_tpu_torch.kernels import encoder as KE

pytestmark = pytest.mark.cuda

DIGESTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "vectors",
                       "accumulate_encoder_sha256.json")
# the table and staircase cases of tests/test_torch_encoder.py
CASES = [("16200x7560", "staircase"), ("16200x10800", "table"),
         ("64800x32400", "staircase"), ("64800x6480-dvbs2", "staircase")]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    KE.build()
    return torch.device("cuda", 0)


@functools.cache
def _encoder(name, kind):
    return make_encoder(load_code(name), kind)


def _info(k, batch):
    """The info bits of the digests' file, for ``batch`` frames."""
    return np.random.default_rng(27000 + batch).integers(
        0, 2, (batch, k), dtype=np.int8)


@pytest.mark.parametrize("name,kind", CASES)
@pytest.mark.parametrize("batch", [1, 3, 512])
def test_kernel_equals_plain_and_jax(dev, name, kind, batch):
    """``encode`` on the card launches the kernel once and gives the plain
    version's bytes and the JAX encoder's codewords."""
    enc = _encoder(name, kind)
    u = torch.from_numpy(_info(enc.k, batch)).to(dev)
    before = KE.launches["accumulate_encode"]
    got = enc.encode(u)
    assert KE.launches["accumulate_encode"] == before + 1
    assert got.dtype == torch.int8 and got.shape == (batch, enc.n)
    row_ptr, cols = enc._on(dev, enc._row_ptr, enc._cols)
    assert torch.equal(got, KE.accumulate_plain(u, row_ptr, cols, enc.n))
    with open(DIGESTS) as f:
        want = json.load(f)["codewords"][f"{name} {kind}"][str(batch)]
    assert hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest() == want


def _random_table(k, m, seed):
    """A parity table of ``m`` rows of degree 0-40 over ``k`` info bits,
    the first row and a middle one empty."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 41, m)
    deg[0] = deg[m // 2] = 0
    rows = np.repeat(np.arange(m), deg)
    return KE.parity_table(rows, rng.integers(0, k, rows.size), m, k)


@pytest.mark.parametrize("k,m,batch", [(1001, 333, 37), (37, 5, 3),
                                       (4096, 700, 64), (8, 1, 1)])
@pytest.mark.parametrize("layout", ["contiguous", "offset", "int32"])
def test_kernel_on_any_table(dev, k, m, batch, layout):
    """Rows of any degree, empty ones, any K, info bytes other than 0 and
    1 (a bit is the low bit, the systematic part the bytes), the info
    rows off an 8-byte boundary (the byte path) and int32 columns: the
    plain version's bytes."""
    row_ptr, cols = _random_table(k, m, k + m)
    row_ptr = torch.from_numpy(row_ptr).to(dev)
    cols = torch.from_numpy(cols).to(dev)
    if layout == "int32":
        cols = cols.int()
    u = torch.from_numpy(np.random.default_rng(k).integers(
        -128, 128, (batch, k), dtype=np.int8)).to(dev)
    if layout == "offset":
        u = torch.cat([u.new_zeros(1), u.flatten()])[1:].view(batch, k)
        assert u.is_contiguous() and u.data_ptr() % 8
    got = KE.accumulate_encode(u, row_ptr, cols, k + m)
    assert torch.equal(got, KE.accumulate_plain(u, row_ptr, cols, k + m))


def test_graph_replays_the_eager_bytes(dev):
    """A CUDA graph of ``encode`` on a fixed input replays to the bytes an
    eager encode of the input's new bits gives."""
    enc = _encoder("16200x10800", "table")
    u = torch.from_numpy(_info(enc.k, 512)).to(dev)
    enc.encode(u)  # the table copied and the library loaded, uncaptured
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        graph.capture_begin()
        out = enc.encode(u)
        graph.capture_end()
    torch.cuda.current_stream(dev).wait_stream(side)
    for seed in (3, 4):
        u.copy_(torch.from_numpy(np.random.default_rng(seed).integers(
            0, 2, u.shape, dtype=np.int8)))
        graph.replay()
        assert torch.equal(out, enc.encode(u))


@pytest.mark.parametrize("name,kind", [("16200x10800", "table"),
                                       ("16200x7560", "staircase")])
def test_scan_counts_the_launches(dev, name, kind):
    """``sim/scan.py``'s graph of 16 batches (the info bits' draw and the
    encode) launches the kernel 16 times a replay, the capture's eager
    warm-up batch once, and counts what eager batches count."""
    from ldpcgputegra_tpu_torch.channel.bitgen import generate_info_bits
    from ldpcgputegra_tpu_torch.sim.scan import ScanSteps

    enc = _encoder(name, kind)

    def step(g):
        coded = enc.encode(generate_info_bits(g, 128, enc.k))
        return torch.stack([coded.sum(dtype=torch.int64),
                            coded[:, enc.k:].sum(dtype=torch.int64)])

    scan = ScanSteps(step, 16, dev)
    for i, seeds in enumerate((range(100, 116), range(200, 216))):
        before = KE.launches["accumulate_encode"]
        out = scan(list(seeds))
        torch.cuda.synchronize()
        assert KE.launches["accumulate_encode"] - before == 16 + (i == 0)
        eager = torch.stack([step(torch.Generator(dev).manual_seed(s))
                             for s in seeds])
        assert torch.equal(out, eager)
    assert scan.replayed(KE.launches) == {"accumulate_encode": 16}


def test_kernel_refuses_what_shared_memory_cannot_hold(dev):
    """Info bytes and a table past a CTA's shared memory: the C entry
    refuses them, and the wrapper raises and counts no launch."""
    k = 240000
    row_ptr = torch.tensor([0, 1], dtype=torch.int32, device=dev)
    cols = torch.zeros(1, dtype=torch.int32, device=dev)
    u = torch.zeros((1, k), dtype=torch.int8, device=dev)
    before = KE.launches["accumulate_encode"]
    with pytest.raises(RuntimeError, match="accumulate_encode"):
        KE.accumulate_encode(u, row_ptr, cols, k + 1)
    assert KE.launches["accumulate_encode"] == before

"""The CUDA kernels (the QC layered min-sum kernel, the gather kernel for
any layers and the streamed kernel for QC codes and views beyond shared
memory) against their plain PyTorch version, on the card.  Every test
here needs an NVIDIA GPU and skips without one.

On a machine with a card (and without jax, which ``tests/conftest.py``
imports), run:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import glob
import os

import numpy as np
import pytest
import torch

from ldpcgputegra_tpu_torch.codes.code import LdpcCode
from ldpcgputegra_tpu_torch.codes.dvbs2 import to_qc_form
from ldpcgputegra_tpu_torch.codes.registry import (
    load_code,
    make_qc_code,
    make_random_qc_code,
)
from ldpcgputegra_tpu_torch.decoder import effective_code
from ldpcgputegra_tpu_torch.kernels import gather as G
from ldpcgputegra_tpu_torch.kernels import layered as K
from ldpcgputegra_tpu_torch.kernels import streamed as S
from ldpcgputegra_tpu_torch.ops.layered import LayeredSpec, make_layered_decoder

pytestmark = pytest.mark.cuda

VEC_DIR = os.path.join(os.path.dirname(__file__), "vectors")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _llrs(n, b, seed, std=0.8):
    rng = np.random.default_rng(seed)
    return np.clip(8.0 * rng.normal(-1.0, std, size=(b, n)), -31, 31).astype(
        np.int8)


@pytest.mark.parametrize("name", ["576x288", "1944x972", "2304x1152",
                                  "155x93", "1248x624"])
@pytest.mark.parametrize("algo,minclamp", [("OMS", "pre"), ("MS", "post"),
                                           ("NMS", "pre"), ("2NMS", "post")])
@pytest.mark.parametrize("et", [False, True])
def test_kernel_matches_plain(dev, name, algo, minclamp, et):
    code = load_code(name)
    spec = LayeredSpec(algo=algo, iters=6, minclamp=minclamp, early_term=et)
    llr = torch.from_numpy(_llrs(code.N, 257, seed=3, std=0.6)).to(dev)
    kb, ki = K.make_cuda_decoder(code, spec)(llr)
    pb, pi = make_layered_decoder(code, spec, dev)(llr)
    assert torch.equal(kb, pb)
    assert int(ki) == int(pi)


def test_kernel_golden_vectors(dev):
    paths = [p for p in sorted(glob.glob(os.path.join(VEC_DIR, "*.npz")))
             if not os.path.basename(p).startswith("refcheck_")]
    for path in paths:
        d = np.load(path)
        spec = LayeredSpec(algo=str(d["algo"]), iters=int(d["iters"]),
                           minclamp=str(d["minclamp"]), offset=int(d["offset"]))
        dec = K.make_cuda_decoder(load_code(str(d["code"])), spec)
        bits, _ = dec(torch.from_numpy(d["llr"]).to(dev))
        np.testing.assert_array_equal(bits.cpu().numpy(), d["bits"], path)


def test_kernel_counts_launches_and_checks_inputs(dev):
    code = load_code("576x288")
    dec = K.make_cuda_decoder(code, LayeredSpec(iters=3))
    llr = torch.from_numpy(_llrs(code.N, 64, seed=1)).to(dev)
    before = K.launches["layered_minsum"]
    dec(llr)
    assert K.launches["layered_minsum"] == before + 1
    with pytest.raises(TypeError):
        dec(llr.to(torch.int16))
    with pytest.raises(ValueError):
        dec(llr.t().contiguous().t())  # not contiguous
    with pytest.raises(ValueError):
        dec(llr[:, :-1].contiguous())
    assert K.launches["layered_minsum"] == before + 1


@pytest.mark.parametrize("name", ["200x100", "1024x518", "2048x384",
                                  "4000x2000"])
@pytest.mark.parametrize("algo,minclamp", [("OMS", "pre"), ("MS", "post"),
                                           ("NMS", "pre"), ("2NMS", "post")])
@pytest.mark.parametrize("et", [False, True])
def test_gather_kernel_matches_plain(dev, name, algo, minclamp, et):
    code = load_code(name)
    spec = LayeredSpec(algo=algo, iters=6, minclamp=minclamp, early_term=et)
    llr = torch.from_numpy(_llrs(code.N, 257, seed=5, std=0.6)).to(dev)
    kb, ki = G.make_gather_decoder(code, spec)(llr)
    pb, pi = make_layered_decoder(code, spec, dev)(llr)
    assert torch.equal(kb, pb)
    assert int(ki) == int(pi)


@pytest.mark.parametrize("tile,name", [(32, "200x100"), (16, "1024x518"),
                                       (8, "4000x2000")])
def test_gather_kernel_every_tile(dev, tile, name):
    """Each tile width the kernel ships, through a code that picks it."""
    code = load_code(name)
    spec = LayeredSpec(iters=5, early_term=True)
    assert G.pick_tile(code, spec) == tile
    llr = torch.from_numpy(_llrs(code.N, 100, seed=6, std=0.6)).to(dev)
    kb, ki = G.make_gather_decoder(code, spec)(llr)
    pb, pi = make_layered_decoder(code, spec, dev)(llr)
    assert torch.equal(kb, pb) and int(ki) == int(pi)


def test_gather_kernel_counts_launches_and_checks_inputs(dev):
    code = load_code("816x408")
    dec = G.make_gather_decoder(code, LayeredSpec(iters=3))
    llr = torch.from_numpy(_llrs(code.N, 64, seed=1)).to(dev)
    before = G.launches["gather_minsum"]
    dec(llr)
    assert G.launches["gather_minsum"] == before + 1
    with pytest.raises(TypeError):
        dec(llr.to(torch.int16))
    with pytest.raises(ValueError):
        dec(llr.t().contiguous().t())  # not contiguous
    with pytest.raises(ValueError):
        dec(llr[:, :-1].contiguous())
    assert G.launches["gather_minsum"] == before + 1


_TOY = np.array([[0, 2, -1, 5, 1, -1, 3, 0],
                 [4, -1, 1, 0, -1, 2, 0, 6],
                 [-1, 3, 0, -1, 6, 0, 2, 1]])


def _small_staircase_view():
    """A z=8, q=3 staircase code (two info groups) QC-ified at z=8: its
    view has col_perm, the deficient circulant and sub-pass layers."""
    z, q, table = 8, 3, [[0, 3, 4, 7], [2, 5, 6]]
    M, K = z * q, z * len(table)
    rows = [{K + r} | ({K + r - 1} if r else set()) for r in range(M)]
    for g, line in enumerate(table):
        for t in range(z):
            for p in line:
                rows[(p + t * q) % M].add(g * z + t)
    degs = sorted({len(r) for r in rows}, reverse=True)
    classes = [(d, sum(len(r) == d for r in rows)) for d in degs]
    edges = np.concatenate([sorted(r) for d in degs for r in rows
                            if len(r) == d]).astype(np.int32)
    raw = LdpcCode.from_edges("stair40", K + M, K, classes, edges,
                              detect_qc=False)
    return to_qc_form(raw, z=z)


def _streamed_code(name):
    if name == "toy8":
        return make_qc_code("toy8", _TOY, Z=8)
    if name == "stair40":
        return _small_staircase_view()
    if name == "randqc":
        return make_random_qc_code(24, 12, 5, Z=32, seed=3)
    return effective_code(load_code(name))


@pytest.mark.parametrize("name", ["toy8", "stair40", "randqc", "16200x7560",
                                  "16200x10800", "200x100"])
@pytest.mark.parametrize("algo,minclamp", [("OMS", "pre"), ("MS", "post"),
                                           ("NMS", "pre"), ("2NMS", "post")])
@pytest.mark.parametrize("et", [False, True])
def test_streamed_kernel_matches_plain(dev, name, algo, minclamp, et):
    code = _streamed_code(name)
    spec = LayeredSpec(algo=algo, iters=6, minclamp=minclamp, early_term=et)
    llr = torch.from_numpy(_llrs(code.N, 257, seed=7, std=0.6)).to(dev)
    kb, ki = S.make_streamed_decoder(code, spec)(llr)
    pb, pi = make_layered_decoder(code, spec, dev)(llr)
    assert torch.equal(kb, pb)
    assert int(ki) == int(pi)


@pytest.mark.parametrize("tile", S.TILES)
def test_streamed_kernel_every_tile(dev, tile):
    """Each tile width the kernel ships, on a view with every feature,
    through the batch that ``pick_tile`` maps to it on this card (DMAX 16:
    one CTA an SM)."""
    code = _streamed_code("16200x10800")
    spec = LayeredSpec(iters=5, early_term=True)
    B = tile * torch.cuda.get_device_properties(dev).multi_processor_count
    assert S.pick_tile(code, B, B // tile) == tile
    llr = torch.from_numpy(_llrs(code.N, B, seed=6, std=0.6)).to(dev)
    kb, ki = S.make_streamed_decoder(code, spec)(llr)
    pb, pi = make_layered_decoder(code, spec, dev)(llr)
    assert torch.equal(kb, pb) and int(ki) == int(pi)


def test_streamed_kernel_counts_launches_and_checks_inputs(dev):
    code = _streamed_code("stair40")
    dec = S.make_streamed_decoder(code, LayeredSpec(iters=3))
    llr = torch.from_numpy(_llrs(code.N, 64, seed=1)).to(dev)
    before = S.launches["streamed_minsum"]
    dec(llr)
    assert S.launches["streamed_minsum"] == before + 1
    with pytest.raises(TypeError):
        dec(llr.to(torch.int16))
    with pytest.raises(ValueError):
        dec(llr.t().contiguous().t())  # not contiguous
    with pytest.raises(ValueError):
        dec(llr[:, :-1].contiguous())
    assert S.launches["streamed_minsum"] == before + 1

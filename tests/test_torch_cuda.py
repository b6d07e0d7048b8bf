"""The CUDA kernels (the QC layered min-sum kernel, with and without its
convergence mask, the gather kernel for any layers, the streamed kernel
for QC codes and views beyond shared memory, and the probe kernels of the
benchmark-suite path) against their plain PyTorch version, the
two-phase decoder against its CPU result, a CUDA graph's batches against
eager ones, the encoders, flooding and ``DecodeStream`` on the card
against the CPU, gloo ranks sharing the card (and one NCCL rank) against
the kernels, the native host decoder, the hybrid split and the
node-major plain decoder against K1, and the two root entry points
(``entry()``'s step against the plain decoder, the headline line).
Every test here needs an NVIDIA GPU and skips without one.

On a machine with a card (and without jax, which ``tests/conftest.py``
imports), run:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import glob
import math
import os

import numpy as np
import pytest
import torch

from ldpcgputegra_tpu_torch.bench import profile_1944 as P
from ldpcgputegra_tpu_torch.bench import roofline as R
from ldpcgputegra_tpu_torch.bench import suite, tiles
from ldpcgputegra_tpu_torch.bench import vpu_probe as V
from ldpcgputegra_tpu_torch.codes.code import LdpcCode
from ldpcgputegra_tpu_torch.codes.dvbs2 import to_qc_form
from ldpcgputegra_tpu_torch.codes.registry import (
    load_code,
    make_qc_code,
    make_random_qc_code,
)
from ldpcgputegra_tpu_torch.decoder import effective_code
from ldpcgputegra_tpu_torch.decoder.twophase import (
    make_twophase_decoder,
    syndrome_fn,
)
from ldpcgputegra_tpu_torch.kernels import _lib
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


def _spread_llrs(n, b, seed):
    """Noise spread over the batch (std 0.2 to 0.9), so that some frames
    converge within a few iterations and some do not."""
    rng = np.random.default_rng(seed)
    std = np.linspace(0.2, 0.9, b)[:, None]
    return np.clip(8.0 * (-1.0 + std * rng.standard_normal((b, n))), -31,
                   31).astype(np.int8)


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


ALGOS = [("OMS", "pre"), ("MS", "post"), ("NMS", "pre"), ("2NMS", "post")]
# (tile, code, batch) where the gather kernel's pick takes each tile on an
# H100's 132 SMs
GATHER_PICKS = [(32, "816x408", 8192), (16, "4000x2000", 4096),
                (8, "8000x4000", 2048), (4, "4000x2000", 384)]


@pytest.mark.parametrize("tile", K.TILES)
@pytest.mark.parametrize("name", ["1944x972", "randqc16"])
@pytest.mark.parametrize("algo,minclamp", ALGOS)
@pytest.mark.parametrize("et", [False, True])
def test_kernel_every_tile(dev, tile, name, algo, minclamp, et):
    """Each build of the QC kernel, forced through its pick as
    ``bench/tiles.py`` does, on a ragged batch: four codewords a thread at
    DMAX 8 (an odd-Z code), one at DMAX 16 (a random QC code of degree
    12)."""
    code = (make_random_qc_code(20, 4, 12, Z=16, seed=5) if name == "randqc16"
            else load_code(name))
    assert K.pack(code) == (4 if name == "1944x972" else 1)
    spec = LayeredSpec(algo=algo, iters=6, minclamp=minclamp, early_term=et)
    llr = torch.from_numpy(_llrs(code.N, 203, seed=4, std=0.6)).to(dev)
    with tiles.forced_layered(tile):
        kb, ki = K.make_cuda_decoder(code, spec)(llr)
    pb, pi = make_layered_decoder(code, spec, dev)(llr)
    assert torch.equal(kb, pb) and int(ki) == int(pi)


@pytest.mark.parametrize("tile", K.TILES)
@pytest.mark.parametrize("name", ["1944x972", "randqc16"])
@pytest.mark.parametrize("algo,minclamp", ALGOS)
def test_kernel_mask_every_tile(dev, tile, name, algo, minclamp):
    """The convergence mask in each build of the QC kernel, on a ragged
    batch of converged and unconverged codewords: bits, ``iters_used`` and
    ``ok`` against the plain decode and ``syndrome_fn``."""
    code = (make_random_qc_code(20, 4, 12, Z=16, seed=5) if name == "randqc16"
            else load_code(name))
    spec = LayeredSpec(algo=algo, iters=4, minclamp=minclamp)
    llr = torch.from_numpy(_spread_llrs(code.N, 203, seed=9)).to(dev)
    with tiles.forced_layered(tile):
        kb, ki, kok = K.make_cuda_decoder(code, spec, emit_mask=True)(llr)
    pb, pi = make_layered_decoder(code, spec, dev)(llr)
    pok = syndrome_fn(code, dev)(pb)
    assert torch.equal(kb, pb) and int(ki) == int(pi)
    assert kok.dtype == torch.bool and kok.shape == (203,)
    assert torch.equal(kok, pok)
    assert 0 < int(pok.sum()) < 203, "the batch must be mixed"


def test_kernel_mask_refuses_early_termination(dev):
    with pytest.raises(ValueError, match="early_term"):
        K.make_cuda_decoder(load_code("576x288"),
                            LayeredSpec(early_term=True), emit_mask=True)


@pytest.mark.parametrize("name", ["576x288", "4000x2000", "16200x7560"])
def test_twophase_on_the_card_matches_the_cpu(dev, name):
    """``auto`` on the card (the QC kernel with its mask; the gather and
    streamed kernels with the syndrome appended) against the plain version
    on the CPU: bits and every stats value."""
    code = load_code(name)
    spec = LayeredSpec(algo="OMS", iters=10)
    llr = torch.from_numpy(_spread_llrs(code.N, 96, seed=17))
    got, got_stats = make_twophase_decoder(code, spec, k1=3, device=dev)(
        llr.to(dev))
    want, want_stats = make_twophase_decoder(code, spec, k1=3,
                                             device="cpu")(llr)
    assert torch.equal(got.cpu(), want)
    assert got_stats == want_stats and got_stats["phase2_frames"] > 0


def test_twophase_pipelined_on_the_card_matches_serial(dev):
    code = load_code("576x288")
    tp = make_twophase_decoder(code, LayeredSpec(algo="OMS", iters=8), k1=4,
                               device=dev)
    llrs = [torch.from_numpy(_llrs(code.N, 256, seed=11 + i)).to(dev)
            for i in range(3)]
    serial = [tp(x)[0] for x in llrs]
    piped, agg = tp.pipelined(llrs)
    fused, fagg = tp.pipelined_fused(llrs, tail=128)
    big, bagg = tp.pipelined_fused(llrs, tail=256)
    for a, b, c, d in zip(serial, piped, fused, big):
        assert torch.equal(a, b) and torch.equal(a, c) and torch.equal(a, d)
    assert agg["frames"] == 3 * 256
    assert fagg["overflows"] > 0 and bagg["overflows"] == 0


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


@pytest.mark.parametrize("tile,name,B", GATHER_PICKS)
def test_gather_kernel_every_tile(dev, tile, name, B):
    """Each tile width the kernel ships, through a code and a batch whose
    pick takes it."""
    code = load_code(name)
    spec = LayeredSpec(iters=5, early_term=True)
    assert G.pick_tile(code, B, G.SMS_H100).tile == tile
    llr = torch.from_numpy(_llrs(code.N, B, seed=6, std=0.6)).to(dev)
    kb, ki = G.make_gather_decoder(code, spec)(llr)
    pb, pi = make_layered_decoder(code, spec, dev)(llr)
    assert torch.equal(kb, pb) and int(ki) == int(pi)


# every build, on a code of its DMAX: irregular (degrees 7 and 8, 8 and 9)
# at DMAX 8 and 16, degree 32 at DMAX 32
_GATHER_BUILDS = [(name, v) for name, dmax in (("1024x518", 8),
                                                ("1200x600", 16),
                                                ("2048x384", 32))
                  for v in G.BUILDS[dmax]]
ALL_PAIRS = [(a, m) for a in ("MS", "OMS", "NMS", "2NMS")
             for m in ("pre", "post")]


@pytest.mark.parametrize("name,variant", _GATHER_BUILDS, ids=str)
@pytest.mark.parametrize("algo,minclamp", ALL_PAIRS)
@pytest.mark.parametrize("et", [False, True])
def test_gather_kernel_every_variant(dev, name, variant, algo, minclamp, et):
    """Each build of the gather kernel at all 8 (algorithm, minclamp)
    pairs, ET on and off, forced through its pick as ``bench/tiles.py``
    does, on a ragged batch (37: a partial tile, and a partial packed word
    where a thread holds four codewords)."""
    code = load_code(name)
    assert variant in G.variants(code)
    spec = LayeredSpec(algo=algo, iters=6, minclamp=minclamp, early_term=et)
    llr = torch.from_numpy(_spread_llrs(code.N, 37, seed=9)).to(dev)
    with tiles.forced_gather(variant):
        kb, ki = G.make_gather_decoder(code, spec)(llr)
    pb, pi = make_layered_decoder(code, spec, dev)(llr)
    assert torch.equal(kb, pb) and int(ki) == int(pi)


@pytest.mark.parametrize("B", [1, 2, 5, 6, 7, 33, 130])
def test_gather_kernel_partial_packed_word(dev, B):
    """Four codewords a thread at tile 4 and 8, where the last tile holds
    1-3 codewords of a packed word; ET freezes codewords inside words."""
    code = load_code("4000x2000")
    spec = LayeredSpec(algo="2NMS", iters=8, minclamp="pre", early_term=True)
    llr = torch.from_numpy(_spread_llrs(code.N, B, seed=B)).to(dev)
    pb, pi = make_layered_decoder(code, spec, dev)(llr)
    for v in (G.Variant(4, 2), G.Variant(8, 2)):
        with tiles.forced_gather(v):
            kb, ki = G.make_gather_decoder(code, spec)(llr)
        assert torch.equal(kb, pb) and int(ki) == int(pi), v


def test_gather_decoder_picks_per_call(dev):
    """The decoder reads the batch at each call: phase 2's few hundred
    frames get their own pick from the same decoder, and a batch size it
    has seen reuses its pick."""
    code = load_code("4000x2000")
    dec = G.make_gather_decoder(code, LayeredSpec(iters=2))
    seen = []
    picked = G.pick_tile
    G.pick_tile = lambda c, B, *a, **kw: seen.append(B) or picked(c, B, *a,
                                                                   **kw)
    try:
        for B in (4096, 384, 4096, 384):
            dec(torch.from_numpy(_llrs(code.N, B, seed=B)).to(dev))
    finally:
        G.pick_tile = picked
    assert seen == [4096, 384]
    assert picked(code, 384, G.SMS_H100) != picked(code, 4096, G.SMS_H100)


# (kernel module, its decoder, code, two batches whose picks differ, a
# forcing of bench/tiles.py, a variant other than both picks)
_PICK_CASES = {
    "layered": (K, K.make_cuda_decoder, "576x288", (1024, 203),
                tiles.forced_layered, 16),
    "streamed": (S, S.make_streamed_decoder, "16200x7560", (512, 128),
                 tiles.forced_streamed, S.Variant("device", 4, 2)),
}


@pytest.mark.parametrize("kernel", ["layered", "streamed"])
def test_decoder_picks_once_per_batch_size(dev, kernel):
    """K1 and K2 read the batch at each call and compute the pick once a
    batch size: batches (B1, B2, B1, B2) compute two picks, which differ,
    and every call is bit-exact against the plain decoder."""
    mod, make, name, batches, _, _ = _PICK_CASES[kernel]
    code = effective_code(load_code(name))
    spec = LayeredSpec(iters=3)
    dec = make(code, spec)
    plain = make_layered_decoder(code, spec, dev)
    seen = []
    picked = mod.pick_tile
    mod.pick_tile = lambda c, B, *a, **kw: seen.append(B) or picked(c, B, *a,
                                                                     **kw)
    try:
        for B in batches * 2:
            llr = torch.from_numpy(_llrs(code.N, B, seed=B)).to(dev)
            kb, ki = dec(llr)
            pb, pi = plain(llr)
            assert torch.equal(kb, pb) and int(ki) == int(pi), B
    finally:
        mod.pick_tile = picked
    assert seen == list(batches)
    sms = _lib.sm_count(dev)
    assert picked(code, batches[0], sms) != picked(code, batches[1], sms)


@pytest.mark.parametrize("kernel", ["layered", "streamed"])
def test_forced_variant_launches_after_a_cached_pick(dev, kernel):
    """A variant forced by ``bench/tiles.py`` takes effect on a decoder
    that has already kept its natural pick at that batch size, and the
    natural pick comes back, looked up, once the forcing ends: each call
    one launch, each bit-exact against the plain decoder, and under the
    profiler the pick computed only under the forcing's new key."""
    from ldpcgputegra_tpu_torch.utils.profiling import spans

    mod, make, name, batches, force, other = _PICK_CASES[kernel]
    code = effective_code(load_code(name))
    B = batches[1]
    assert other != mod.pick_tile(code, B, _lib.sm_count(dev))
    spec = LayeredSpec(iters=3, early_term=True)
    dec = make(code, spec)
    llr = torch.from_numpy(_spread_llrs(code.N, B, seed=5)).to(dev)
    pb, pi = make_layered_decoder(code, spec, dev)(llr)
    counter = {"layered": "layered_minsum", "streamed": "streamed_minsum"}
    launches = mod.launches[counter[kernel]]
    dec(llr)  # the natural pick, kept
    torch.cuda.synchronize()
    before = len(spans())
    act = torch.profiler.ProfilerActivity
    outs = []
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]):
        with force(other):
            outs += [dec(llr), dec(llr)]
        outs.append(dec(llr))
        torch.cuda.synchronize()
    for kb, ki in outs:
        assert torch.equal(kb, pb) and int(ki) == int(pi)
    assert mod.launches[counter[kernel]] == launches + 4
    counts = [r.count for r in spans()[before:]
              if r.name == "ldpc.decode.pick"]
    assert counts == [1, 0, 0]


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


_VARIANTS = [S.Variant(p, t, k)
             for p, ts in (("smem", S.SMEM_TILES), ("device", S.TILES))
             for t in ts for k in S.LANES if k == 1 or t <= 8]


@pytest.mark.parametrize("variant", _VARIANTS, ids=str)
@pytest.mark.parametrize("algo,minclamp", ALGOS)
@pytest.mark.parametrize("et", [False, True])
def test_streamed_kernel_every_tile(dev, variant, algo, minclamp, et):
    """Each build of the streamed kernel at DMAX 16 (both APP placements,
    every tile, 1, 2 and 4 lanes a check), forced through its pick as
    ``bench/tiles.py`` does, on a view with every feature and a ragged
    batch."""
    code = _streamed_code("16200x10800")
    assert variant in S.variants(code)
    spec = LayeredSpec(algo=algo, iters=5, minclamp=minclamp, early_term=et)
    llr = torch.from_numpy(_llrs(code.N, 37, seed=6, std=0.6)).to(dev)
    with tiles.forced_streamed(variant):
        kb, ki = S.make_streamed_decoder(code, spec)(llr)
    pb, pi = make_layered_decoder(code, spec, dev)(llr)
    assert torch.equal(kb, pb) and int(ki) == int(pi)


@pytest.mark.parametrize("variant", [S.Variant("smem", 1, 4),
                                     S.Variant("smem", 2, 2),
                                     S.Variant("device", 4, 4),
                                     S.Variant("smem", 1, 1)], ids=str)
@pytest.mark.parametrize("et", [False, True])
def test_streamed_kernel_lanes_at_degree_30(dev, variant, et):
    """Several lanes a check at DMAX 32 on 64800x6480-dvbs2 (sub-pass
    layers of about 90 committed checks of degree 30)."""
    code = _streamed_code("64800x6480-dvbs2")
    spec = LayeredSpec(iters=4, early_term=et)
    llr = torch.from_numpy(_llrs(code.N, 9, seed=8, std=0.5)).to(dev)
    with tiles.forced_streamed(variant):
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


# ------------------------------------------- the probes of the suite path --

def _ints_on(dev, n, seed, low=-31, high=32):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(low, high, n, dtype=np.int32)).to(dev)


@pytest.mark.parametrize("packed", [False, True], ids=["int32", "int8x4"])
@pytest.mark.parametrize("chains", V.MIX_CHAINS)
def test_probe_mix_matches_plain(dev, chains, packed):
    bounds = (-2**31, 2**31 - 1) if packed else (-31, 32)
    x = _ints_on(dev, 3 * V.BLOCK + 5, seed=chains, low=bounds[0],
                 high=bounds[1])
    for reps in (0, 1, 7, 64):  # the unrolled loop and its remainder
        assert torch.equal(V.probe_mix(x, chains, reps, packed),
                           V.mix_plain(x, chains, reps, packed))


@pytest.mark.parametrize("chains", V.PEAK_CHAINS)
def test_probe_peak_matches_plain(dev, chains):
    x = _ints_on(dev, 3 * V.BLOCK + 5, seed=chains)
    for reps in (0, 1, 7, 64):
        assert torch.equal(V.probe_peak(x, chains, reps),
                           V.peak_plain(x, chains, reps))


def test_probe_copy_matches_plain_and_counts(dev):
    before = V.launches["probe_copy"]
    # a tail of 1-3 elements, and not a whole number of CTAs
    for n in (1, 3, 5 * V.BLOCK * 4 + 4 * 7 + 2):
        x = _ints_on(dev, n, seed=n, low=-100, high=100)
        assert torch.equal(V.probe_copy(x), V.copy_plain(x))
    assert V.launches["probe_copy"] == before + 3
    with pytest.raises(ValueError):
        V.probe_copy(x[1:])  # not on a 16-byte boundary
    assert V.launches["probe_copy"] == before + 3


@pytest.mark.parametrize("form", P.FORMS)
@pytest.mark.parametrize("Z", P.ZS)
def test_probe_roll_matches_plain(dev, Z, form):
    x = P.slabs(Z, dev, seed=Z)
    before = P.launches["probe_roll"]
    assert torch.equal(P.probe_roll(x, P.N_ROLLS, form),
                       P.roll_plain(x, P.N_ROLLS))
    assert P.launches["probe_roll"] == before + 1


def test_probe_readings_are_finite_and_under_their_ceilings(dev):
    hw = R.hw_spec(dev)
    alu = V.measure_alu_rate(dev)
    hbm = V.measure_hbm_bw(dev)
    # in the unit the card issues, integer-ALU instructions, no probe may
    # beat SMs x 64 x the max SM clock; in algorithmic operations the
    # peak's fused add and max may
    assert 0 < alu["instructions"] <= V.ALU_SANITY * hw.alu_rate
    assert alu["mix"] > 0 and alu["peak"] > 0
    assert 0 < hbm < V.HBM_SANITY
    for Z in (24, 81):
        ns = P.roll_ns(Z, "wrap", dev=dev)
        assert math.isfinite(ns) and 0 < ns < 1e6


def test_suite_rows_run_through_a_kernel(dev):
    rates = {"alu": 2.5e13, "alu_mix": 1.5e13, "hbm": 3e12}
    row = suite.bench_one("576x288", 2048, 10, True, rates, dev=dev)
    assert row["backend"] == "cuda" and row["ceiling"] == "probed"
    assert 0 < row["roofline_frac"] < 1 and row["ms_per_call"] > 0
    assert row["roofline_frac_mix"] == pytest.approx(
        row["roofline_frac"] * 2.5 / 1.5, rel=1e-9)
    lat = suite.bench_latency("4000x2000", 10, True, dev=dev)
    assert lat["backend"] == "cuda-gather" and lat["batch"] == 128
    assert lat["ms_per_call"] > 0 and math.isfinite(lat["us_per_frame"])


# the graphed sweep (sim/scan.py), the coded path, flooding, DecodeStream


@pytest.mark.parametrize("name,B", [("1944x972", 256), ("4000x2000", 128),
                                    ("16200x7560", 32)])
def test_graphed_batch_equals_eager(dev, name, B):
    """A batch of a CUDA graph replay gives the eager batch's int8 LLRs
    and decoded bits byte for byte (K1, the gather kernel, K2); the
    graph's launches count once a replay, its capture not at all."""
    from ldpcgputegra_tpu_torch.channel.awgn import AwgnChannel
    from ldpcgputegra_tpu_torch.decoder import make_decoder
    from ldpcgputegra_tpu_torch.sim.scan import ScanSteps

    code = load_code(name)
    chan = AwgnChannel(code.N, code.K, device=dev)
    chan.configure(2.0)
    dec = make_decoder(code, LayeredSpec(algo="OMS", iters=5,
                                         early_term=True), device=dev)
    scan = ScanSteps(lambda g: torch.cat(
        [chan.generate_zero_int8(g, B).view(-1),
         dec(chan.generate_zero_int8(g, B))[0].view(torch.int8).view(-1)]),
        2, dev)
    counters = [K.launches, G.launches, S.launches]
    for seeds in ([5, 6], [7, 5]):
        before = [dict(c) for c in counters]
        out = scan(seeds)
        for j, s in enumerate(seeds):
            llr = chan.generate_zero_int8(chan.generator(s), B)
            assert torch.equal(out[j, :B * code.N].view(B, code.N), llr)
            # the step drew its LLRs twice from one generator: the decode
            # saw the second draw
            g = chan.generator(s)
            chan.generate_zero_int8(g, B)
            bits, _ = dec(chan.generate_zero_int8(g, B))
            assert torch.equal(out[j, B * code.N:].view(torch.uint8)
                               .view(B, code.N), bits)
        ran = sum(c[k] - b[k] for c, b in zip(counters, before) for k in c)
        # 2 decodes a replay, the 2 eager reference decodes above, and
        # the first call's eager warm-up decode before its capture
        assert ran == 2 + 2 + (seeds == [5, 6]), ran
    assert scan.replays == 2


def test_graphed_flooding_equals_eager(dev):
    """The flooding decoder never waits on the host, so a graph takes it:
    a replayed batch's bits and iterations equal the eager decode's."""
    from ldpcgputegra_tpu_torch.channel.awgn import AwgnChannel
    from ldpcgputegra_tpu_torch.decoder import make_decoder
    from ldpcgputegra_tpu_torch.sim.scan import ScanSteps

    code = load_code("576x288")
    chan = AwgnChannel(code.N, code.K, device=dev)
    chan.configure(2.0)
    dec = make_decoder(code, LayeredSpec(algo="OMS", iters=8, early_term=True,
                                         schedule="flooding"), device=dev)

    def step(g):
        bits, used = dec(chan.generate_zero_int8(g, 64))
        return torch.cat([bits.view(-1).to(torch.int32), used.view(1)])

    out = ScanSteps(step, 2, dev)([3, 4])
    for j, s in enumerate((3, 4)):
        bits, used = dec(chan.generate_zero_int8(chan.generator(s), 64))
        assert torch.equal(out[j, :-1].view(64, code.N).to(torch.uint8), bits)
        assert int(out[j, -1]) == int(used)


def test_graphed_sweep_counts_equal_eager(dev):
    from ldpcgputegra_tpu_torch.sim.sweep import SweepConfig, run_sweep

    kw = dict(code="576x288", iters=5, snr_min=1.0, snr_max=2.0,
              snr_step=1.0, batch=256, max_fe=10**9, auto_fe=False,
              max_frames=8 * 256, pipeline_depth=1, device="cuda")
    a = run_sweep(SweepConfig(**kw), progress=False).points
    b = run_sweep(SweepConfig(scan_steps=4, **kw), progress=False).points
    c = run_sweep(SweepConfig(scan_steps=3, **kw), progress=False).points
    assert [(p.frames, p.be, p.fe) for p in a] == [
        (p.frames, p.be, p.fe) for p in b]
    assert all(p.frames == 9 * 256 for p in c)


def test_spans_on_the_card(dev):
    """Under the profiler a K2 call records its variant pick inside its
    decode span, count 1 at a batch size the decoder has not seen and 0
    where it looks the pick up, and a graph's capture (the decode spans
    run while it records) succeeds: its replay equals the eager
    batches."""
    from ldpcgputegra_tpu_torch.channel.awgn import AwgnChannel
    from ldpcgputegra_tpu_torch.sim.scan import ScanSteps
    from ldpcgputegra_tpu_torch.utils.profiling import spans

    code = load_code("576x288")
    dec = S.make_streamed_decoder(code, LayeredSpec(algo="OMS", iters=5,
                                                    early_term=True))
    chan = AwgnChannel(code.N, code.K, device=dev)
    chan.configure(2.0)

    def step(g):
        bits, used = dec(chan.generate_zero_int8(g, 64))
        return torch.cat([bits.view(-1).to(torch.int32), used.view(1)])

    llr = torch.from_numpy(_llrs(code.N, 64, seed=9)).to(dev)
    dec(llr)
    torch.cuda.synchronize()
    before = len(spans())
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]):
        dec(llr[:32])  # a batch size not seen yet: the pick is computed
        dec(llr)  # one seen before the profiler: it is looked up
        scan = ScanSteps(step, 2, dev)
        out = scan([3, 4])
        torch.cuda.synchronize()
    got = spans()[before:]
    for (pick, call), (count, frames) in zip((got[:2], got[2:4]),
                                             ((1, 32), (0, 64))):
        assert (pick.name, pick.count, pick.parent) == ("ldpc.decode.pick",
                                                         count, call)
        assert (call.name, call.count, call.parent) == ("ldpc.decode",
                                                         frames, None)
        assert call.start <= pick.start <= pick.end <= call.end
    # the warm-up and the two captured steps, then the replay's reseeding
    names = [r.name for r in got[4:]]
    assert names == ["ldpc.decode.pick", "ldpc.decode"] * 3 + [
        "ldpc.scan.prepare"]
    assert [r.count for r in got[4:10:2]] == [0, 0, 0]
    assert scan.graph is not None and scan.replays == 1
    for j, s in enumerate((3, 4)):
        bits, used = dec(chan.generate_zero_int8(chan.generator(s), 64))
        assert torch.equal(out[j, :-1].view(64, code.N).to(torch.uint8), bits)
        assert int(out[j, -1]) == int(used)


@pytest.mark.parametrize("name,kind", [("576x288", "gf2"),
                                       ("16200x7560", "staircase"),
                                       ("16200x10800", "table")])
def test_encoders_on_the_card_equal_the_cpu(dev, name, kind):
    from ldpcgputegra_tpu_torch.channel.encoder import make_encoder
    from ldpcgputegra_tpu_torch.golden import syndrome_ok

    code = load_code(name)
    enc = make_encoder(code, kind)
    info = torch.from_numpy(np.random.default_rng(3).integers(
        0, 2, (64, code.K), dtype=np.int8))
    cw = enc.encode(info.to(dev))
    assert cw.device.type == "cuda"
    assert torch.equal(cw.cpu(), enc.encode(info))
    assert syndrome_ok(code, cw[0].cpu().numpy())


@pytest.mark.parametrize("et", [False, True])
def test_flooding_on_the_card_equals_the_cpu(dev, et):
    from ldpcgputegra_tpu_torch.ops.flooding import make_flooding_decoder

    code = load_code("576x288")
    spec = LayeredSpec(algo="NMS", iters=8, early_term=et,
                       schedule="flooding")
    llr = torch.from_numpy(_llrs(code.N, 96, seed=4))
    cb, ci = make_flooding_decoder(code, spec, "cpu")(llr)
    gb, gi = make_flooding_decoder(code, spec, dev)(llr.to(dev))
    assert torch.equal(gb.cpu(), cb) and int(gi) == int(ci)


def test_decode_stream_on_the_card(dev):
    from ldpcgputegra_tpu_torch.decoder import make_decoder
    from ldpcgputegra_tpu_torch.decoder.stream import DecodeStream

    code = load_code("1944x972")
    spec = LayeredSpec(algo="OMS", iters=6, early_term=True)
    xs = [torch.from_numpy(_llrs(code.N, 512, seed=20 + i)).to(dev)
          for i in range(4)]
    st = DecodeStream(code, spec, depth=2, device=dev)
    for x in xs:
        st.submit(x)
    assert st.pending == 4
    direct = make_decoder(code, spec, device=dev)
    for x, (bits, iters) in zip(xs, st.drain()):
        ref, ref_it = direct(x)
        assert np.array_equal(bits, ref.cpu().numpy()) and iters == int(ref_it)


def _ranks_on_the_card(world, cases, backend="gloo"):
    from ldpcgputegra_tpu_torch.parallel.dryrun import decode_cases
    from ldpcgputegra_tpu_torch.parallel.launch import run_ranks

    return run_ranks(decode_cases, world, (cases, "cuda"), backend=backend,
                     threads=0)


@pytest.mark.parametrize("et", [False, True])
def test_ranks_on_one_card_equal_the_kernels(dev, et):
    """Two gloo ranks on the one card: the sharded step through K1 and the
    row-sharded decode at 2304x1152 equal K1's bits and iters_used."""
    from ldpcgputegra_tpu_torch.decoder import make_decoder

    spec = LayeredSpec(algo="OMS", iters=8, early_term=et)
    dp_llr = _llrs(1944, 512, seed=21)
    row_llr = _llrs(2304, 8, seed=22)
    res = _ranks_on_the_card(2, [
        {"kind": "sharded", "code": "1944x972", "spec": spec, "llr": dp_llr},
        {"kind": "rowshard", "code": "2304x1152", "spec": spec,
         "llr": row_llr}])
    kb, ki = K.make_cuda_decoder(load_code("1944x972"), spec)(
        torch.from_numpy(dp_llr).to(dev))
    rb, ri = make_decoder(load_code("2304x1152"), spec, device=dev)(
        torch.from_numpy(row_llr).to(dev))
    np.testing.assert_array_equal(
        np.concatenate([r[0]["bits"] for r in res]), kb.cpu().numpy())
    for r in res:
        assert r[0]["iters"] == int(ki)
        np.testing.assert_array_equal(r[1]["bits"], rb.cpu().numpy())
        assert r[1]["iters"] == int(ri)


def test_nccl_world_of_one(dev):
    """The sharded step over one NCCL rank (NCCL refuses two ranks on one
    card) counts what K1 decodes."""
    spec = LayeredSpec(algo="OMS", iters=8, early_term=True)
    llr = _llrs(1944, 256, seed=23)
    (r,) = _ranks_on_the_card(1, [{"kind": "sharded", "code": "1944x972",
                                   "spec": spec, "llr": llr}], "nccl")
    kb, _ = K.make_cuda_decoder(load_code("1944x972"), spec)(
        torch.from_numpy(llr).to(dev))
    err = kb.cpu().numpy() != 0
    np.testing.assert_array_equal(r[0]["bits"], kb.cpu().numpy())
    assert (r[0]["be"], r[0]["fe"]) == (int(err.sum()), int(err.any(1).sum()))


def test_native_and_hybrid_equal_k1(dev):
    """The AVX-512 host decoder (where the host has AVX-512BW) and the
    hybrid split give K1's bits at 1944x972."""
    from ldpcgputegra_tpu_torch.decoder.extras import make_hybrid_decoder
    from ldpcgputegra_tpu_torch.golden import GoldenParams
    from ldpcgputegra_tpu_torch.golden import native

    code = load_code("1944x972")
    spec = LayeredSpec(algo="OMS", iters=10, early_term=True)
    llr = _llrs(code.N, 256, seed=24)
    kb, ki = K.make_cuda_decoder(code, spec)(torch.from_numpy(llr).to(dev))
    if native.simd_available():
        nb, _ = native.decode_simd_native(code, llr, GoldenParams(
            algo="OMS", iters=10, early_term=True))
        np.testing.assert_array_equal(nb, kb.cpu().numpy())
    for fraction in (0.0, 0.25):
        hb, hi = make_hybrid_decoder(code, spec, host_fraction=fraction,
                                     device=dev)(torch.from_numpy(llr))
        assert torch.equal(hb, kb)


def test_node_major_on_the_card(dev):
    code = load_code("1944x972")
    spec = LayeredSpec(algo="OMS", iters=6, early_term=True)
    llr = torch.from_numpy(_llrs(code.N, 64, seed=25)).to(dev)
    nb, ni = make_layered_decoder(code, spec, dev, node_major=True)(
        llr.t().contiguous())
    fb, fi = make_layered_decoder(code, spec, dev)(llr)
    assert torch.equal(nb.t(), fb) and int(ni) == int(fi)


def test_channel_and_syndrome_default_to_the_card(dev):
    from ldpcgputegra_tpu_torch.channel.awgn import AwgnChannel

    code = load_code("576x288")
    ch = AwgnChannel(code.N, code.K)
    ch.configure(2.0)
    llr = ch.generate_zero_int8(ch.generator(1), 64)
    assert ch.device.type == "cuda" and llr.is_cuda
    bits = torch.zeros((4, code.N), dtype=torch.uint8, device=dev)
    ok = syndrome_fn(code)(bits)
    assert ok.is_cuda and bool(ok.all())


def test_ber_spot_on_the_card(dev):
    """``bench/ber_check.py``'s stages 1 and 3 at a small spot: the kernel
    and the plain decoder agree on batch 0, and the sweep's FER passes the
    exact test against the JAX book's 576x288 point at 2.5 dB."""
    from ldpcgputegra_tpu_torch.bench import ber_check

    rec = ber_check.check_spot(("576x288", "OMS", 10, 2.5, 4096, 4), dev)
    assert rec["decoder_batch0"]["backend"] == "cuda"
    assert rec["stored_fe"] == 122 and rec["p"] >= ber_check.P_FAIL


def test_entry_on_the_card_runs_k1_and_equals_plain(dev):
    """``entry()``'s flagship step (1944x972 B=128) on the card launches K1
    and gives the plain decoder's bits and ``iters_used`` on the same
    tensor."""
    from ldpcgputegra_tpu_torch import entry as E

    fn, (llr,) = E.entry()
    assert llr.is_cuda and tuple(llr.shape) == (E.BATCH, 1944)
    K.launches["layered_minsum"] = 0
    bits, iters = fn(llr)
    torch.cuda.synchronize()
    assert K.launches["layered_minsum"] > 0
    pb, pi = make_layered_decoder(load_code(E.CODE), E.SPEC, dev)(llr)
    assert torch.equal(bits, pb) and int(iters) == int(pi) == 10


def test_headline_on_the_card(dev, capsys):
    """``bench/headline.py``'s ``main()`` prints one JSON line with the
    record's keys, through K1, with the card's name and power limit."""
    import json

    from ldpcgputegra_tpu_torch.bench import headline

    assert headline.main([]) == 0
    out, err = capsys.readouterr()
    lines = out.strip().splitlines()
    assert len(lines) == 1, out
    rec = json.loads(lines[0])
    assert set(rec) == {"metric", "value", "unit", "vs_baseline", "device"}
    assert rec["metric"] == headline.METRIC and rec["value"] > 0
    assert rec["vs_baseline"] == round(rec["value"] / 132.0, 2)
    assert "backend cuda" in err and "K1 launches 0" not in err

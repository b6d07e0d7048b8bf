"""The gather kernel's builds and its pick on the CPU, without a card and
without JAX: the variants the source builds against the wrapper's list,
the (algorithm, minclamp) dispatch, the pick at the sweep's, the suite's
and two-phase phase 2's batches on an H100's 132 SMs against the variant
table measured there (``bench/tiles.py``), and the shared memory and
CTAs an SM that the wrapper charges the variant it launches.
"""

import os
import re

import pytest

from ldpcgputegra_tpu_torch.codes.registry import (
    load_code,
    make_random_regular_code,
)
from ldpcgputegra_tpu_torch.kernels import _lib
from ldpcgputegra_tpu_torch.kernels import gather as G

V = G.Variant
NON_QC = ["200x100", "816x408", "1024x518", "1200x600", "2048x384",
          "2640x1320", "4000x2000", "4896x2448", "8000x4000", "9972x4986",
          "20000x10000"]
SWEEP_B = 4096
SUITE_B = {"200x100": 16384, "816x408": 8192, "1024x518": 8192,
           "1200x600": 8192, "2048x384": 8192, "2640x1320": 4096,
           "4000x2000": 4096, "4896x2448": 4096, "8000x4000": 2048,
           "9972x4986": 2048, "20000x10000": 1024}
PHASE2_B = (128, 256, 384)

# ms by (tile, k, w), OMS 10 iterations, ET off (bench/tiles.py on an
# NVIDIA H100 80GB HBM3, 700.00 W; PERF.md §6), at the gather kernel's
# non-QC codes' suite batches and at smaller ones: w codewords a thread, 4
# in the builds, 1 in the first port's design (tiles 32, 16 and 8, k 1),
# retired as the slower at every shape here
MEASURED = {
    ("4000x2000", 4096): {(32, 4, 4): 1.9454, (16, 4, 4): 1.5185,
        (32, 2, 4): 1.3734, (16, 2, 4): 1.0599, (8, 2, 4): 1.0463,
        (4, 2, 4): 1.0425, (32, 1, 1): 2.4719, (16, 1, 1): 1.6131,
        (8, 1, 1): 1.5443},
    ("4000x2000", 1024): {(32, 4, 4): 1.615, (16, 4, 4): 0.8547,
        (32, 2, 4): 1.1204, (16, 2, 4): 0.6212, (8, 2, 4): 0.3131,
        (4, 2, 4): 0.2828, (32, 1, 1): 1.9204, (16, 1, 1): 1.0652,
        (8, 1, 1): 0.5418},
    ("4000x2000", 384): {(32, 4, 4): 1.5988, (16, 4, 4): 0.8515,
        (32, 2, 4): 1.1067, (16, 2, 4): 0.618, (8, 2, 4): 0.3123,
        (4, 2, 4): 0.1632, (32, 1, 1): 1.9013, (16, 1, 1): 1.0601,
        (8, 1, 1): 0.5333},
    ("4000x2000", 128): {(32, 4, 4): 1.6035, (16, 4, 4): 0.8426,
        (32, 2, 4): 1.1144, (16, 2, 4): 0.6081, (8, 2, 4): 0.3127,
        (4, 2, 4): 0.1639, (32, 1, 1): 1.9079, (16, 1, 1): 1.0383,
        (8, 1, 1): 0.5255},
    ("8000x4000", 2048): {(16, 4, 4): 2.0106, (16, 2, 4): 1.3784,
        (8, 2, 4): 1.0649, (4, 2, 4): 1.0866, (16, 1, 1): 2.6987,
        (8, 1, 1): 1.6503},
    ("20000x10000", 1024): {(8, 2, 4): 1.7503, (4, 2, 4): 1.4212,
        (8, 1, 1): 3.5193},
    ("9972x4986", 2048): {(16, 4, 4): 2.5864, (16, 2, 4): 2.1814,
        (8, 2, 4): 1.8251, (4, 2, 4): 1.9449, (16, 1, 1): 3.558,
        (8, 1, 1): 2.505},
    ("4896x2448", 4096): {(32, 4, 4): 2.3461, (16, 4, 4): 1.8849,
        (32, 2, 4): 1.6253, (16, 2, 4): 1.2826, (8, 2, 4): 1.2831,
        (4, 2, 4): 1.2776, (32, 1, 1): 3.1008, (16, 1, 1): 2.0362,
        (8, 1, 1): 1.8809},
    ("2640x1320", 4096): {(32, 4, 4): 1.3553, (16, 4, 4): 1.1326,
        (32, 2, 4): 1.0571, (16, 2, 4): 0.8719, (8, 2, 4): 1.0105,
        (4, 2, 4): 1.4907, (32, 1, 1): 1.89, (16, 1, 1): 1.2845,
        (8, 1, 1): 1.3816},
    ("2048x384", 8192): {(32, 4, 4): 2.3575, (16, 4, 4): 2.5602,
        (8, 4, 4): 2.8331, (4, 4, 4): 3.3157, (32, 1, 1): 6.9498,
        (16, 1, 1): 7.7795, (8, 1, 1): 8.8959},
    ("1024x518", 8192): {(32, 4, 4): 0.917, (16, 4, 4): 1.0322,
        (32, 2, 4): 0.89, (16, 2, 4): 1.1319, (8, 2, 4): 1.7932,
        (4, 2, 4): 3.5039, (32, 1, 1): 1.1941, (16, 1, 1): 1.3028,
        (8, 1, 1): 2.1434},
    ("1200x600", 8192): {(32, 4, 4): 1.1929, (16, 4, 4): 1.2708,
        (8, 4, 4): 1.8792, (4, 4, 4): 3.0648, (32, 2, 4): 1.3566,
        (32, 1, 1): 2.5914, (16, 1, 1): 3.2519, (8, 1, 1): 6.2591},
    ("816x408", 8192): {(32, 4, 4): 0.962, (16, 4, 4): 1.0083,
        (8, 4, 4): 1.3402, (4, 4, 4): 2.1044, (32, 2, 4): 0.9727,
        (32, 1, 1): 1.7706, (16, 1, 1): 2.0788, (8, 1, 1): 3.9362},
    ("200x100", 16384): {(32, 4, 4): 0.5291, (16, 4, 4): 0.8694,
        (32, 2, 4): 0.5622, (16, 2, 4): 1.044, (8, 2, 4): 1.953,
        (4, 2, 4): 3.9578, (32, 1, 1): 0.6884, (16, 1, 1): 1.3147,
        (8, 1, 1): 2.6588},
    ("2640x1320", 1024): {(32, 4, 4): 1.2355, (16, 4, 4): 0.6913,
        (32, 2, 4): 0.9709, (16, 2, 4): 0.5654, (8, 2, 4): 0.3549,
        (4, 2, 4): 0.3877, (32, 1, 1): 1.6237, (16, 1, 1): 0.9805,
        (8, 1, 1): 0.5458},
    ("1200x600", 1024): {(32, 4, 4): 0.7759, (16, 4, 4): 0.428,
        (8, 4, 4): 0.3836, (4, 4, 4): 0.3925, (32, 2, 4): 0.9948,
        (32, 1, 1): 1.2817, (16, 1, 1): 0.8205, (8, 1, 1): 0.8013},
}


def _source(name):
    with open(os.path.join(_lib.CSRC, name)) as f:
        return f.read()


def _built():
    """(tile, k) by DMAX from the source's GATHER_VARIANTS list."""
    body = re.search(r"#define GATHER_VARIANTS\(X\)(.*?)\n\n",
                     _source("gather_minsum.cu"), re.S).group(1)
    out = {}
    for tb, k, dmax in re.findall(r"X\((\d+), (\d+), (\d+)\)", body):
        out.setdefault(int(dmax), []).append(V(int(tb), int(k)))
    return out


def _built_measured(ms):
    """The entries of a ``MEASURED`` shape whose variant is built (four
    codewords a thread), by ``Variant``."""
    return {V(t, k): x for (t, k, w), x in ms.items() if w == G.W}


def test_builds_mirror_the_source():
    built = _built()
    assert {d: sorted(vs) for d, vs in built.items()} == {
        d: sorted(vs) for d, vs in G.BUILDS.items()}
    assert set(built) == set(G.DMAXES)
    for name in ("NTHREADS", "W"):
        assert re.search(rf"constexpr int {name} = (\d+);",
                         _source("gather_minsum.cu")).group(1) == str(
                             getattr(G, name))
    for dmax, vs in built.items():
        assert {v.tile for v in vs} == set(G.TILES)
        for v in vs:
            # four codewords a thread: a lane holds 8 edges or fewer; a
            # check's lanes and columns within one warp
            assert dmax // v.k <= 8
            assert v.tile // G.W * v.k <= 32


def test_every_algo_and_minclamp_maps_to_a_build():
    """The C entry dispatches each of the 8 (algorithm, minclamp) pairs to
    the build of that pair, by the enum the wrapper's ``ALGO`` mirrors."""
    enum = dict((n, int(v)) for n, v in re.findall(
        r"(\w+) = (\d+)", re.search(r"enum Algo \{(.*?)\}",
                                    _source("minsum_common.cuh")).group(1)))
    assert sorted(enum.values()) == sorted(_lib.ALGO.values())
    cases = re.findall(
        r"case (\w+) \* 2 \+ ([01]): return launch_variant<(\w+), "
        r"(false|true)>", _source("gather_minsum.cu"))
    got = {(enum[a], int(pre)) for a, pre, b, flag in cases
           if a == b and int(pre) == (flag == "true")}
    assert len(cases) == 8
    assert got == {(v, pre) for v in _lib.ALGO.values() for pre in (0, 1)}


@pytest.mark.parametrize("name", NON_QC)
def test_every_pick_is_a_build(name):
    """Whatever the batch and the card, the pick is a build that takes the
    code (its DMAX, an APP tile that fits shared memory)."""
    code = load_code(name)
    built = _built()[G._dmax(code)]
    for sms in (132, 114, 78):
        for B in (1, 3, 77, 128, 384, 1000, 1024, 4096, 8192, 16384, 65536):
            v = G.pick_tile(code, B, sms)
            assert v in G.variants(code) and v in built, (B, sms, v)
            assert G.smem_bytes(code, v) <= _lib.SMEM_MAX


def test_every_build_is_reachable():
    """Each build is the pick of some registry or random regular code at
    some batch on 132 SMs, so none is dead weight in the library; and the
    first port's one codeword a thread, which is not built, was the
    fastest at no shape of ``MEASURED``."""
    codes = [load_code(n) for n in NON_QC] + [
        make_random_regular_code(n, n // 2, 6, seed=1)
        for n in (512, 3000, 12000)]
    picked = {(G._dmax(c), G.pick_tile(c, B))
              for c in codes for B in (32, 128, 384, 1024, 2048, 4096, 8192,
                                       16384, 65536)}
    want = {(d, v) for d, vs in G.BUILDS.items() for v in vs}
    assert want <= picked, sorted(want - picked)
    for ms in MEASURED.values():
        assert min(ms, key=ms.get)[2] == G.W


@pytest.mark.parametrize("name,B", [("4000x2000", 4096)]
                         + [(n, b) for n, b in SUITE_B.items()]
                         + [("4000x2000", b) for b in PHASE2_B])
def test_pick_fills_the_card(name, B):
    """At the sweep's, the suite's and phase 2's batches on 132 SMs the
    pick runs one wave or more of CTAs, unless a smaller tile's APP does
    not fit or none would."""
    code = load_code(name)
    v = G.pick_tile(code, B)
    ctas = -(-B // v.tile)
    slots = 132 * G.ctas_per_sm(code, v)
    narrower = [u for u in G.variants(code) if u.tile < v.tile]
    assert ctas >= min(slots, 132) or not narrower, (v, ctas, slots)


@pytest.mark.parametrize("shape", sorted(MEASURED), ids=str)
def test_pick_is_the_fastest_measured(shape):
    """Where ``bench/tiles.py`` measured every variant, the pick is the
    fastest, or within 5% of it: the model counts rounds and waves, and
    the variants it cannot tell apart lie within a few percent."""
    name, B = shape
    ms = _built_measured(MEASURED[shape])
    code = load_code(name)
    assert set(ms) == set(G.variants(code))
    v = G.pick_tile(code, B)
    assert ms[v] <= 1.05 * min(ms.values()), (v, ms[v], min(ms.values()))


def test_pick_reads_the_batch_and_the_card():
    code = load_code("4000x2000")
    assert G.pick_tile(code, 384).tile < G.pick_tile(code, SWEEP_B).tile
    # fewer SMs: the same batch fills the card with wider tiles
    assert G.pick_tile(code, 1024, sms=16).tile >= G.pick_tile(
        code, 1024, sms=132).tile


def test_smem_and_ctas_charge_the_variant_launched():
    code = load_code("20000x10000")
    assert G.variants(code) == [V(8, 2), V(4, 2)]
    for v, smem, ctas in ((V(8, 2), 160032, 1), (V(4, 2), 80016, 2)):
        assert G.smem_bytes(code, v) == smem
        assert G.ctas_per_sm(code, v) == ctas
    code = load_code("4000x2000")
    assert G.smem_bytes(code, V(32, 2)) == 128128
    assert G.ctas_per_sm(code, V(32, 2)) == 1
    assert G.ctas_per_sm(code, V(16, 2)) == 2
    # two CTAs an SM wherever shared memory allows (64 registers a thread)
    assert G.ctas_per_sm(load_code("2048x384"), V(8, 4)) == 2
    assert G.ctas_per_sm(load_code("816x408"), V(32, 2)) == 2
    assert G.ctas_per_sm(load_code("816x408"), V(8, 4)) == 2


def test_sass_reads_the_builds_the_pick_launches():
    """``bench/sass.py`` counts the instructions of the OMS/pre builds that
    the pick launches on the main paths."""
    from ldpcgputegra_tpu_torch.bench import sass

    listed = {sym for k, sym, _, _ in sass.VARIANTS if k == "gather_minsum"}
    for name, B in (("4000x2000", SWEEP_B), ("4000x2000", 384),
                    ("20000x10000", 1024), ("1200x600", 8192),
                    ("2048x384", 8192)):
        code = load_code(name)
        sym, edges = sass.gather_symbol(code, G.pick_tile(code, B))
        assert sym in listed, (name, B, sym)
        entry = next(e for k, s, e, _ in sass.VARIANTS if s == sym)
        assert entry == edges

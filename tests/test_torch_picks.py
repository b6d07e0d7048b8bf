"""The picks of the QC kernel (``kernels/layered.py``) and the streamed
kernel (``kernels/streamed.py``) as pure functions of the code, the batch
and the SM count (132 on an H100 SXM, 114 on an H100 PCIe), and the shared
memory, registers and CTAs an SM that each charges the variant it
launches.  No card needed."""

import pytest

from ldpcgputegra_tpu_torch.codes.registry import (
    list_codes,
    load_code,
    make_random_qc_code,
)
from ldpcgputegra_tpu_torch.decoder import effective_code
from ldpcgputegra_tpu_torch.kernels import _lib
from ldpcgputegra_tpu_torch.kernels import layered as K
from ldpcgputegra_tpu_torch.kernels import streamed as S
from ldpcgputegra_tpu_torch.ops.layered import LayeredSpec

QC = ["576x288", "1944x972", "2304x1152", "155x93", "1248x624",
      "802_11e_1920x960"]


@pytest.mark.parametrize("name,B,sms,tile", [
    ("2304x1152", 1024, 132, 8), ("2304x1152", 8192, 132, 16),
    ("1944x972", 1024, 132, 8), ("1944x972", 8192, 132, 16),
    ("1944x972", 1024, 114, 16), ("2304x1152", 8192, 114, 16),
    ("1944x972", 128, 132, 4), ("576x288", 8192, 132, 32),
    ("576x288", 16384, 132, 32), ("1248x624", 1024, 132, 8),
])
def test_layered_pick_at_the_sweep_and_bench_batches(name, B, sms, tile):
    """The fewest (CTAs one after another on an SM) x (rounds of a
    block-row's Z checks on the tile's lanes), the narrowest of equals:
    at the sweep's batch of 1024 the card fills (tile 8: 128 CTAs on 132
    SMs, every block-row one round on 256 lanes)."""
    code = load_code(name)
    assert K.pick_tile(code, B, sms) == tile
    if sms == _lib.SMS_H100:
        assert K.pick_tile(code, B) == tile  # the default without a card

    def cost(t):
        waves = -(-(-(-B // t)) // (sms * K.ctas_per_sm(code, t)))
        return waves * -(-code.Z // (K.NTHREADS * K.pack(code) // t))

    fits = [t for t in K.TILES if K.smem_bytes(code, t) <= _lib.SMEM_MAX]
    assert cost(tile) == min(cost(t) for t in fits)
    assert all(t >= tile for t in fits if cost(t) == cost(tile))


@pytest.mark.parametrize("name", QC)
def test_layered_fit_charges_the_tile_it_launches(name):
    """Shared memory of the [N][tile] APP, the block edges' columns and
    shifts, the block-row offsets and the tile's flags, for each tile; one
    CTA an SM (the launch bounds' 128 registers a thread)."""
    code = load_code(name)
    n_edges = sum(lay.deg for lay in code.layers)
    for t in K.TILES:
        want = ((code.N * t + 15) & ~15) + 4 * (
            2 * n_edges + len(code.layers) + 1 + t)
        assert K.smem_bytes(code, t) == want
        assert K.ctas_per_sm(code, t) == 1
    assert K.pack(code) == 4  # every registry QC code is of degree <= 8


def test_layered_takes_a_code_whose_narrow_tile_fits():
    """A tile of 32 codewords no longer decides: a QC code whose 32-wide
    APP does not fit shared memory takes a narrower tile, and a code whose
    4-wide one does not fit is refused, naming that tile."""
    code = make_random_qc_code(400, 200, 6, Z=64, seed=2)  # N = 25600
    assert K.smem_bytes(code, 32) > _lib.SMEM_MAX
    assert K.kernel_unsupported_reason(code, LayeredSpec()) is None
    tile = K.pick_tile(code, 8192)
    assert tile in (8, 4) and K.smem_bytes(code, tile) <= _lib.SMEM_MAX
    synth = load_code("synthqc-256x128x6-z1024")
    why = K.kernel_unsupported_reason(synth, LayeredSpec())
    assert "4-codeword APP tile" in why and "does not fit shared memory" in why
    assert K.pick_tile(synth, 1024) == 0


def test_layered_packs_four_codewords_at_dmax_8_only():
    assert K.pack(make_random_qc_code(20, 4, 12, Z=16, seed=5)) == 1
    assert K.pack(make_random_qc_code(24, 12, 5, Z=32, seed=3)) == 4


@pytest.mark.parametrize("name,placements", [
    ("16200x7560", {("smem", 8), ("smem", 4), ("smem", 2), ("smem", 1)}),
    ("64800x32400", {("smem", 2), ("smem", 1)}),
    ("synthqc-256x128x6-z1024", set()),
])
def test_streamed_app_in_shared_memory_where_a_tile_fits(name, placements):
    """tile x N bytes (and the 16-byte pad before them, where the pinned
    edges read and write) within the 232,448 a block may use: 16200 up to
    8 codewords, 64800 up to 2, synthqc (262,144 bits) none; every device-
    memory tile is built for every code."""
    code = effective_code(load_code(name))
    vs = S.variants(code)
    assert {(v.placement, v.tile) for v in vs if v.placement == "smem"} == \
        placements
    assert {v.tile for v in vs if v.placement == "device"} == set(S.TILES)
    for v in vs:
        app = (16 + ((code.N * v.tile + 15) & ~15) if v.placement == "smem"
               else 0)
        assert S.smem_bytes(code, v) == app + 4 * v.tile <= _lib.SMEM_MAX
    pick = S.pick_tile(code, 512)
    assert pick.placement == ("smem" if placements else "device")


@pytest.mark.parametrize("B,sms", [(256, 132), (1024, 132), (256, 114),
                                   (1024, 114)])
def test_streamed_lanes_per_check_at_degree_30(B, sms):
    """64800x6480-dvbs2: layers of about 90 committed checks of degree 30;
    four lanes a check, each holding 8 contributions, so two CTAs an SM."""
    code = effective_code(load_code("64800x6480-dvbs2"))
    shapes = S.layer_shapes(code)
    assert {d for _, d in shapes} == {30}
    assert sum(g for g, _ in shapes) / len(shapes) < 100
    v = S.pick_tile(code, B, sms)
    assert v == S.Variant("smem", 1, 4)
    assert S.ctas_per_sm(code, v) == 2
    assert S.ctas_per_sm(code, S.Variant("smem", 1, 1)) == 1


def test_streamed_lanes_only_where_the_degree_needs_them():
    """k > 1 is built at DMAX 16 and 32 on tiles up to 8; the DMAX-8 codes
    keep one lane a check."""
    for name in list_codes():
        code = effective_code(load_code(name))
        if S.kernel_unsupported_reason(code, LayeredSpec()) is not None:
            continue
        ks = {v.k for v in S.variants(code)}
        assert ks == ({1} if _lib.dmax(code.layers) == 8 else set(S.LANES)), name
        assert all(v.tile <= 8 for v in S.variants(code) if v.k > 1)

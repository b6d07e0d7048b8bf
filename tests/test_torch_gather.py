"""The non-QC (gather) decode path of the port on the CPU.

The plain PyTorch decoder against the JAX package's XLA decoder on the
registry's non-QC codes: bit-exact in bits and ``iters_used``, from the
same seeded numpy int8 LLRs (1200x600 here; the other codes in
``test_torch_gather_jax.py``, 2048x384 in ``test_torch_gather_deg32.py``).
Also pinned here: the ``auto`` routing of
every registry code on a CUDA device (decided without a card), staircase
detection against the JAX package, the gather kernel's pick at the suite's
batches (its builds and the pick in full: ``test_torch_gather_pick.py``),
its tables, and its wrapper on CPU tensors.
"""

import numpy as np
import pytest
import torch

from ldpcgputegra_tpu.codes.dvbs2 import is_staircase as j_is_staircase
from ldpcgputegra_tpu.codes.registry import load_code as j_load_code
from ldpcgputegra_tpu.codes.registry import (
    make_random_regular_code as j_make_random_regular_code,
)
from ldpcgputegra_tpu.ops.layered import LayeredSpec as JSpec
from ldpcgputegra_tpu.ops.layered import make_layered_decoder as j_decoder
from ldpcgputegra_tpu_torch.codes.convert import edge_tables
from ldpcgputegra_tpu_torch.codes.dvbs2 import is_staircase, to_qc_form
from ldpcgputegra_tpu_torch.codes.registry import (
    list_codes,
    load_code,
    make_random_regular_code,
)
from ldpcgputegra_tpu_torch.codes.schedule import build_layers
from ldpcgputegra_tpu_torch.decoder import backend_for, make_decoder
from ldpcgputegra_tpu_torch.kernels import gather as G
from ldpcgputegra_tpu_torch.kernels._lib import SMEM_MAX
from ldpcgputegra_tpu_torch.ops.layered import LayeredSpec, make_layered_decoder
from ldpcgputegra_tpu_torch.sim.sweep import SweepConfig, run_sweep

CUDA = torch.device("cuda")

QC = ["1248x624", "155x93", "1944x972", "2304x1152", "576x288",
      "802_11e_1920x960", "802_11e_2304x1152", "802_11e_576x288",
      "802_11n-1944x972"]
# non-QC codes, their suite batch, and the variant (codewords per CTA,
# lanes a check) the gather kernel's pick takes there on an H100's 132 SMs
NON_QC_TILE = {
    "1024x518": (8192, G.Variant(32, 4)),
    "1200x600": (8192, G.Variant(32, 4)),
    "200x100": (16384, G.Variant(32, 4)),
    "2048x384": (8192, G.Variant(32, 4)),
    "2640x1320": (4096, G.Variant(16, 2)),
    "4000x2000": (4096, G.Variant(16, 2)),
    "4896x2448": (4096, G.Variant(16, 2)),
    "816x408": (8192, G.Variant(32, 2)),
    "8000x4000": (2048, G.Variant(8, 2)),
    "9972x4986": (2048, G.Variant(8, 2)),
    "20000x10000": (1024, G.Variant(4, 2)),
}
STAIRCASE = ["16200x10800", "16200x7560", "64800x21600", "64800x32400",
             "64800x32400-dvbs2", "64800x6480-dvbs2", "64800x7200-dvbs2"]


def _llrs(n, b, seed):
    """int8 all-zero-codeword LLRs, noise spread over the batch so frames
    converge at different iterations."""
    rng = np.random.default_rng(seed)
    std = np.linspace(0.3, 0.9, b)[:, None]
    return np.clip(8.0 * (-1.0 + std * rng.standard_normal((b, n))),
                   -31, 31).astype(np.int8)


def _check(name, kw, b=16, seed=0):
    llr = _llrs(load_code(name).N, b, seed)
    bits, iters = make_layered_decoder(load_code(name), LayeredSpec(**kw))(
        torch.from_numpy(llr))
    rb, ri = j_decoder(j_load_code(name), JSpec(**kw))(llr)
    np.testing.assert_array_equal(bits.numpy(), np.asarray(rb))
    assert int(iters) == int(ri)


@pytest.mark.parametrize("schedule", ["auto", "colored"])
def test_plain_matches_jax_schedules_irregular(schedule):
    """1200x600 (check degrees 8 and 9; 39 colored layers).  Its reference
    schedule has 547 layers, too many for a quick XLA compile: the
    reference schedule is checked on 200x100 (``test_torch_layered.py``)."""
    _check("1200x600", dict(algo="NMS", minclamp="post", iters=3,
                            early_term=True, schedule=schedule), seed=4)


def test_random_regular_code_matches_jax():
    a = make_random_regular_code(256, 128, 6, seed=9)
    b = j_make_random_regular_code(256, 128, 6, seed=9)
    assert (a.name, a.N, a.K, a.Z) == (b.name, b.N, b.K, b.Z)
    np.testing.assert_array_equal(a.edges, b.edges)


@pytest.mark.parametrize("name", sorted(NON_QC_TILE) + STAIRCASE + QC[:2])
def test_is_staircase_matches_jax(name):
    assert is_staircase(load_code(name)) == j_is_staircase(j_load_code(name))
    assert is_staircase(load_code(name)) == (name in STAIRCASE)


def test_auto_routing_of_every_registry_code():
    """On a CUDA device: QC codes take the QC kernel, non-QC codes the
    gather kernel, staircase codes (their QC views) the streamed kernel; on
    the CPU ``auto`` is torch."""
    assert sorted(list_codes()) == sorted(QC + list(NON_QC_TILE) + STAIRCASE)
    spec = LayeredSpec()
    for name in QC:
        assert backend_for(load_code(name), spec, CUDA) == "cuda"
    for name in NON_QC_TILE:
        assert backend_for(load_code(name), spec, CUDA) == "cuda-gather"
        assert backend_for(load_code(name), spec, "cpu") == "torch"
    for name in STAIRCASE:
        assert backend_for(load_code(name), spec, CUDA) == "cuda-streamed"


def test_routing_of_schedules_on_qc_codes():
    """A QC code in the colored schedule has non-QC layers: the gather
    kernel takes it, the QC kernel never does."""
    code = load_code("576x288")
    assert backend_for(code, LayeredSpec(schedule="reference"), CUDA) == "cuda"
    assert backend_for(code, LayeredSpec(schedule="colored"), CUDA) == \
        "cuda-gather"
    with pytest.raises(NotImplementedError, match="queue 1 item 12"):
        backend_for(code, LayeredSpec(schedule="flooding"), CUDA)


@pytest.mark.parametrize("name", sorted(NON_QC_TILE))
def test_fit_picks_the_tile(name):
    """The variant the pick takes at the code's suite batch on 132 SMs, a
    build that takes the code, charged its own shared-memory footprint."""
    code = load_code(name)
    spec = LayeredSpec()
    B, want = NON_QC_TILE[name]
    v = G.pick_tile(code, B, 132)
    assert v == want
    assert G.kernel_unsupported_reason(code, spec) is None
    assert v in G.variants(code)
    assert G.smem_bytes(code, v) == ((code.N * v.tile + 15) & ~15) + 4 * v.tile
    assert G.smem_bytes(code, v) <= SMEM_MAX


def test_registry_codes_reach_every_tile():
    """Each tile the kernel ships is the pick of some registry code at its
    suite batch, or of 4000x2000 at a batch of two-phase phase 2, so the
    card tests, which run those codes, launch all."""
    picks = {G.pick_tile(load_code(n), B, 132).tile
             for n, (B, _) in NON_QC_TILE.items()}
    picks |= {G.pick_tile(load_code("4000x2000"), B, 132).tile
              for B in (128, 384)}
    assert picks == set(G.TILES)


def test_colored_layers_are_computed_once_per_code():
    """Routing, the fit, the tables and the plain decoder share one
    coloring of a code; a new code object is colored anew."""
    code = make_random_regular_code(256, 128, 6, seed=9)
    layers = build_layers(code, "colored")
    assert build_layers(code, "colored") is layers
    G.make_gather_decoder(code, LayeredSpec(schedule="colored"))
    assert build_layers(code, "colored") is layers
    other = make_random_regular_code(256, 128, 6, seed=9)
    again = build_layers(other, "colored")
    assert again is not layers and len(again) == len(layers)
    for a, b in zip(again, layers):
        np.testing.assert_array_equal(a.idx, b.idx)


def test_fit_refuses_codes_beyond_an_8_codeword_tile():
    """The smallest tile is 4 codewords: up to N = 58104 its APP fits
    shared memory (30000 bits, beyond tile 8, now decode at tile 4).  The
    name is historical, from when the smallest tile was 8 codewords; the
    limit tested is tile 4's."""
    assert G.variants(make_random_regular_code(30000, 15000, 6, seed=1))
    code = make_random_regular_code(58200, 29100, 6, seed=1)
    assert G.variants(code) == [] and G.pick_tile(code, 1024) is None
    assert "does not fit shared memory" in G.kernel_unsupported_reason(
        code, LayeredSpec())


@pytest.mark.parametrize("name,schedule", [("4000x2000", "auto"),
                                           ("1200x600", "auto"),
                                           ("576x288", "colored")])
def test_gather_tables_describe_the_schedule(name, schedule):
    code = load_code(name)
    spec = LayeredSpec(schedule=schedule)
    t = {k: v.numpy() for k, v in edge_tables(code, spec, "cpu",
                                              wide=False).items()}
    layers = build_layers(code, schedule)
    assert t["vn"].dtype == np.int16 and t["row_ptr"].dtype == np.int32
    assert len(t["deg"]) == len(layers) and t["row_ptr"][-1] == code.M
    vn = t["vn"].view(np.uint16)
    for l, lay in enumerate(layers):
        G_, d = lay.idx.shape
        assert (t["n_checks"][l], t["deg"][l]) == (G_, d)
        e0 = t["row_ptr"][l]
        assert t["row_ptr"][l + 1] - e0 == G_ * d
        # edge j of check g is slot e0 + j*G + g
        np.testing.assert_array_equal(
            vn[e0:e0 + G_ * d].reshape(d, G_), lay.idx.T)


@pytest.mark.parametrize("name", ["200x100", "2048x384", "1024x518"])
def test_gather_wrapper_runs_plain_on_cpu_tensors(name):
    code = load_code(name)
    spec = LayeredSpec(iters=3, early_term=True)
    llr = torch.from_numpy(_llrs(code.N, 13, 2))
    kb, ki = G.make_gather_decoder(code, spec)(llr)
    pb, pi = make_layered_decoder(code, spec)(llr)
    assert torch.equal(kb, pb) and int(ki) == int(pi)


def test_gather_wrapper_checks():
    code = load_code("200x100")
    dec = G.make_gather_decoder(code, LayeredSpec(iters=2))
    with pytest.raises(TypeError):
        dec(torch.zeros((2, code.N), dtype=torch.int16))
    with pytest.raises(ValueError):
        dec(torch.zeros((2, code.N + 1), dtype=torch.int8))
    with pytest.raises(ValueError):
        dec(torch.zeros((0, code.N), dtype=torch.int8))
    with pytest.raises(ValueError, match="no kernel"):
        dec(torch.zeros((2, code.N), dtype=torch.int8, device="meta"))
    with pytest.raises(ValueError, match="unknown algo"):
        G.make_gather_decoder(code, LayeredSpec(algo="BP"))
    with pytest.raises(NotImplementedError, match="does not fit shared memory"):
        G.make_gather_decoder(make_random_regular_code(58200, 29100, 6, seed=1),
                              LayeredSpec())
    # a QC view is refused by the kernel itself; the raw staircase code
    # decodes in its own (colored) layers, as JAX's gather path takes it
    with pytest.raises(NotImplementedError, match="QC view"):
        G.make_gather_decoder(to_qc_form(load_code("16200x7560")),
                              LayeredSpec())
    assert G.kernel_unsupported_reason(load_code("16200x7560"),
                                       LayeredSpec()) is None


def test_make_decoder_cuda_gather_backend_on_cpu_tensors():
    code = load_code("816x408")
    spec = LayeredSpec(iters=4, early_term=True)
    dec = make_decoder(code, spec, backend="cuda-gather", device="cpu")
    llr = torch.from_numpy(_llrs(code.N, 9, 3))
    bits, iters = dec(llr)
    pb, pi = make_layered_decoder(code, spec)(llr)
    assert torch.equal(bits, pb) and int(iters) == int(pi)


def test_sweep_decodes_4000x2000_on_cpu():
    res = run_sweep(SweepConfig(
        code="4000x2000", iters=5, batch=32, snr_min=2.0, snr_max=2.0,
        max_fe=1000, max_frames=64, device="cpu", seed=3), progress=False)
    (p,) = res.points
    assert p.frames >= 64 and p.frames % 32 == 0  # whole batches in flight
    assert p.ber < 0.02  # the raw channel BER at 2 dB is about 0.06


def test_cli_info_resolves_the_gather_backend(capsys):
    from ldpcgputegra_tpu_torch.sim import cli

    cli.main(["--code", "4000x2000", "--info", "--device", "cuda"])
    out = capsys.readouterr().out
    assert "backend      : cuda-gather" in out
    assert ("11 auto layers, 4 codewords per CTA at batch 1024 on 132 SMs "
            "(w=4 a thread, k=2 lanes a check), 16016 B shared memory") in out
    cli.main(["--code", "16200x7560", "--info", "--device", "cuda"])
    out = capsys.readouterr().out
    assert "backend      : cuda-streamed" in out
    assert "21 (qc 21, sub-pass 0) of the QC view" in out
    cli.main(["--code", "4000x2000", "--info", "--device", "cpu"])
    assert "backend      : torch" in capsys.readouterr().out

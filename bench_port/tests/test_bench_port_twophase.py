"""The ``twophase_sweep`` kind on the CPU at a small size (the 576x288
code at the cell's decoder settings, k1 3, 48 frames a batch, 3 batches a
group, a tail of 8 frames that most batches overflow, so the repaired
batch is checked too): a sound run passes; the control (one message bit
and one LLR bit less) does not; faults planted in the program (phase 2
skipped, the mask inverted) are caught.  The configuration's frozen edge
count against its matrix, the reference's syndrome against the
program's, and the three new readers on synthetic runs."""

import json
import os
import types

import pytest
import torch

from bench_port import cell
from bench_port.common import passes

from ._small import ROOT, drive, small_config

CELL = "wimax_2304x1152_twophase.tail_s16_b8192"


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def small_twophase_run(seed: int = 2**31 + 13, tail: int = 8):
    bench = cell.load_benchmark(ROOT)
    w = cell.workload(bench, CELL)
    conf = cell.load_config(bench, w["config"], ROOT)
    cfg = dict(small_config(), et=conf["et"], k1=3, tail=tail)
    tr = dict(cell.load_traffic(w["traffic"], ROOT), batch=48, scan_steps=3,
              ebn0_db=2.0)
    return cell.load_kind(tr["kind"], ROOT)(cfg, tr, seed, "cpu", ROOT)


def _numbers(numbers):
    return {c["name"]: c["value"] for c in numbers}


def test_config_edge_count_and_settings():
    from ldpcgputegra_tpu_torch.bench.roofline import edge_updates
    from ldpcgputegra_tpu_torch.codes.registry import load_code

    from bench_port.reference.codes import schedule_for

    bench = cell.load_benchmark(ROOT)
    cfg = cell.load_config(bench, "wimax_2304x1152_twophase", ROOT)
    assert schedule_for(cfg, ROOT).edge_updates == cfg["edge_updates"] == 7296
    assert edge_updates(load_code(cfg["code"])) == cfg["edge_updates"]
    with open(os.path.join(ROOT, "bench_port", "configs",
                           "wimax_2304x1152.json")) as f:
        wimax = json.load(f)
    keys = ("code", "n", "k", "z", "algo", "iters", "offset", "minclamp",
            "quant_factor", "bits_llr", "var_bits", "msg_bits")
    assert {k: cfg[k] for k in keys} == {k: wimax[k] for k in keys}
    assert (cfg["et"], cfg["k1"]) == ("twophase", 5)


def test_sound_run_passes_and_the_control_fails():
    run = small_twophase_run()
    numbers = drive(run, 0.5)
    assert passes(numbers), numbers
    assert set(_numbers(numbers)) == {"llr_mismatch", "count_mismatch",
                                      "unconverged_mismatch"}
    assert run.attempted > 0 and run.failed == 0
    tp = run.layer["twophase"]
    assert tp["batches"] == run.batches and tp["repairs"] > 0
    # the groups checked, and one repaired batch outside them
    assert run.checked > 3
    cfg = run.config
    control = _numbers(run.check(msg_bits=cfg["msg_bits"] - 1,
                                 bits_llr=cfg["bits_llr"] - 1))
    assert control["llr_mismatch"] > 0 and control["count_mismatch"] > 0


def _phase2_skipped(tp):
    step, repair = tp.step, tp.repair

    def skipped(llr, tail):
        _, n_bad = step(llr, tail)
        return repair(llr, 0), n_bad  # phase 1's bits alone

    tp.step = skipped
    tp.repair = lambda llr, n_bad: repair(llr, 0)
    return tp


@pytest.mark.parametrize("fault", ["phase2_skipped", "mask_inverted"])
def test_planted_faults_are_not_correct(monkeypatch, fault):
    import ldpcgputegra_tpu_torch.decoder as decoder
    from ldpcgputegra_tpu_torch.decoder import twophase

    if fault == "phase2_skipped":
        made = twophase.make_twophase_decoder
        monkeypatch.setattr(twophase, "make_twophase_decoder",
                            lambda *a, **k: _phase2_skipped(made(*a, **k)))
    else:
        made = decoder.make_decoder

        def inverted(*a, **k):
            dec = made(*a, **k)
            if not k.get("emit_mask"):
                return dec

            def f(llr):
                bits, iters, ok = dec(llr)
                return bits, iters, ~ok
            return f

        monkeypatch.setattr(decoder, "make_decoder", inverted)
    numbers = _numbers(drive(small_twophase_run(tail=48), 0.3))
    assert numbers["count_mismatch"] > 0 or numbers[
        "unconverged_mismatch"] > 0, numbers
    assert numbers["llr_mismatch"] == 0


def test_reference_syndrome_equals_the_programs():
    from ldpcgputegra_tpu_torch.codes.registry import load_code
    from ldpcgputegra_tpu_torch.decoder.twophase import syndrome_fn

    from bench_port.reference.codes import schedule_for
    from bench_port.reference.twophase import satisfied

    for name in ("wimax_2304x1152", "dvbs2_16200x10800"):
        cfg = cell.load_config(cell.load_benchmark(ROOT), name, ROOT)
        g = torch.Generator().manual_seed(3)
        bits = torch.zeros((10, cfg["n"]), dtype=torch.uint8)
        bits[:4] = torch.randint(0, 2, (4, cfg["n"]), generator=g,
                                 dtype=torch.uint8)
        bits[5:, 7] = 1
        bits[9, 7] = 0
        want = syndrome_fn(load_code(cfg["code"]), "cpu")(bits)
        got = satisfied(schedule_for(cfg, ROOT), bits)
        assert torch.equal(got, want)
        assert got[4] and got[9] and not got[5:9].any()


def _layer(**tp):
    base = {"batches": 160, "frames": 160 * 8192, "unconverged": 160 * 150,
            "tail_frames": 160 * 256, "repairs": 0, "repaired_frames": 0}
    base.update(tp)
    return {"batch": 8192, "n": 2304, "edge_updates": 7296, "k1": 5,
            "iters": 10, "tail": 256, "phase1_tile": 16, "phase2_tile": 4,
            "twophase": base}


def _timeline(kernels):
    def kern(part):
        hits = [v for k, v in kernels.items() if part in k]
        return sum(v[0] for v in hits), sum(v[1] for v in hits)
    return types.SimpleNamespace(kernel=kern, kernels=kernels)


HW = {"sms": 132, "clock_hz": 1.98e9}
K1 = "void (anonymous namespace)::layered_minsum_kernel<{}, 4, 8, 1, true>(P)"


def test_twophase_k1_roofline():
    read = cell.load_reader("twophase_k1_roofline", ROOT)
    rate = 132 * 64 * 1.98e9
    one = 7296 * 21 / rate  # an edge update's iteration of one frame
    p1, p2 = 8192 * 5 * one, 256 * 10 * one
    kern = {K1.format(16): [160 * 2 * p1, 160], K1.format(4):
            [160 * 4 * p2, 160]}
    ctx = types.SimpleNamespace(timeline=_timeline(kern), layer=_layer(),
                                hw=HW)
    # half its bound in phase 1, a quarter in phase 2
    assert read(ctx) == pytest.approx(100 * (p1 + p2) / (2 * p1 + 4 * p2))
    # a repair adds a phase 1 and a phase 2 of its unconverged frames
    lay = _layer(repairs=2, repaired_frames=600)
    kern[K1.format(16)] = [162 * p1 + 2 * 300 * 10 * one, 164]
    kern[K1.format(4)] = [160 * p2, 160]
    want = (162 * p1 + 160 * p2 + 2 * 300 * 10 * one) / 324
    got = read(types.SimpleNamespace(timeline=_timeline(kern), layer=lay,
                                     hw=HW))
    assert got == pytest.approx(100 * want / (sum(v[0] for v in kern.values())
                                              / 324))
    for ctx in (types.SimpleNamespace(timeline=None, layer=_layer(), hw=HW),
                types.SimpleNamespace(timeline=_timeline({}), layer=_layer(),
                                      hw=HW),
                types.SimpleNamespace(timeline=_timeline(kern), layer={},
                                      hw=HW)):
        assert read(ctx) is None


def test_twophase_tail_share():
    read = cell.load_reader("twophase_tail_share", ROOT)
    kern = {K1.format(16): [6.0, 160], K1.format(4): [1.5, 160],
            "void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<>": [0.2,
                                                                       320],
            "void at::native::vectorized_gather_kernel<16, long>": [0.2, 320],
            "void at::native::index_elementwise_kernel<128, 4, at::native::"
            "index_copy_kernel_impl<>>": [0.1, 160],
            "void at::native::vectorized_elementwise_kernel<4, at::native::"
            "bitwise_not_kernel_cuda>": [0.05, 160],
            "void at::native::distribution_elementwise_grid_stride": [1.0,
                                                                     160],
            "awgn_quantize_kernel": [1.0, 160]}
    ctx = types.SimpleNamespace(timeline=_timeline(kern), layer=_layer())
    assert read(ctx) == pytest.approx(100 * 2.0 / 10.05)
    assert read(types.SimpleNamespace(
        timeline=_timeline(kern), layer=dict(_layer(), phase2_tile=16))) is None
    assert read(types.SimpleNamespace(
        timeline=_timeline(kern), layer=dict(_layer(), phase2_tile=None))) \
        is None
    assert read(types.SimpleNamespace(timeline=None, layer=_layer())) is None


def test_twophase_iters_per_frame():
    read = cell.load_reader("twophase_iters_per_frame", ROOT)
    ctx = types.SimpleNamespace(timeline=None, layer=_layer())
    assert read(ctx) == pytest.approx(5 + 10 * 256 / 8192)
    lay = _layer(repairs=1, repaired_frames=300)
    assert read(types.SimpleNamespace(timeline=None, layer=lay)) == \
        pytest.approx(5 + (5 * 8192 + 10 * (160 * 256 + 300)) / (160 * 8192))
    assert read(types.SimpleNamespace(timeline=None, layer={})) is None

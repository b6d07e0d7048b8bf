"""Two-phase early termination in the port's sweep (``SweepConfig.et =
"twophase"``, ``sim/sweep.py``) on the CPU, where the S batches of a
dispatch run as a loop of the same fixed-tail step a CUDA graph replays
on the card: every batch's (BE, FE, unconverged) equals plain two-phase
semantics, computed by the benchmark's reference
(``bench_port/reference/twophase.py``: plain PyTorch on the raw matrix
file) from the same seeds, whatever S, the tail and the number of
batches repaired at a fetch; the S batches of a dispatch share one
phase-2 call, with the counts, repairs, checkpoints and FE stop of phase
2 a batch at a time; ``twophase.stats`` counts the repairs and phase 2's
calls; the benchmark's reader of those calls; the spans and the CLI's
flags."""

import contextlib
import dataclasses
import os

import pytest
import torch

from bench_port.reference.channel import seeded, zero_llrs
from bench_port.reference.codes import load_schedule
from bench_port.reference.decoder import Fixed
from bench_port.reference.twophase import decode_twophase
from ldpcgputegra_tpu_torch.decoder import twophase
from ldpcgputegra_tpu_torch.sim import sweep
from ldpcgputegra_tpu_torch.sim.sweep import SweepConfig, batch_seed, run_sweep

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the cores, and the
    many small tensor ops here run far slower on a pool of threads that
    competes with them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(**kw):
    base = dict(code="576x288", algo="OMS", iters=8, et="twophase",
                twophase_k1=3, twophase_tail=16, snr_min=1.5, snr_max=2.5,
                snr_step=1.0, batch=64, max_fe=10**9, auto_fe=False,
                max_frames=4 * 64, pipeline_depth=2, seed=2**31 + 17,
                device="cpu")
    base.update(kw)
    return SweepConfig(**base)


def _run(cfg):
    """The sweep's rows by (point, batch), and its points."""
    rows = {}

    def on_counts(point, first, got):
        for j, r in enumerate(got):
            rows[point, first + j] = tuple(r)

    res = run_sweep(cfg, progress=False, on_counts=on_counts)
    return rows, res.points


def _reference(cfg, keys):
    """{(point, batch): (BE, FE, unconverged)} by the reference, each
    batch's LLRs made from its seed."""
    n, k = (int(v) for v in cfg.code.split("x"))
    snrs = [cfg.snr_min + i * cfg.snr_step for i in range(
        round((cfg.snr_max - cfg.snr_min) / cfg.snr_step) + 1)]
    sched = load_schedule(os.path.join(
        ROOT, "ldpcgputegra_tpu", "codes", "data", cfg.code + ".json"))
    fx = Fixed(algo=cfg.algo, iters=cfg.iters, offset=cfg.offset,
               var_bits=cfg.var_bits, msg_bits=cfg.msg_bits,
               minclamp=cfg.minclamp)
    out = {}
    for pi, kb in keys:
        llr = zero_llrs(seeded(batch_seed(cfg.seed, pi, kb), "cpu"),
                        cfg.batch, n, k, snrs[pi], cfg.quant_factor,
                        cfg.bits_llr, "cpu")
        bits, bad = decode_twophase(sched, llr, fx, cfg.twophase_k1)
        err = bits != 0
        out[pi, kb] = (int(err.sum()), int(err.any(1).sum()),
                       int(bad.sum()))
    return out


@pytest.mark.parametrize("code,batch,iters,tail", [
    ("576x288", 64, 8, 16),
    ("576x288", 128, 10, 128),
    ("2304x1152", 48, 6, 8),
])
def test_counts_equal_plain_two_phase(code, batch, iters, tail):
    cfg = _cfg(code=code, batch=batch, iters=iters, twophase_tail=tail,
               max_frames=3 * batch, scan_steps=3)
    rows, points = _run(cfg)
    assert rows == _reference(cfg, sorted(rows))
    assert sum(p.batches for p in points) == len(rows) >= 6
    assert sum(r[1] for r in rows.values()) > 0  # frames fail: not trivial
    assert all(0 < r[2] for r in rows.values())


def test_scan_steps_one_and_four_agree():
    a, pa = _run(_cfg(scan_steps=1, pipeline_depth=1, max_frames=4 * 64))
    b, pb = _run(_cfg(scan_steps=4, pipeline_depth=1, max_frames=4 * 64))
    assert a == b and len(a) == 8
    assert [(p.frames, p.be, p.fe) for p in pa] == [
        (p.frames, p.be, p.fe) for p in pb]


def _sweep(monkeypatch, cfg):
    """The sweep's rows by (point, batch); its points' (SNR, frames, BE,
    FE, batches); the change of ``twophase.stats``; and each checkpoint
    it wrote, its ``partial`` without the clock."""
    saved = []

    def save(path, state):
        part = state["partial"] and dict(state["partial"])
        if part:
            del part["elapsed_s"]
        saved.append(part)

    monkeypatch.setattr(sweep, "_save_ckpt", save)
    before = dict(twophase.stats)
    rows, points = _run(cfg)
    monkeypatch.undo()
    return (rows, [(p.snr_db, p.frames, p.be, p.fe, p.batches)
                   for p in points],
            {k: twophase.stats[k] - before[k] for k in before}, saved)


_MAKE = twophase.make_twophase_decoder


def _phase2_a_batch(*a, **k):
    """The two-phase decoder with ``grouped`` a no-op: each batch's phase 2
    its own call, as before the S batches of a dispatch shared one."""
    dec = _MAKE(*a, **k)
    dec.grouped = lambda S: contextlib.nullcontext()
    return dec


_AT_S1 = {}  # the sweep at scan_steps 1, by tail
_PLAIN = {}  # the reference's rows of those batches


@pytest.mark.parametrize("tail", [2, 36, 64])
@pytest.mark.parametrize("S", [1, 2, 4])
def test_one_phase2_call_a_dispatch(monkeypatch, S, tail):
    """The S batches of a dispatch share one phase-2 call: every batch's
    (BE, FE, unconverged) is S=1's and plain two-phase's, at a tail that
    every batch overflows (2), one that some batches at 2.5 dB overflow
    (36) and one that none does (64); the repairs and tail frames are
    S=1's, each checkpoint one that S=1 wrote, and phase 2 runs once a
    dispatch and once a repair."""
    def cfg(s):
        return _cfg(twophase_tail=tail, scan_steps=s, max_frames=8 * 64,
                    pipeline_depth=1)

    if tail not in _AT_S1:
        _AT_S1[tail] = _sweep(monkeypatch, cfg(1))
    rows, points, delta, saved = _sweep(monkeypatch, cfg(S))
    one_rows, one_points, one_delta, one_saved = _AT_S1[tail]
    if not _PLAIN:
        _PLAIN.update(_reference(cfg(1), sorted(one_rows)))
    assert rows == one_rows == _PLAIN and len(rows) == 16
    assert points == one_points
    same = ("batches", "frames", "unconverged", "tail_frames", "repairs",
            "repaired_frames")
    assert {k: delta[k] for k in same} == {k: one_delta[k] for k in same}
    over = sum(r[2] > tail for r in rows.values())
    assert delta["repairs"] == over
    assert (over == 16, 0 < over < 16, over == 0) == (
        tail == 2, tail == 36, tail == 64)
    assert delta["phase2_calls"] == 16 // S + over
    assert all(p in one_saved for p in saved)
    assert len(saved) == 16 // S + 2  # a window's, and each point's end


@pytest.mark.parametrize("S", [1, 2, 4])
def test_fe_stop_and_checkpoints_equal_phase2_a_batch(monkeypatch, S):
    """An FE limit that ends the point part-way, two dispatches in
    flight, a tail that holds every unconverged frame: the point, the stats and every checkpoint's partial equal
    those of the same sweep with phase 2 a batch at a time (same seed, S
    and depth), but for the phase-2 calls; the batches both ran equal
    S=1's."""
    cfg = _cfg(twophase_tail=64, scan_steps=S, snr_max=1.5, max_fe=100,
               max_frames=10**6, pipeline_depth=2)
    rows, points, delta, saved = _sweep(monkeypatch, cfg)
    monkeypatch.setattr(twophase, "make_twophase_decoder", _phase2_a_batch)
    a_rows, a_points, a_delta, a_saved = _sweep(monkeypatch, cfg)
    one_rows = _sweep(monkeypatch, dataclasses.replace(cfg, scan_steps=1))[0]
    assert (rows, points, saved) == (a_rows, a_points, a_saved)
    assert delta.pop("phase2_calls") == len(rows) // S + delta["repairs"]
    a_delta.pop("phase2_calls")
    assert delta == a_delta
    (p,) = points
    assert p[3] >= 100 and p[4] < 40  # the FE limit ended it
    assert {k: rows[k] for k in one_rows if k in rows} == {
        k: one_rows[k] for k in rows if k in one_rows}


def test_overflows_are_repaired_and_counted():
    """A tail of 2 frames overflows in every batch: each is decoded again
    at the fetch, and the counts are still plain two-phase's."""
    cfg = _cfg(twophase_tail=2, scan_steps=2, snr_max=1.5)
    before = dict(twophase.stats)
    rows, (point,) = _run(cfg)
    delta = {k: twophase.stats[k] - before[k] for k in before}
    over = [r for r in rows.values() if r[2] > 2]
    assert len(over) == len(rows) == point.batches
    assert delta == {"batches": len(rows), "frames": 64 * len(rows),
                     "unconverged": sum(r[2] for r in rows.values()),
                     "tail_frames": 2 * len(rows), "repairs": len(over),
                     "repaired_frames": sum(r[2] for r in over),
                     "phase2_calls": len(rows) // 2 + len(over)}
    assert rows == _reference(cfg, sorted(rows))
    assert (point.be, point.fe) == (sum(r[0] for r in rows.values()),
                                    sum(r[1] for r in rows.values()))


def test_a_tail_as_large_as_the_batch_never_repairs():
    cfg = _cfg(twophase_tail=10**6, snr_max=1.5)
    before = twophase.stats["repairs"]
    rows, _ = _run(cfg)
    assert twophase.stats["repairs"] == before
    assert rows == _reference(cfg, sorted(rows))


def test_kernel_et_counts_stay_two_per_batch():
    rows, (point,) = _run(_cfg(et="kernel", snr_max=1.5, scan_steps=2))
    assert all(len(r) == 2 for r in rows.values())
    assert point.be == sum(r[0] for r in rows.values())


@pytest.mark.parametrize("kw", [dict(et="both"), dict(backend="native"),
                                dict(twophase_k1=9), dict(twophase_k1=0),
                                dict(twophase_tail=0)])
def test_bad_settings_raise(kw):
    with pytest.raises(ValueError):
        run_sweep(_cfg(**kw), progress=False)


def test_step_and_repair_against_the_serial_decode():
    """``step`` at a tail that holds every unconverged frame is the serial
    two-phase decode; at a smaller one its count still is, and
    ``repair`` then gives the serial decode's bits."""
    from ldpcgputegra_tpu_torch.codes.registry import load_code
    from ldpcgputegra_tpu_torch.ops.layered import LayeredSpec

    code = load_code("576x288")
    tp = twophase.make_twophase_decoder(code, LayeredSpec(algo="OMS",
                                                          iters=8),
                                        k1=3, device="cpu")
    llr = zero_llrs(seeded(5, "cpu"), 64, 576, 288, 1.5, 8, 6, "cpu")
    want, stats = tp(llr)
    n_bad = stats["phase2_frames"]
    assert 2 < n_bad < 64
    bits, cnt = tp.step(llr, 64)
    assert torch.equal(bits, want) and int(cnt) == n_bad
    bits, cnt = tp.step(llr, 2)
    assert int(cnt) == n_bad and not torch.equal(bits, want)
    assert torch.equal(tp.repair(llr, n_bad), want)


def test_spans_of_the_two_phases_and_the_repair():
    from ldpcgputegra_tpu_torch.utils import profiling

    cfg = _cfg(twophase_tail=2, scan_steps=2, snr_max=1.5,
               max_frames=2 * 64, pipeline_depth=1)
    before = len(profiling.spans())
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        rows, _ = _run(cfg)
    got = profiling.spans()[before:]
    by = {}
    for r in got:
        by.setdefault(r.name, []).append(r.count)
    # each batch's phase 1, one phase 2 for the dispatch's two tails, then
    # each repair's phase 1 and phase 2
    assert by["ldpc.twophase.phase1"] == [64] * 4
    assert sorted(by["ldpc.twophase.phase2"]) == sorted(
        [2 * 2] + [r[2] for r in rows.values()])
    assert by["ldpc.twophase.repair"] == [2]


def test_cli_flags_and_info(capsys):
    from ldpcgputegra_tpu_torch.sim.cli import (
        build_parser,
        config_from_args,
        main,
    )

    args = build_parser().parse_args(
        ["--et", "twophase", "--k1", "4", "--tail", "32"])
    cfg = config_from_args(args)
    assert (cfg.et, cfg.twophase_k1, cfg.twophase_tail) == ("twophase", 4, 32)
    assert config_from_args(build_parser().parse_args([])).et == "kernel"
    main(["--code", "2304x1152", "--batch", "8192", "--et", "twophase",
          "--info", "--device", "cuda"])
    out = capsys.readouterr().out
    assert "two-phase, phase 1 at 5 iterations" in out
    assert "a tail of 256 frames" in out
    assert "16 codewords per CTA at batch 8192" in out
    assert "4 codewords per CTA at batch 256" in out
    assert dataclasses.replace(cfg, et="kernel").twophase_k1 == 4


def test_phase2_calls_a_batch_reader():
    """``bench_port/metrics/twophase_phase2_calls_per_batch.py`` on a
    two-phase sweep's window at the cell's settings cut small (S=4, a tail
    that about half the batches overflow): one call a dispatch and one a repair,
    over the batches; None where the program has no such counter."""
    import types

    from bench_port import cell
    from bench_port.tests._small import drive, small_config

    bench = cell.load_benchmark(ROOT)
    w = cell.workload(bench, "wimax_2304x1152_twophase.tail_s16_b8192")
    tr = dict(cell.load_traffic(w["traffic"], ROOT), batch=48, scan_steps=4,
              ebn0_db=2.0)
    run = cell.load_kind(tr["kind"], ROOT)(
        dict(small_config(), et="twophase", k1=3, tail=40), tr, 2**31 + 29,
        "cpu", ROOT)
    drive(run, 0.3)
    tp = run.layer["twophase"]
    read = cell.load_reader("twophase_phase2_calls_per_batch", ROOT)
    got = read(types.SimpleNamespace(layer=run.layer, timeline=None, hw={}))
    assert tp["batches"] % 4 == 0 and tp["batches"] > 0
    assert got == (tp["batches"] // 4 + tp["repairs"]) / tp["batches"]
    del tp["phase2_calls"]
    assert read(types.SimpleNamespace(layer=run.layer)) is None
    assert read(types.SimpleNamespace(layer={})) is None

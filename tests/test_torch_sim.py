"""The port's decode -> count chain, error analyzer, sweep, CLI, decoder
factory and bench accounting, against the JAX package where it has a
counterpart."""

import json
import os

import numpy as np
import pytest
import torch

from ldpcgputegra_tpu.bench.harness import throughput_report as j_report
from ldpcgputegra_tpu.codes.registry import load_code as j_load_code
from ldpcgputegra_tpu.decoder import make_decoder as j_make_decoder
from ldpcgputegra_tpu.ops.layered import LayeredSpec as JSpec
from ldpcgputegra_tpu.sim.analyzer import ErrorAnalyzer as JAnalyzer
from ldpcgputegra_tpu.sim.analyzer import count_errors as j_count
from ldpcgputegra_tpu_torch.bench import measure_call, throughput_report
from ldpcgputegra_tpu_torch.codes.registry import load_code
from ldpcgputegra_tpu_torch.decoder import backend_for, make_decoder
from ldpcgputegra_tpu_torch.ops.layered import LayeredSpec
from ldpcgputegra_tpu_torch.sim import cli, sweep
from ldpcgputegra_tpu_torch.sim.analyzer import (
    ErrorAnalyzer,
    count_errors,
    count_errors_async,
)
from ldpcgputegra_tpu_torch.sim.sweep import SweepConfig, run_sweep


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the cores, and the
    many small tensor ops here run far slower on a pool of threads that
    competes with them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_decode_count_chain_matches_jax():
    name, kw = "576x288", dict(algo="OMS", iters=5, early_term=True)
    rng = np.random.default_rng(21)
    std = np.linspace(0.5, 1.0, 64)[:, None]
    llr = np.clip(8.0 * (-1.0 + std * rng.standard_normal((64, 576))),
                  -31, 31).astype(np.int8)
    bits, iters = make_decoder(load_code(name), LayeredSpec(**kw),
                               device="cpu")(torch.from_numpy(llr))
    jbits, jiters = j_make_decoder(j_load_code(name), JSpec(**kw))(llr)
    np.testing.assert_array_equal(bits.numpy(), np.asarray(jbits))
    assert int(iters) == int(jiters)
    be, fe = count_errors(bits)
    assert (be, fe) == j_count(np.asarray(jbits))
    assert fe > 0 and be > fe  # the chain counts real errors here
    ref = np.asarray(jbits)[::-1].copy()
    assert count_errors(bits, torch.from_numpy(ref)) == j_count(
        np.asarray(jbits), ref)
    assert count_errors(bits, info_only=True, k=288) == j_count(
        np.asarray(jbits), info_only=True, k=288)
    be_t, fe_t = count_errors_async(bits)
    assert isinstance(be_t, torch.Tensor) and be_t.dim() == 0


@pytest.mark.parametrize("auto_fe", [True, False])
def test_fe_limit_identical(auto_fe):
    for frames, be in [(10, 50), (10**7, 5000), (10**8, 5000), (10**9, 500),
                       (10**10, 5), (10, 0), (0, 0)]:
        a = ErrorAnalyzer(n=1000, k=500, max_fe=160, auto_fe=auto_fe)
        b = JAnalyzer(n=1000, k=500, max_fe=160, auto_fe=auto_fe)
        a.add_counts(frames, be, 3)
        b.add_counts(frames, be, 3)
        assert (a.fe_limit(), a.fe_limit_achieved(), a.ber, a.fer) == (
            b.fe_limit(), b.fe_limit_achieved(), b.ber, b.fer)


def _tiny_cfg(**kw):
    base = dict(code="576x288", algo="OMS", iters=5, snr_min=1.0,
                snr_max=2.0, snr_step=1.0, batch=128, max_fe=30,
                max_frames=512, seed=7, device="cpu")
    base.update(kw)
    return SweepConfig(**base)


def test_sweep_ber_decreases_with_snr():
    p0, p1 = run_sweep(_tiny_cfg(), progress=False).points
    assert (p0.snr_db, p1.snr_db) == (1.0, 2.0)
    assert p0.frames >= 128 and p1.frames >= 128
    assert p1.ber < p0.ber


def test_sweep_checkpoint_resume_matches_uninterrupted(tmp_path, monkeypatch):
    cfg = dict(max_fe=10_000, max_frames=1024)  # 8 batches per point
    full = run_sweep(_tiny_cfg(**cfg), progress=False)
    ck = str(tmp_path / "ck.json")
    met = str(tmp_path / "m.jsonl")

    calls = []

    def die_on_third_window(self, force=False):
        calls.append(1)
        if len(calls) == 3:
            raise KeyboardInterrupt

    # interrupt mid-point: the checkpoint then holds a partial point
    monkeypatch.setattr(sweep.Terminal, "temp_report", die_on_third_window)
    with pytest.raises(KeyboardInterrupt):
        run_sweep(_tiny_cfg(checkpoint=ck, metrics=met, **cfg))
    monkeypatch.undo()
    with open(ck) as f:
        state = json.load(f)
    assert state["partial"]["batches"] == 2 and not state["done"]
    resumed = run_sweep(_tiny_cfg(checkpoint=ck, metrics=met, **cfg),
                        progress=False)
    for a, b in zip(full.points, resumed.points):
        assert (a.frames, a.be, a.fe, a.batches) == (b.frames, b.be, b.fe,
                                                     b.batches)
    # a rerun reuses the completed points
    again = run_sweep(_tiny_cfg(checkpoint=ck, **cfg), progress=False)
    assert [(p.frames, p.be, p.fe) for p in again.points] == [
        (p.frames, p.be, p.fe) for p in full.points]
    with open(met) as f:
        recs = [json.loads(line) for line in f]
    assert sum(r["type"] == "snr_point" for r in recs) == 2


def test_sweep_qef_cutoff():
    res = run_sweep(_tiny_cfg(snr_min=1.0, snr_max=8.0, qef_fer=1e-6,
                              max_frames=256, max_fe=1000), progress=False)
    assert len(res.points) < 8


@pytest.mark.parametrize("kw,match", [
    (dict(encoder="gf2"), "encoder"),
    (dict(backend="native"), "native"),
    (dict(scan_steps=2), "scan_steps"),
    (dict(schedule="flooding"), "flooding"),
])
def test_sweep_unported_options_raise(kw, match):
    """The name is historical: the four options once refused (the coded
    path, backend='native', scan_steps > 1 and flooding) all run now."""
    (p,) = run_sweep(_tiny_cfg(snr_max=1.0, max_frames=256, **kw),
                     progress=False).points
    assert p.frames >= 256 and 0 < p.fe <= p.frames


def test_cli_runs_one_point(capfd, tmp_path):
    met = str(tmp_path / "m.jsonl")
    cli.main(["--code", "576x288", "--min", "2.0", "--max", "2.0",
              "--fer", "5", "--batch", "64", "--max-frames", "256",
              "--iters", "5", "--device", "cpu", "--quiet", "--metrics", met])
    assert "code=576x288" in capfd.readouterr().out
    with open(met) as f:
        rec = json.loads(f.readline())
    assert rec["snr_db"] == 2.0 and rec["frames"] >= 64
    cli.main(["--code", "1944x972", "--info", "--device", "cpu"])
    assert "backend      : torch" in capfd.readouterr().out
    cli.main(["--code", "576x288", "--histo", "--min", "2.0", "--max", "2.0",
              "--batch", "16", "--max-frames", "16", "--quiet",
              "--device", "cpu"])
    assert "(HISTO) START" in capfd.readouterr().out


def test_cli_flags_match_reference():
    from ldpcgputegra_tpu.sim.cli import build_parser as j_parser

    def dests(p):
        return {a.dest for a in p._actions} - {"help"}

    assert dests(j_parser()) <= dests(cli.build_parser())


def test_backend_routing():
    spec = LayeredSpec()
    qc, nonqc = load_code("1944x972"), load_code("200x100")
    assert backend_for(qc, spec, "cpu") == "torch"
    assert backend_for(qc, spec, torch.device("cuda")) == "cuda"
    # non-QC layers (a non-QC code, or a QC code in the colored schedule)
    # take the gather kernel, a staircase code's QC view the streamed
    # kernel; what no kernel takes raises
    assert backend_for(nonqc, spec, torch.device("cuda")) == "cuda-gather"
    assert backend_for(qc, LayeredSpec(schedule="colored"),
                       torch.device("cuda")) == "cuda-gather"
    assert backend_for(load_code("16200x7560"), spec,
                       torch.device("cuda")) == "cuda-streamed"
    with pytest.raises(NotImplementedError):
        backend_for(load_code("16200x7560"), LayeredSpec(schedule="colored"),
                    torch.device("cuda"))
    assert backend_for(qc, LayeredSpec(schedule="flooding"),
                       torch.device("cuda")) == "torch-flooding"
    with pytest.raises(NotImplementedError, match="run_sweep"):
        backend_for(qc, spec, "cpu", backend="native")
    with pytest.raises(ValueError):
        backend_for(qc, spec, "cpu", backend="pallas")
    assert backend_for(qc, spec, "cpu", backend="cuda") == "cuda"


def test_throughput_accounting_matches_reference():
    assert throughput_report(2.5e-3, 8192, 2304) == j_report(2.5e-3, 8192, 2304)


def test_measure_call_refuses_cpu_tensors():
    with pytest.raises(RuntimeError, match="card"):
        measure_call(lambda x: x, [torch.zeros(4)])


def test_sweep_writes_no_files_without_paths(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    run_sweep(_tiny_cfg(snr_max=1.0, max_frames=128), progress=False)
    assert os.listdir(tmp_path) == []

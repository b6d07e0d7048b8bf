"""The port's coded sweep path (info bits and noise from one generator a
batch, the encoder on the device, errors counted against the codeword),
the flooding sweep, and their CLI flags."""

import json

import pytest
import torch

from ldpcgputegra_tpu_torch.bench import sweep_trace
from ldpcgputegra_tpu_torch.channel.awgn import AwgnChannel
from ldpcgputegra_tpu_torch.codes.registry import load_code
from ldpcgputegra_tpu_torch.sim import cli
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


def _cfg(**kw):
    base = dict(code="576x288", algo="OMS", iters=5, snr_min=1.0,
                snr_max=3.0, snr_step=2.0, batch=128, max_fe=10**9,
                auto_fe=False, max_frames=256, seed=11, pipeline_depth=1,
                encoder="gf2", device="cpu")
    base.update(kw)
    return SweepConfig(**base)


def _raw_ber(code, snr):
    ch = AwgnChannel(code.N, code.K, device="cpu")
    ch.configure(snr)
    return float((ch.generate_zero_int8(ch.generator(3), 64) > 0)
                 .float().mean())


def test_coded_ber_falls_with_snr():
    code = load_code("576x288")
    p0, p1 = run_sweep(_cfg(), progress=False).points
    assert p0.frames == p1.frames == 256
    assert p1.ber < p0.ber < _raw_ber(code, 1.0)
    assert p0.fe > 0


def test_coded_info_ber_counts_k_bits():
    """count_bits='info' counts the first K bits and divides by K, as in
    JAX; the same seeds give the same decodes, so its errors are a part
    of the all-bits count."""
    (a,) = run_sweep(_cfg(snr_max=1.0), progress=False).points
    (i,) = run_sweep(_cfg(snr_max=1.0, count_bits="info"),
                     progress=False).points
    assert a.frames == i.frames
    assert 0 < i.be <= a.be and i.fe <= a.fe
    assert i.ber == i.be / (i.frames * 288)
    assert a.ber == a.be / (a.frames * 576)


def test_coded_checkpoint_resume_mid_point(tmp_path):
    """A sweep cut after 2 batches and resumed to 4 counts what a sweep of
    4 batches does."""
    ck = str(tmp_path / "ck.json")
    run_sweep(_cfg(snr_max=1.0, checkpoint=ck), progress=False)
    with open(ck) as f:
        state = json.load(f)
    done = state["done"].pop("1.0")
    state["partial"] = {"snr": "1.0", "frames": done["frames"],
                        "be": done["be"], "fe": done["fe"],
                        "batches": done["batches"],
                        "elapsed_s": done["runtime_s"]}
    with open(ck, "w") as f:
        json.dump(state, f)
    (resumed,) = run_sweep(_cfg(snr_max=1.0, max_frames=512, checkpoint=ck),
                           progress=False).points
    (whole,) = run_sweep(_cfg(snr_max=1.0, max_frames=512),
                         progress=False).points
    assert (resumed.frames, resumed.be, resumed.fe, resumed.batches) == (
        whole.frames, whole.be, whole.fe, whole.batches) == (
        512, whole.be, whole.fe, 4)


def test_coded_staircase_through_the_qc_view():
    """A staircase code encodes in its base column order and decodes
    through its QC view: at 4 dB the decoder removes nearly every channel
    error (a wrong column order would add thousands)."""
    code = load_code("16200x7560")
    (p,) = run_sweep(_cfg(code="16200x7560", encoder="staircase", iters=3,
                          snr_min=4.0, snr_max=4.0, batch=4, max_frames=4),
                     progress=False).points
    assert p.frames == 4 and p.ber < _raw_ber(code, 4.0) / 100


def test_flooding_sweep_runs_and_corrects():
    code = load_code("576x288")
    (p,) = run_sweep(_cfg(schedule="flooding", encoder="fake", iters=10,
                          snr_min=2.0, snr_max=2.0), progress=False).points
    assert p.frames == 256 and p.ber < _raw_ber(code, 2.0) / 5


def test_cli_coded_flooding_and_scan_flags(capfd):
    args = ["--code", "576x288", "--min", "2.0", "--max", "2.0", "--fer",
            "5", "--batch", "32", "--max-frames", "64", "--iters", "4",
            "--device", "cpu", "--quiet"]
    for extra in (["--encoder", "gf2"], ["--encoder", "auto",
                                         "--all-zero-bits"],
                  ["--schedule", "flooding"], ["--scan-steps", "2"]):
        cfg = cli.config_from_args(cli.build_parser().parse_args(args + extra))
        assert cfg.encoder == (extra[1] if extra[0] == "--encoder" else "fake")
        cli.main(args + extra)
        assert "code=576x288" in capfd.readouterr().out
    assert not cli.config_from_args(cli.build_parser().parse_args(
        args + ["--all-zero-bits"])).random_bits
    cli.main(["--code", "576x288", "--info", "--device", "cuda",
              "--encoder", "gf2", "--scan-steps", "8"])
    out = capfd.readouterr().out
    assert "encoder      : gf2 -> GF2Encoder" in out
    assert "scan steps" not in out  # the coded path is not scan-folded
    cli.main(["--code", "576x288", "--info", "--device", "cuda",
              "--scan-steps", "8"])
    out = capfd.readouterr().out
    assert "scan steps   : 8 batches a dispatch (one CUDA graph" in out
    cli.main(["--code", "16200x7560", "--info", "--device", "cpu",
              "--schedule", "flooding"])
    out = capfd.readouterr().out
    assert "backend      : torch-flooding" in out and "N=16200" in out


def test_native_backend_still_refused():
    """The decoder factory still refuses backend='native' (JAX's has no
    native backend either); the sweep takes it, and on the coded path with
    the port's own channel it counts what backend='auto' counts, as the
    two decoders agree bit for bit on the same LLRs."""
    from ldpcgputegra_tpu_torch.decoder import make_decoder
    from ldpcgputegra_tpu_torch.ops.layered import LayeredSpec

    with pytest.raises(NotImplementedError, match="run_sweep"):
        make_decoder(load_code("576x288"), LayeredSpec(), backend="native",
                     device="cpu")
    native = run_sweep(_cfg(backend="native"), progress=False).points
    auto = run_sweep(_cfg(), progress=False).points
    assert [(p.frames, p.be, p.fe) for p in native] == \
        [(p.frames, p.be, p.fe) for p in auto]
    assert native[0].fe > 0


def test_sweep_trace_refuses_without_a_card(monkeypatch, capfd):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    assert sweep_trace.main(["--code", "576x288", "--scan-steps", "8"]) == 1
    assert "no CUDA device" in capfd.readouterr().err

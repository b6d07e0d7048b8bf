"""The port's native host library (``golden/native.py``, built from its own
copies of the C++ sources) against the JAX package's build of the same
sources: the scalar oracle and the AVX-512 decoder at 4 algorithms x 2
minclamps x ET, the syndrome and accumulate encoder, the Philox channel
byte for byte, and a ``backend='native'`` Philox sweep point against
JAX's counters."""

import os
import shutil

os.environ["OMP_NUM_THREADS"] = "1"  # before either library loads OpenMP

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from ldpcgputegra_tpu.codes.registry import load_code as j_load_code  # noqa: E402
from ldpcgputegra_tpu.golden import native as jn  # noqa: E402
from ldpcgputegra_tpu.golden.decoder import GoldenParams as JParams  # noqa: E402
from ldpcgputegra_tpu.sim.sweep import SweepConfig as JConfig  # noqa: E402
from ldpcgputegra_tpu.sim.sweep import run_sweep as j_run_sweep  # noqa: E402
from ldpcgputegra_tpu_torch.channel.awgn import sigma_for_snr  # noqa: E402
from ldpcgputegra_tpu_torch.codes.registry import load_code  # noqa: E402
from ldpcgputegra_tpu_torch.golden import (  # noqa: E402
    GoldenParams,
    decode_golden,
    decode_oracle,
)
from ldpcgputegra_tpu_torch.golden import native  # noqa: E402
from ldpcgputegra_tpu_torch.sim import cli, sweep  # noqa: E402
from ldpcgputegra_tpu_torch.sim.sweep import SweepConfig, run_sweep  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _llrs(n, b, seed):
    rng = np.random.default_rng(seed)
    return np.clip(8.0 * rng.normal(-1.0, 0.9, size=(b, n)), -31, 31
                   ).astype(np.int8)


def _simd_or_skip():
    if not native.simd_available():
        assert not jn.simd_available()
        pytest.skip("this host has no AVX-512BW: the SIMD decoder is not built")


@pytest.mark.parametrize("et", [False, True])
@pytest.mark.parametrize("minclamp", ["pre", "post"])
@pytest.mark.parametrize("algo", ["MS", "OMS", "NMS", "2NMS"])
def test_golden_native_matches_jax(algo, minclamp, et):
    """576x288 and the non-QC 200x100, 67 frames (a ragged last block of
    64 lanes for the SIMD decoder), runtime NMS factors: bits and
    iterations equal JAX's native ones."""
    kw = dict(algo=algo, iters=5, minclamp=minclamp, early_term=et,
              nms_factor=26 / 32, nms_factor2=30 / 32)
    for name, seed in (("576x288", 3), ("200x100", 4)):
        code, jcode = load_code(name), j_load_code(name)
        llr = _llrs(code.N, 67, seed)
        bits, used = native.decode_golden_native(code, llr, GoldenParams(**kw))
        jbits, jused = jn.decode_golden_native(jcode, llr, JParams(**kw))
        np.testing.assert_array_equal(bits, jbits)
        np.testing.assert_array_equal(used, jused)
        assert bits.dtype == np.int8 and used.shape == (67,)


@pytest.mark.parametrize("et", [False, True])
@pytest.mark.parametrize("minclamp", ["pre", "post"])
@pytest.mark.parametrize("algo", ["MS", "OMS", "NMS", "2NMS"])
def test_simd_native_matches_jax(algo, minclamp, et):
    _simd_or_skip()
    kw = dict(algo=algo, iters=5, minclamp=minclamp, early_term=et,
              nms_factor=29 / 32)
    code, jcode = load_code("576x288"), j_load_code("576x288")
    llr = _llrs(code.N, 67, seed=11)
    bits, used = native.decode_simd_native(code, llr, GoldenParams(**kw))
    jbits, jused = jn.decode_simd_native(jcode, llr, JParams(**kw))
    np.testing.assert_array_equal(bits, jbits)
    assert used == jused and 1 <= used <= 5
    # and the scalar oracle, frame by frame
    gbits, _ = native.decode_golden_native(code, llr, GoldenParams(**kw))
    np.testing.assert_array_equal(bits, gbits)


def test_syndrome_encode_and_oracle_match():
    code, jcode = load_code("576x288"), j_load_code("576x288")
    llr = _llrs(code.N, 8, seed=7)
    gp = GoldenParams(algo="OMS", iters=10)
    bits, _ = native.decode_golden_native(code, llr, gp)
    ok = native.syndrome_ok_native(code, bits)
    np.testing.assert_array_equal(ok, jn.syndrome_ok_native(jcode, bits))
    assert ok.any() and native.syndrome_ok_native(
        code, np.zeros((1, code.N), np.int8))[0]
    # decode_oracle is the native oracle, bit for bit the NumPy model
    obits, oused = decode_oracle(code, llr[:3], gp)
    for b in range(3):
        ref, used = decode_golden(code, llr[b], gp)
        np.testing.assert_array_equal(obits[b], ref)
        assert oused[b] == used
    rng = np.random.default_rng(5)
    n, k = 600, 400
    pos = rng.integers(0, n - k, 3000).astype(np.int32)
    bit = rng.integers(0, k, 3000).astype(np.int32)
    info = rng.integers(0, 2, (5, k)).astype(np.int8)
    np.testing.assert_array_equal(
        native.encode_accumulate_native(pos, bit, info, n, k),
        jn.encode_accumulate_native(pos, bit, info, n, k))


@pytest.mark.parametrize("coded,amp", [(False, 1.0), (True, 1.0),
                                       (True, 2 ** -0.5)])
def test_awgn_philox_matches_jax_bytes(coded, amp):
    """The same (seed, stream, sigma, factor) give the same int8 LLRs as
    JAX's native channel, byte for byte."""
    n, frames = 1944, 33
    sigma = sigma_for_snr(1.75, 0.5)
    c = (np.random.default_rng(2).integers(0, 2, (frames, n)).astype(np.int8)
         if coded else None)
    args = (1234, (3 << 32) | 17, frames, n)
    kw = dict(sigma=sigma, factor=8.0, sat=31, coded=c, amp=amp)
    got = native.awgn_quantize_native(*args, **kw)
    np.testing.assert_array_equal(got, jn.awgn_quantize_native(*args, **kw))
    assert got.dtype == np.int8 and np.abs(got).max() <= 31
    assert 0.0 < (got > 0).mean() < 0.5


def test_native_philox_sweep_point_matches_jax():
    """backend='native', channel_rng='philox': the same (frames, BE, FE)
    at every point as the JAX package's native sweep."""
    kw = dict(code="576x288", algo="OMS", iters=5, snr_min=1.5, snr_max=2.5,
              snr_step=1.0, batch=64, max_fe=40, max_frames=640, seed=9,
              backend="native", channel_rng="philox")
    got = run_sweep(SweepConfig(device="cpu", **kw), progress=False).points
    want = j_run_sweep(JConfig(**kw), progress=False).points
    assert [(p.frames, p.be, p.fe) for p in got] == \
        [(p.frames, p.be, p.fe) for p in want]
    assert got[0].fe > 0


def test_native_refusals(monkeypatch):
    """A staircase code's QC view is refused; so is a point whose first
    batch the device decoder decodes differently."""
    with pytest.raises(NotImplementedError, match="QC-view"):
        run_sweep(SweepConfig(code="16200x7560", backend="native",
                              device="cpu"), progress=False)
    real = sweep._native_decoder

    def flipped(*a):
        dec = real(*a)
        return lambda llr: dec(llr) ^ 1

    monkeypatch.setattr(sweep, "_native_decoder", flipped)
    with pytest.raises(AssertionError, match="refusing to measure"):
        run_sweep(SweepConfig(code="576x288", backend="native", batch=64,
                              max_frames=64, device="cpu"), progress=False)


def test_cli_native(capfd):
    cli.main(["--code", "576x288", "--backend", "native", "--info",
              "--channel-rng", "philox"])
    assert "backend      : native" in capfd.readouterr().out
    cli.main(["--code", "576x288", "--backend", "native", "--channel-rng",
              "philox", "--min", "2", "--max", "2", "--batch", "64",
              "--max-frames", "128", "--iters", "5", "--device", "cpu",
              "--quiet"])
    assert "code=576x288" in capfd.readouterr().out


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    cxx = tmp_path / "g++"
    # it lists a target (the library's name needs one) and fails to compile
    cxx.write_text("#!/bin/sh\ncase \"$*\" in *--help=target*) echo -mavx;"
                   " exit 0;; esac\n"
                   "echo 'oracle.cpp:1: no such luck' >&2\nexit 3\n")
    cxx.chmod(0o755)
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="no such luck"):
        native.build(str(tmp_path / "build"))
    monkeypatch.setenv("PATH", str(tmp_path / "none"))
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.build(str(tmp_path / "build"))
    assert not os.path.exists(tmp_path / "build")


def test_library_name_carries_the_host_target(monkeypatch):
    """A build directory carried to a host whose -march=native resolves
    otherwise is not loaded there: the library's name changes."""
    here = native.library_path()
    assert "-march=" in native.host_target(shutil.which("g++"))
    monkeypatch.setattr(native, "host_target", lambda cxx: "-mno-avx512bw")
    assert native.library_path() != here

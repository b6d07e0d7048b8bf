"""The port's BER book tools against the JAX package's, on the CPU: a tiny
native+Philox curve through both ``run_curve``s (the same points, exactly),
the plain decoder's sweep against JAX's XLA sweep under ``ber_check``'s
exact test, and a tail anchor's ladder (the same SNR and counts)."""

import importlib.util
import os
import sys

os.environ["OMP_NUM_THREADS"] = "1"  # before either native library loads

import pytest  # noqa: E402
import torch  # noqa: E402

from ldpcgputegra_tpu.sim.sweep import SweepConfig as JConfig  # noqa: E402
from ldpcgputegra_tpu.sim.sweep import run_sweep as j_run_sweep  # noqa: E402
from ldpcgputegra_tpu_torch.bench import ber_check, ber_curves  # noqa: E402
from ldpcgputegra_tpu_torch.bench import ber_tail  # noqa: E402
from ldpcgputegra_tpu_torch.golden import native  # noqa: E402
from ldpcgputegra_tpu_torch.sim.sweep import SweepConfig, run_sweep  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_KEYS = ("snr_db", "ber", "fer", "frames", "fe", "be")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tool(name):
    key = "jax_tool_" + name
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            key, os.path.join(ROOT, "tools", name + ".py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules[key] = mod
    return sys.modules[key]


def _simd_or_skip():
    if not native.simd_available():
        pytest.skip("this host has no AVX-512BW: the SIMD decoder is not built")


def test_native_philox_curve_equals_jax(tmp_path, monkeypatch):
    """576x288 OMS 10 at 1.5 and 2.0 dB, batch 256, 1024 frames, on the
    native decoder with the Philox channel: the same points as the JAX
    tool's ``run_curve``, apart from ``backend`` and ``card``."""
    _simd_or_skip()
    jax_mod = _tool("run_ber_curves")
    monkeypatch.setattr(jax_mod, "DATA_DIR", str(tmp_path / "jax"))
    monkeypatch.setattr(ber_curves, "DATA_DIR", str(tmp_path / "port"))
    os.makedirs(tmp_path / "jax")
    os.makedirs(tmp_path / "port")
    args = ("576x288", "OMS", 10, 1.5, 2.0, 0.5, 256, 100, 1024)
    extra = {"backend": "native", "channel_rng": "philox"}
    want = jax_mod.run_curve(*args, extra=dict(extra))
    got = ber_curves.run_curve(*args, extra=dict(extra), device="cpu")
    assert got["backend"] == want["backend"] == "native+philox"
    assert got["card"] is None
    for k in ("code", "algo", "iters", "tag"):
        assert got[k] == want[k]
    assert [{k: p[k] for k in JAX_KEYS} for p in got["points"]] == \
        want["points"]
    assert all(p["mbps"] > 0 and p["runtime_s"] > 0 for p in got["points"])
    assert got["points"][0]["fe"] > 0


def test_plain_sweep_passes_the_exact_test_against_xla():
    """576x288 OMS 10 at 1.5 and 2.0 dB, batch 1024, 4 batches a point:
    the plain decoder on the port's channel against JAX's XLA decoder on
    threefry noise; every point passes ``ber_check``'s test."""
    kw = dict(code="576x288", algo="OMS", iters=10, snr_min=1.5,
              snr_max=2.0, snr_step=0.5, batch=1024, max_fe=10**9,
              auto_fe=False, max_frames=4 * 1024, early_term=True)
    got = run_sweep(SweepConfig(device="cpu", **kw), progress=False).points
    want = j_run_sweep(JConfig(**kw), progress=False).points
    assert [p.snr_db for p in got] == [p.snr_db for p in want]
    for g, w in zip(got, want):
        assert g.fe > 0 and w.fe > 0
        p = ber_check.exact_p(g.fe, g.frames, w.fe, w.frames)
        assert p >= ber_check.P_FAIL, (g, w, p)


def test_tail_anchor_equals_jax(tmp_path, monkeypatch):
    """``anchor`` on 155x93 with a small budget (native, Philox): the
    ladder picks the same SNR and the point has the same counts."""
    _simd_or_skip()
    jax_mod = _tool("tail_ber_points")
    monkeypatch.setattr(jax_mod, "DATA_DIR", str(tmp_path / "jax"))
    monkeypatch.setattr(ber_curves, "BENCH_DIR", str(tmp_path))
    monkeypatch.setattr(ber_curves, "DATA_DIR", str(tmp_path / "port"))
    os.makedirs(tmp_path / "jax")
    os.makedirs(tmp_path / "port")
    want = jax_mod.anchor("155x93", 512, 1.0, 40, 4096)
    got = ber_tail.anchor("155x93", 512, 1.0, 40, 4096, device="cpu")
    assert got["backend"] == want["backend"] == "native+philox"
    (gp,), (wp,) = got["points"], want["points"]
    assert {k: gp[k] for k in JAX_KEYS} == wp
    assert wp["snr_db"] > 1.0 and wp["fe"] >= 40
    assert os.listdir(tmp_path / "port") == ["155x93_OMS_10_tail-anchor.json"]

"""The port imports torch and numpy, never jax, and imports cleanly on a
machine without nvcc, CUDA or triton; ``chip_smoke.py`` refuses to run
without a card or without the package beside it."""

import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import ldpcgputegra_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import ldpcgputegra_tpu_torch.kernels.layered as K
for name in ("sim.cli", "decoder.twophase", "bench.et_study", "sim.scan",
             "decoder.stream", "channel.bitgen", "channel.encoder",
             "ops.flooding", "golden", "golden.decoder", "codes.alist",
             "utils", "utils.profiling", "utils.debug", "parallel",
             "parallel.mesh", "parallel.sharded", "parallel.rowshard",
             "parallel.launch", "parallel.dryrun", "sim.distributed",
             "golden.native", "decoder.extras", "bench.ber_curves",
             "bench.ber_tail", "bench.ber_topup", "bench.ber_check",
             "bench.air", "bench.hw_validate", "bench.et_skip_diag",
             "bench.kernel_et", "bench.profile_16200", "bench.vectors_check",
             "bench.encoder_matrix_check"):
    assert "ldpcgputegra_tpu_torch." + name in names, names
assert len(names) >= 65, names
leaked = sorted(m for m in sys.modules
                if m == "jax" or m.startswith(("jax.", "jaxlib", "triton",
                                               "ldpcgputegra_tpu.")))
print("LEAKED", leaked)
"""


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    env.update(extra)
    return env


def test_every_module_imports_without_jax_or_nvcc(tmp_path):
    res = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=str(tmp_path),
        env=_env(PATH=str(tmp_path), CUDA_HOME=str(tmp_path / "none")),
        capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr
    assert "LEAKED []" in res.stdout, res.stdout


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    from ldpcgputegra_tpu_torch.kernels import layered as K

    monkeypatch.setattr(K, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "none"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        K.build()
    assert not os.path.exists(tmp_path / "build")


def _run_smoke(cwd):
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=str(cwd),
        env=_env(CUDA_VISIBLE_DEVICES=""), capture_output=True, text=True,
        timeout=120,
    )


def test_chip_smoke_fails_without_a_card():
    res = _run_smoke(ROOT)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout and '"kernels"' not in res.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    res = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=str(tmp_path),
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
        capture_output=True, text=True, timeout=120,
    )
    assert res.returncode != 0
    assert '"ok"' not in res.stdout

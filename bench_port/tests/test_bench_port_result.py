"""The result line is withheld when jax or the JAX package is loaded by the
time it is due: a per-layer reader that imports a stub ``jax`` turns a run
that printed its result into one that exits 3 and prints nothing.  The run
goes through everything after the harness's look for a card, on the CPU,
with a small cell added as files."""

import argparse
import json
import os
import sys

import pytest
import torch

from bench_port import run as bench_run

from ._small import ROOT, SMALL_TRAFFIC, small_config, tree

CELL = "wimax_576x288.decode_small"


@pytest.fixture
def no_forbidden_modules():
    """Take jax and the JAX package out of ``sys.modules`` for the test,
    and put back exactly what was there."""
    def forbidden():
        return {k for k in sys.modules
                if k.split(".", 1)[0] in bench_run.FORBIDDEN}

    saved = {k: sys.modules.pop(k) for k in forbidden()}
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
    for k in forbidden():
        del sys.modules[k]
    sys.modules.update(saved)


def _small_cell(root):
    # the raw matrix files the reference reads, as data
    os.symlink(os.path.join(ROOT, "ldpcgputegra_tpu"),
               root / "ldpcgputegra_tpu")
    b = root / "bench_port"
    (b / "configs" / "wimax_576x288.json").write_text(json.dumps(
        dict(small_config(), name="wimax_576x288")))
    tr = json.loads((b / "traffic" / "decode_b8192.json").read_text())
    (b / "traffic" / "decode_small.json").write_text(json.dumps(
        dict(tr, **SMALL_TRAFFIC["decode_b8192"])))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "wimax_576x288", "source": "x",
                             "file": "bench_port/configs/wimax_576x288.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": CELL, "config": "wimax_576x288",
                               "traffic": "decode_small", "chips": 1,
                               "why": "x"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "wimax_2304x1152.decode_b8192" in m.get("workloads", []):
            m["workloads"].append(CELL)
    return bench


def _run(root, bench, capsys):
    args = argparse.Namespace(workload=CELL, seed=2**31 + 11, seconds=0.3,
                              trace=1)
    rc = bench_run.run_cell(args, bench, bench["workloads"][-1],
                            torch.device("cpu"), 0.0, str(root))
    return rc, capsys.readouterr()


def test_a_reader_that_loads_jax_withholds_the_result(
        tmp_path, monkeypatch, capsys, no_forbidden_modules):
    monkeypatch.setattr(bench_run, "card", lambda device: {
        "name": "cpu", "sms": 1, "clock_hz": None, "power_limit": "none"})
    root = tree(tmp_path / "checkout")
    bench = _small_cell(root)

    rc, out = _run(root, bench, capsys)
    assert rc == 0, out.err[-2000:]
    res = json.loads(out.out.strip().splitlines()[-1])
    assert res["correct"] and "device_idle_share.decode" in res["metrics"]

    stub = tmp_path / "stub" / "jax"
    stub.mkdir(parents=True)
    (stub / "__init__.py").write_text("")
    monkeypatch.syspath_prepend(str(tmp_path / "stub"))
    (root / "bench_port" / "metrics" / "plant.py").write_text(
        "def read(ctx):\n    import jax\n    return 1.0\n")
    bench["per_layer"].append({"name": "plant", "unit": "1",
                               "better": "higher", "source": "device_trace",
                               "layer": "x", "moves": "decode_mbps",
                               "workloads": [CELL]})

    rc, out = _run(root, bench, capsys)
    assert rc == 3
    assert out.out == ""
    assert "loaded after the window: jax" in out.err

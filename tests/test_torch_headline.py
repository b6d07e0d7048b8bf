"""``ldpcgputegra_tpu_torch/bench/headline.py``, the port of ``bench.py``, on
the CPU: its configuration equals ``bench.py``'s (read with ``ast``, never
imported: it imports jax), ``record()``'s arithmetic and keys, and the
refusal without a card (non-zero exit, nothing on standard output, no
file written or read, no stored record replayed)."""

import ast
import builtins
import inspect
import json
import os
import subprocess
import sys

import pytest
import torch

from ldpcgputegra_tpu_torch.bench import headline as H
from ldpcgputegra_tpu_torch.codes.registry import load_code
from ldpcgputegra_tpu_torch.decoder import backend_for

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_PY = os.path.join(ROOT, "bench.py")
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"


def _bench_py():
    """(module tree, ``_measure``'s tree) of ``bench.py``."""
    tree = ast.parse(open(BENCH_PY).read())
    measure = next(n for n in tree.body
                   if isinstance(n, ast.FunctionDef) and n.name == "_measure")
    return tree, measure


def _calls(node, name):
    return [c for c in ast.walk(node) if isinstance(c, ast.Call)
            and name in (getattr(c.func, "id", None),
                         getattr(c.func, "attr", None))]


def test_code_batch_and_spec_equal_bench_py():
    _, m = _bench_py()
    (load,) = _calls(m, "load_code")
    assert load.args[0].value == H.CODE == "2304x1152"
    batch = next(a.value.value for a in ast.walk(m) if isinstance(a, ast.Assign)
                 and getattr(a.targets[0], "id", None) == "batch")
    assert batch == H.BATCH == 8192
    (spec,) = _calls(m, "LayeredSpec")
    kw = {k.arg: k.value.value for k in spec.keywords}
    assert kw == {"algo": "OMS", "iters": 10, "early_term": False,
                  "minclamp": "pre", "schedule": "auto"}
    assert {k: getattr(H.SPEC, k) for k in kw} == kw


def test_channel_and_inputs_equal_bench_py():
    _, m = _bench_py()
    (chan,) = _calls(m, "AwgnChannel")
    (cspec,) = _calls(chan, "ChannelSpec")
    assert not cspec.args and not cspec.keywords  # the default channel
    (conf,) = _calls(m, "configure")
    assert conf.args[0].value == H.SNR_DB == 3.0
    (rng,) = _calls(m, "range")
    assert rng.args[0].value == H.N_INPUTS == 8


def test_baseline_and_metric_equal_bench_py():
    tree, m = _bench_py()
    base = next(a.value.value for a in tree.body if isinstance(a, ast.Assign)
                and a.targets[0].id == "BASELINE_MBPS")
    assert base == H.BASELINE_MBPS == 132.0
    metrics = {c.value for c in ast.walk(m) if isinstance(c, ast.Constant)
               and isinstance(c.value, str) and c.value.startswith("decode_")}
    assert metrics == {"decode_throughput_2304x1152_oms_10it"}
    assert H.METRIC == metrics.pop() + "_cuda"
    units = {c.value for c in ast.walk(m) if isinstance(c, ast.Constant)
             and c.value == H.UNIT}
    assert units == {"coded-Mbps/chip"}


def test_record_arithmetic_and_keys():
    rec = H.record(1.5394e-3, CARD)
    assert list(rec) == ["metric", "value", "unit", "vs_baseline", "device"]
    assert rec["metric"] == "decode_throughput_2304x1152_oms_10it_cuda"
    assert rec["unit"] == "coded-Mbps/chip" and rec["device"] == CARD
    # coded bits per second: 8192 frames x 2304 bits / 1.5394 ms
    assert rec["value"] == round(8192 * 2304 / 1.5394e-3 / 1e6, 1) == 12260.9
    assert rec["vs_baseline"] == round(12260.89 / 132.0, 2) == 92.89
    assert json.loads(json.dumps(rec)) == rec
    slow = H.record(2 * 1.5394e-3, CARD)
    assert slow["value"] == pytest.approx(rec["value"] / 2, abs=0.1)


def test_the_headline_times_k1():
    assert backend_for(load_code(H.CODE), H.SPEC, "cuda") == "cuda"


def test_no_fallback_in_the_source():
    src = inspect.getsource(H)
    body = src.split('"""', 2)[2]  # past the docstring
    for word in ("try:", "except", "RESULTS", "open(", "stale"):
        assert word not in body, word


def test_without_a_card_nothing_is_printed_read_or_written(
        monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    opened = []
    real_open = builtins.open

    def spy(path, *a, **kw):
        opened.append(str(path))
        return real_open(path, *a, **kw)

    monkeypatch.setattr(builtins, "open", spy)
    monkeypatch.chdir(tmp_path)
    assert H.main([]) != 0
    out, err = capsys.readouterr()
    assert out == "" and "no CUDA device" in err
    assert opened == [] and os.listdir(tmp_path) == []


def test_without_a_card_the_module_exits_non_zero(tmp_path):
    res = subprocess.run(
        [sys.executable, "-m", "ldpcgputegra_tpu_torch.bench.headline"],
        cwd=str(tmp_path), capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": ROOT, "CUDA_VISIBLE_DEVICES": ""},
    )
    assert res.returncode != 0
    assert res.stdout == "" and "no CUDA device" in res.stderr
    assert os.listdir(tmp_path) == []

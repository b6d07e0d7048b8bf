"""The port of the JAX package's BER book and air bench tools
(``bench/ber_curves.py``, ``ber_tail.py``, ``ber_topup.py``,
``ber_check.py``, ``air.py``) against ``tools/*.py``, without a JAX
compile: their tables, ``curve_id``, ``write_md``'s rows, ``merge_point``;
the exact test against ``scipy.stats.binomtest``; ``--book`` on a planted
book; ``_backend_for`` on a failed native build."""

import copy
import importlib.util
import json
import os
import shutil
import sys

import pytest
import scipy.stats
import torch

from ldpcgputegra_tpu_torch.bench import air, ber_check, ber_curves, ber_tail
from ldpcgputegra_tpu_torch.bench import ber_topup
from ldpcgputegra_tpu_torch.golden import native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_BOOK = os.path.join(ROOT, "benchmarks", "ber_data")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tool(name):
    """``tools/<name>.py`` loaded by path (it imports, nothing compiles)."""
    key = "jax_tool_" + name
    if key not in sys.modules:
        if name == "topup_points":  # it imports its sibling by name
            sys.modules.setdefault("run_ber_curves", _tool("run_ber_curves"))
        spec = importlib.util.spec_from_file_location(
            key, os.path.join(ROOT, "tools", name + ".py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules[key] = mod
    return sys.modules[key]


@pytest.mark.parametrize("ours,tool,attr", [
    (ber_curves, "run_ber_curves", "CURVES"),
    (ber_tail, "tail_ber_points", "TAIL"),
    (ber_check, "ber_spotcheck", "SPOTS"),
    (air, "run_air_bench", "CONFIGS"),
    (air, "run_air_bench", "DEPTHS"),
    (air, "run_air_bench", "SNR_DB"),
])
def test_tables_equal_the_jax_tools(ours, tool, attr):
    assert getattr(ours, attr) == getattr(_tool(tool), attr)


def test_curve_id_matches():
    jax_id = _tool("run_ber_curves").curve_id
    for ent in ber_curves.CURVES:
        tag = ent[7].get("tag", "") if len(ent) > 7 else ""
        assert ber_curves.curve_id(*ent[:3], tag) == jax_id(*ent[:3], tag)
    assert len({ber_curves.curve_id(*e[:3], e[7].get("tag", "") if len(e) > 7
                                    else "") for e in ber_curves.CURVES}) == 18


def _sections(text):
    """{section title: its table rows} of a BER.md."""
    out = {}
    for block in text.split("\n## ")[1:]:
        title, _, body = block.partition("\n")
        out[title] = [ln for ln in body.splitlines() if ln.startswith("| ")]
    return out


def test_write_md_rows_equal_jax(tmp_path, monkeypatch):
    """The same data directory (JAX book files, and one in the port's
    schema) gives the same section titles and rows as JAX's write_md."""
    data = tmp_path / "ber_data"
    data.mkdir()
    for fn in ("1944x972_OMS_10.json", "576x288_OMS_10_rayleigh.json",
               "576x288_OMS_10_qpsk-coded.json", "155x93_OMS_10_tail-anchor.json",
               "64800x32400_OMS_10.json"):
        shutil.copy(os.path.join(JAX_BOOK, fn), data)
    with open(os.path.join(JAX_BOOK, "4000x2000_OMS_10.json")) as f:
        port = json.load(f)
    port.update(tag="coded-info", code="16200x10800", backend="cuda",
                card="NVIDIA H100 80GB HBM3, 700.00 W")
    for p in port["points"]:
        p.update(mbps=1234.5, runtime_s=1.5)
    (data / "16200x10800_OMS_10_coded-info.json").write_text(json.dumps(port))
    (data / "ckpt_1944x972_OMS_10.json").write_text("{}")
    jax_mod = _tool("run_ber_curves")
    monkeypatch.setattr(jax_mod, "BENCH_DIR", str(tmp_path / "jax"))
    monkeypatch.setattr(jax_mod, "DATA_DIR", str(data))
    monkeypatch.setattr(ber_curves, "BENCH_DIR", str(tmp_path / "port"))
    monkeypatch.setattr(ber_curves, "DATA_DIR", str(data))
    os.makedirs(tmp_path / "jax")
    want = _sections(open(jax_mod.write_md()).read())
    got = _sections(open(ber_curves.write_md()).read())
    assert len(want) == 6
    for title, rows in want.items():
        assert got[title] == rows, title
    assert list(got)[:6] == list(want)  # the CURVES order, then the rest
    assert os.path.exists(tmp_path / "jax" / "BER.md")


MERGE_CASES = [
    ([], {"snr_db": 2.0, "fe": 3, "frames": 10}),
    ([(1.0, 50, 1000), (2.0, 20, 5000)], (1.5, 30, 2000)),
    ([(2.5, 25, 897_024)], (2.5, 100, 4_685_824)),
    ([(2.5, 25, 897_024)], (2.5, 4, 245_760)),
    ([(2.5, 25, 897_024)], (2.5, 25, 1_000_000)),
    ([(2.5, 25, 1_000_000)], (2.5, 25, 500_000)),
    ([(3.0, 1, 10), (1.0, 5, 10)], (0.5, 9, 10)),
    ([(2.0, 5, 100)], (2.0 + 1e-12, 5, 100)),
]


def _pt(t):
    if isinstance(t, dict):
        return dict(t)
    snr, fe, frames = t
    return {"snr_db": snr, "fe": fe, "frames": frames, "ber": 1e-7,
            "fer": fe / frames, "be": 10 * fe}


@pytest.mark.parametrize("points,rec", MERGE_CASES)
def test_merge_point_equals_jax(points, rec):
    jax_merge = _tool("topup_points").merge_point
    ours, theirs = [_pt(p) for p in points], [_pt(p) for p in points]
    r = _pt(rec)
    assert ber_topup.merge_point(ours, copy.deepcopy(r)) == jax_merge(
        theirs, copy.deepcopy(r))
    assert ours == theirs


@pytest.mark.parametrize("n1,n2", [(1000, 1000), (24576, 40960),
                                   (16384, 3_000_000), (3_000_000, 512),
                                   (8192, 8193)])
def test_exact_p_equals_binomtest(n1, n2):
    counts = [0, 1, 2, 3, 5, 8, 13, 30, 100, 257]
    for fe1 in counts:
        for fe2 in counts:
            if fe1 + fe2 == 0:
                continue
            want = scipy.stats.binomtest(fe1, fe1 + fe2,
                                         n1 / (n1 + n2)).pvalue
            got = ber_check.exact_p(fe1, n1, fe2, n2)
            assert got == pytest.approx(want, rel=1e-9, abs=1e-300), (fe1, fe2)
    assert ber_check.exact_p(0, n1, 0, n2) == 1.0


def test_planted_2x_fer_fails_and_equal_counts_pass():
    # twice the FER at 100 FE: 100 errors in 500k frames against 1M
    assert ber_check.exact_p(100, 500_000, 100, 1_000_000) < ber_check.P_FAIL
    assert ber_check.exact_p(200, 1_000_000, 100, 1_000_000) < ber_check.P_FAIL
    assert ber_check.exact_p(100, 1_000_000, 100, 1_000_000) == \
        pytest.approx(1.0)
    # a deep point at 0 FE against 7 in 3x the frames is no evidence
    assert ber_check.exact_p(0, 3_000_000, 7, 10_006_528) > ber_check.P_WATCH
    with pytest.raises(ValueError):
        ber_check.exact_p(1, 0, 1, 10)


def _curve(code, tag, points, backend="cuda"):
    return {"code": code, "algo": "OMS", "iters": 10, "tag": tag,
            "backend": backend, "card": "NVIDIA H100 80GB HBM3, 700.00 W",
            "points": [{"snr_db": s, "fe": fe, "frames": n, "fer": fe / n,
                        "be": 10 * fe, "ber": 10 * fe / n / 1944, "mbps": 1.0,
                        "runtime_s": 0.1} for s, fe, n in points]}


def test_book_against_jax_and_twins(tmp_path, monkeypatch, capsys):
    """``--book``: each point against the JAX book's, the coded-info twin
    against zero-info, points without a counterpart listed, exit 1 on a
    failing point and 0 otherwise; BER.md carries the table."""
    data = tmp_path / "ber_data"
    data.mkdir()
    monkeypatch.setattr(ber_curves, "BENCH_DIR", str(tmp_path))
    monkeypatch.setattr(ber_curves, "DATA_DIR", str(data))
    # the JAX book: 2.0 dB 127/40960, 2.25 dB 51/221184
    good = _curve("1944x972", "", [(2.0, 120, 40960), (2.25, 50, 221184),
                                   (3.0, 0, 1000)])
    (data / "1944x972_OMS_10.json").write_text(json.dumps(good))
    (data / "16200x10800_OMS_10_zero-info.json").write_text(json.dumps(
        _curve("16200x10800", "zero-info", [(1.8, 900, 1024), (2.0, 100, 4096),
                                            (2.8, 3, 1000)])))
    (data / "16200x10800_OMS_10_coded-info.json").write_text(json.dumps(
        _curve("16200x10800", "coded-info", [(1.8, 905, 1024),
                                             (2.0, 104, 4096)])))
    assert ber_check.main(["--book"]) == 0
    rows, unmatched = ber_check.compare_book()
    assert [(r["curve"], r["snr_db"], r["against"]) for r in rows] == [
        ("1944x972_OMS_10", 2.0, "JAX"), ("1944x972_OMS_10", 2.25, "JAX"),
        ("16200x10800_OMS_10_coded-info", 1.8, "16200x10800_OMS_10_zero-info"),
        ("16200x10800_OMS_10_coded-info", 2.0, "16200x10800_OMS_10_zero-info")]
    assert unmatched == ["1944x972_OMS_10 @ 3 dB",
                         "16200x10800_OMS_10_zero-info @ 2.8 dB"]
    assert all(r["p"] > ber_check.P_WATCH for r in rows)
    md = open(tmp_path / "BER.md").read()
    assert "## Against the JAX book" in md and "| 1944x972_OMS_10 | 2.25 |" in md
    # twice the FER at 2.25 dB (the JAX book holds 51 FE there)
    good["points"][1].update(fe=102, fer=102 / 221184)
    (data / "1944x972_OMS_10.json").write_text(json.dumps(good))
    assert ber_check.main(["--book"]) == 1
    assert "FAILS" in capsys.readouterr().out
    assert "**fails**" in open(tmp_path / "BER.md").read()


def test_backend_for(tmp_path, monkeypatch):
    """Native where the host decoder takes the code, the device for a
    staircase code's QC view; a failed build of the native library raises
    instead of sending the code to the device."""
    if not native.simd_available():
        pytest.skip("this host has no AVX-512BW: the SIMD decoder is not built")
    assert ber_tail._backend_for("155x93", "cpu") == "native"
    assert ber_tail._backend_for("16200x7560", "cpu") == "auto"
    cxx = tmp_path / "g++"
    cxx.write_text("#!/bin/sh\ncase \"$*\" in *--help=target*) echo -mavx;"
                   " exit 0;; esac\necho 'simd_decoder.cpp:1: broken' >&2\n"
                   "exit 1\n")
    cxx.chmod(0o755)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="broken"):
        ber_tail._backend_for("155x93", "cpu")


def test_mains_need_a_card_unless_told(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert ber_curves.main(["--only", "none"]) == 1
    assert ber_tail.main(["--only", "none"]) == 1
    assert ber_topup.main(["--curve", "1944x972_OMS_10", "--snr", "2"]) == 1
    assert ber_check.main([]) == 1
    assert air.main(["--quick"]) == 1
    assert "no CUDA device" in capsys.readouterr().err

"""The streamed kernel's (algorithm, minclamp) builds on the CPU, without
a card and without JAX: one library per pair, the defines each pair's
build gets, the C entry's dispatch to the pair it was built for, the
compile-time check-node forms in its round, and ``bench/sass.py`` reading
the builds the pick launches.
"""

import os
import re

import pytest

from ldpcgputegra_tpu_torch.codes.registry import load_code
from ldpcgputegra_tpu_torch.decoder import effective_code
from ldpcgputegra_tpu_torch.kernels import _lib
from ldpcgputegra_tpu_torch.kernels import streamed as S

PAIRS = [(a, m) for a in ("MS", "OMS", "NMS", "2NMS") for m in ("pre", "post")]


def _source(name):
    with open(os.path.join(_lib.CSRC, name)) as f:
        return f.read()


def _enum():
    """The ``Algo`` enum of ``minsum_common.cuh``: name -> value."""
    body = re.search(r"enum Algo \{(.*?)\}",
                     _source("minsum_common.cuh")).group(1)
    return {n: int(v) for n, v in re.findall(r"(\w+) = (\d+)", body)}


def test_pairs_are_the_eight():
    assert sorted(S.PAIRS) == sorted(PAIRS)
    assert sorted(_enum().values()) == sorted(_lib.ALGO.values())


@pytest.mark.parametrize("algo,minclamp", PAIRS)
def test_every_algo_and_minclamp_maps_to_a_build(algo, minclamp):
    """Each pair's library is compiled with that pair's ``Algo`` value (the
    enum that ``_lib.ALGO`` mirrors) and its minclamp placement."""
    name = {"2NMS": "NMS2"}.get(algo, algo)
    assert S.defines(algo, minclamp) == [
        f"-DSTREAMED_ALGO={_enum()[name]}",
        f"-DSTREAMED_PRE={int(minclamp == 'pre')}"]


def test_defines_refuse_an_unknown_pair():
    with pytest.raises(ValueError):
        S.defines("BP", "pre")
    with pytest.raises(ValueError):
        S.defines("OMS", "mid")


def test_the_c_entry_launches_its_own_pair_alone():
    """The source needs the pair's defines, its C entry dispatches once on
    ``algo * 2 + minclamp_pre`` to the build of that pair and refuses any
    other, and its round calls the compile-time forms alone."""
    src = _source("streamed_minsum.cu")
    assert re.search(r"#if !defined\(STREAMED_ALGO\) \|\| "
                     r"!defined\(STREAMED_PRE\)\n#error", src)
    entry = src[src.index('extern "C"'):]
    assert re.findall(r"case ([^:]+):", entry) == [
        "STREAMED_ALGO * 2 + STREAMED_PRE"]
    assert "switch (algo * 2 + minclamp_pre)" in entry
    assert re.findall(r"launch_variant<([^>]+)>", entry) == [
        "STREAMED_ALGO, STREAMED_PRE"]
    kernel = src[src.index("streamed_minsum_kernel(Params p)"):
                 src.index("cudaError_t launch(")]
    for form in ("cn_abs", "cn_f", "cn_msg"):
        assert f"{form}<ALGO, PRE>(" in kernel, form
        assert not re.search(rf"\b{form}\(", kernel), form
    assert "cn.algo" not in kernel and "cn.pre" not in kernel


def test_each_pair_builds_its_own_library(monkeypatch, tmp_path):
    """``build`` passes the pair's defines to nvcc and keys the library by
    them: eight pairs, eight files; the same pair twice, one."""
    cmds = {}

    def fake_run(cmd, capture_output, text):
        out = cmd[cmd.index("-o") + 1]
        with open(out, "wb"):
            pass
        cmds[out] = cmd
        return type("R", (), {"returncode": 0, "stdout": "", "stderr": ""})()

    monkeypatch.setattr(_lib, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_lib.subprocess, "run", fake_run)
    paths = {}
    for algo, minclamp in PAIRS:
        info = S.build(algo, minclamp, build_dir=str(tmp_path))
        cmd = next(c for o, c in cmds.items()
                   if os.path.basename(o).startswith(
                       os.path.basename(info["path"])))
        assert cmd[-1] == S.SOURCE
        for flag in S.defines(algo, minclamp):
            assert flag in cmd
        paths[(algo, minclamp)] = info["path"]
    assert len(set(paths.values())) == 8
    again = S.build("NMS", "post", build_dir=str(tmp_path))
    assert again["path"] == paths[("NMS", "post")] and again["seconds"] == 0
    assert len(cmds) == 8


def test_a_pair_is_built_and_loaded_at_its_first_use(monkeypatch):
    """``_library`` builds and loads a pair's library once, and another
    pair's beside it."""
    built = []

    class FakeLib:
        def __init__(self, path):
            self.path = path
            self.streamed_minsum_launch = lambda *a: 0
            self.streamed_minsum_error_string = lambda e: b""

    monkeypatch.setattr(S, "_lib_handles", {})
    monkeypatch.setattr(
        S, "build", lambda a, m: built.append((a, m)) or {"path": f"{a}-{m}"})
    monkeypatch.setattr(S.ctypes, "CDLL", FakeLib)
    lib = S._library("NMS", "post")
    assert S._library("NMS", "post") is lib and lib.path == "NMS-post"
    assert S._library("OMS", "pre").path == "OMS-pre"
    assert built == [("NMS", "post"), ("OMS", "pre")]


@pytest.mark.parametrize("name,B", [("64800x32400", 128), ("64800x32400", 512),
                                    ("64800x6480-dvbs2", 256),
                                    ("16200x7560", 1024),
                                    ("synthqc-256x128x6-z1024", 256)])
def test_sass_reads_the_streamed_builds_the_pick_launches(name, B):
    """``bench/sass.py`` counts the instructions of the OMS/pre builds that
    the pick launches on the DVB-S2 views and synthqc."""
    from ldpcgputegra_tpu_torch.bench import sass

    code = effective_code(load_code(name))
    sym, edges = sass.streamed_symbol(code, S.pick_tile(code, B))
    assert sym.endswith(f"ELi{_lib.ALGO['OMS']}ELb1EE")
    entry = [e for k, s, e, _ in sass.VARIANTS
             if k == "streamed_minsum" and s == sym]
    assert entry == [edges], (name, B, sym)

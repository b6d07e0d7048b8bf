"""The decode kernels' one build policy on the CPU, without a card and
without JAX: one library per (algorithm, minclamp) pair for each of K1
(``layered_minsum``), K2 (``streamed_minsum``) and the gather kernel
(``gather_minsum``), the defines each pair's build gets, each C entry's
dispatch to the pair it was built for and its argument list against the
wrapper's, the compile-time check-node forms in each round, the shared
call body (``kernels/_lib.py::make_decode``) driven on the meta device
with a stand-in library, and ``bench/sass.py`` reading the builds the
picks launch.
"""

import contextlib
import ctypes
import os
import re
import types

import pytest
import torch

from ldpcgputegra_tpu_torch.codes.registry import load_code
from ldpcgputegra_tpu_torch.decoder import effective_code
from ldpcgputegra_tpu_torch.kernels import _lib
from ldpcgputegra_tpu_torch.kernels import gather as G
from ldpcgputegra_tpu_torch.kernels import layered as K
from ldpcgputegra_tpu_torch.kernels import streamed as S
from ldpcgputegra_tpu_torch.ops.layered import LayeredSpec

PAIRS = [(a, m) for a in ("MS", "OMS", "NMS", "2NMS") for m in ("pre", "post")]
KERNELS = {"layered_minsum": K, "streamed_minsum": S, "gather_minsum": G}
MAKE = {"layered_minsum": K.make_cuda_decoder,
        "streamed_minsum": S.make_streamed_decoder,
        "gather_minsum": G.make_gather_decoder}
# the C entries' last parameters, the spec's and the stream
SPEC_PARAMS = ["algo", "minclamp_pre", "iters", "early_term", "offset",
               "nms_f", "nms_f2", "sat_var", "sat_msg", "stream"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _source(name):
    with open(os.path.join(_lib.CSRC, name)) as f:
        return f.read()


def _enum():
    """The ``Algo`` enum of ``minsum_common.cuh``: name -> value."""
    body = re.search(r"enum Algo \{(.*?)\}",
                     _source("minsum_common.cuh")).group(1)
    return {n: int(v) for n, v in re.findall(r"(\w+) = (\d+)", body)}


def _entry_params(name):
    """(C type, parameter name) of ``{name}_launch``, in order."""
    src = _source(f"{name}.cu")
    params = re.search(rf"int {name}_launch\((.*?)\)", src, re.S).group(1)
    return [re.match(r"(.*?)(\w+)$", p.strip()).groups()
            for p in params.split(",")]


def test_pairs_are_the_eight():
    assert sorted(_lib.PAIRS) == sorted(PAIRS)
    assert sorted(_enum().values()) == sorted(_lib.ALGO.values())


@pytest.mark.parametrize("algo,minclamp", PAIRS)
def test_every_algo_and_minclamp_maps_to_a_build(algo, minclamp):
    """Each pair's library is compiled with that pair's ``Algo`` value (the
    enum that ``_lib.ALGO`` mirrors) and its minclamp placement, and a spec
    of the pair decodes through it."""
    name = {"2NMS": "NMS2"}.get(algo, algo)
    assert _lib.defines(algo, minclamp) == [
        f"-DMINSUM_ALGO={_enum()[name]}",
        f"-DMINSUM_PRE={int(minclamp == 'pre')}"]
    assert _lib.pair(LayeredSpec(algo=algo, minclamp=minclamp)) == (
        algo, minclamp)


def test_defines_refuse_an_unknown_pair():
    with pytest.raises(ValueError):
        _lib.defines("BP", "pre")
    with pytest.raises(ValueError):
        _lib.defines("OMS", "mid")


def test_the_header_holds_the_compile_time_forms_alone():
    """``minsum_common.cuh`` needs the pair's defines, its ``CnSpec`` holds
    the spec's constants alone, and each check-node form takes the pair as
    template parameters; no source reads another pair's macros."""
    hdr = _source("minsum_common.cuh")
    assert re.search(r"#if !defined\(MINSUM_ALGO\) \|\| "
                     r"!defined\(MINSUM_PRE\)\n#error", hdr)
    fields = re.search(r"struct CnSpec \{\s*int ([^;]*);", hdr).group(1)
    assert fields.split(", ") == ["offset", "nms_f", "nms_f2", "sat_var",
                                  "sat_msg"]
    for form in ("cn_abs", "cn_f", "cn_msg"):
        defs = re.findall(rf"(.*)\n__device__ __forceinline__ \w+ {form}\(",
                          hdr)
        assert defs and all(d == "template <int ALGO, bool PRE>"
                            for d in defs), form
    assert "return algo == MINSUM_ALGO && minclamp_pre == MINSUM_PRE" in hdr
    for name in os.listdir(_lib.CSRC):
        macros = re.findall(r"(?<![\w-])(\w+)_(?:ALGO|PRE)\b", _source(name))
        assert set(macros) <= {"MINSUM"}, name


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_the_c_entry_launches_its_own_pair_alone(name):
    """The C entry refuses any pair but its library's and dispatches to
    that pair's build alone; the kernel is a template on the pair and its
    round calls the compile-time forms alone."""
    src = _source(f"{name}.cu")
    assert '#include "minsum_common.cuh"' in src
    entry = src[src.index('extern "C"'):]
    assert re.search(r"if \(!built_pair\(algo, minclamp_pre\) \|\|", entry)
    assert "switch (algo" not in entry
    assert re.findall(r"launch_variant<([^>]+)>", entry) == [
        "MINSUM_ALGO, MINSUM_PRE"]
    assert re.search(r"template <[^>]*int ALGO, bool PRE>\n__global__",
                     src)
    kernel = src[src.index(f"{name}_kernel(Params p)"):
                 src.index("cudaError_t launch(")]
    for form in ("cn_abs", "cn_f", "cn_msg"):
        assert f"{form}<ALGO, PRE>(" in kernel, form
        assert not re.search(rf"\b{form}\(", kernel), form
    assert "cn.algo" not in kernel and "cn.pre" not in kernel


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_the_argtypes_match_the_c_entry(name):
    """The wrapper's argument types, then ``_lib.SPEC_ARGTYPES``, are the C
    entry's parameters one for one, the spec's last."""
    params = _entry_params(name)
    argtypes = _lib.decode_functions(name, KERNELS[name].ARGTYPES)[
        f"{name}_launch"][0]
    assert [n for _, n in params[-len(SPEC_PARAMS):]] == SPEC_PARAMS
    ctype = {"int": ctypes.c_int, "long long": ctypes.c_longlong,
             "void*": ctypes.c_void_p, "const void*": ctypes.c_void_p}
    assert [ctype[t.strip()] for t, _ in params] == argtypes


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_each_pair_builds_its_own_library(name, monkeypatch, tmp_path):
    """``build`` passes the pair's defines to nvcc and keys the library by
    them: eight pairs, eight files; the same pair twice, one."""
    mod = KERNELS[name]
    cmds = {}

    def fake_run(cmd, capture_output, text):
        out = cmd[cmd.index("-o") + 1]
        with open(out, "wb"):
            pass
        cmds[out] = cmd
        return types.SimpleNamespace(returncode=0, stdout="", stderr="")

    monkeypatch.setattr(_lib, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_lib.subprocess, "run", fake_run)
    paths = {}
    for algo, minclamp in PAIRS:
        info = mod.build(algo, minclamp, build_dir=str(tmp_path))
        cmd = next(c for o, c in cmds.items()
                   if os.path.basename(o).startswith(
                       os.path.basename(info["path"])))
        assert cmd[-1] == mod.SOURCE
        assert cmd[-1] == os.path.join(_lib.CSRC, f"{name}.cu")
        for flag in _lib.defines(algo, minclamp):
            assert flag in cmd
        paths[(algo, minclamp)] = info["path"]
    assert len(set(paths.values())) == 8
    again = mod.build("NMS", "post", build_dir=str(tmp_path))
    assert again["path"] == paths[("NMS", "post")] and again["seconds"] == 0
    assert len(cmds) == 8


def _on_meta(monkeypatch, name, err=0):
    """Run the card path of the decode body on the meta device: the input
    check, the SM count, the stream and the library are stand-ins; returns
    the (source, defines) built and the libraries loaded."""
    built, loaded = [], []

    def fake_build(source, build_dir, defines=()):
        built.append((source, tuple(defines)))
        return {"path": f"{os.path.basename(source)} {' '.join(defines)}"}

    class Launch:
        def __init__(self, lib):
            self.lib = lib

        def __call__(self, *args):
            self.lib.calls.append(args)
            return self.lib.err

    class Lib:
        def __init__(self, path):
            self.path, self.calls, self.err = path, [], err
            setattr(self, f"{name}_launch", Launch(self))
            setattr(self, f"{name}_error_string", lambda e: b"stand-in")
            loaded.append(self)

    monkeypatch.setattr(_lib, "_loaded", {})
    monkeypatch.setattr(_lib, "build_library", fake_build)
    monkeypatch.setattr(_lib.ctypes, "CDLL", Lib)
    monkeypatch.setattr(_lib, "check_llr", lambda llr, N: None)
    monkeypatch.setattr(_lib, "sm_count", lambda dev: 132)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=4321))
    return built, loaded


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_a_pair_is_built_and_loaded_at_its_first_use(name, monkeypatch):
    """A decoder builds and loads its spec's pair at its first call on the
    card and not again; another pair's decoder loads its own library; each
    launch gets the wrapper's arguments, the spec's and the stream, and
    counts one in the module's ``launches``."""
    built, loaded = _on_meta(monkeypatch, name)
    code = load_code("576x288")
    mod = KERNELS[name]
    spec = LayeredSpec(algo="NMS", minclamp="post", iters=3)
    dec = MAKE[name](code, spec)
    assert built == [] and loaded == []
    llr = torch.empty((8, code.N), dtype=torch.int8, device="meta")
    before = mod.launches[name]
    bits, iters = dec(llr)
    dec(llr)
    assert bits.shape == (8, code.N) and bits.dtype == torch.uint8
    assert iters.shape == () and iters.dtype == torch.int32
    assert built == [(mod.SOURCE, tuple(_lib.defines("NMS", "post")))]
    assert len(loaded) == 1 and len(loaded[0].calls) == 2
    args = loaded[0].calls[0]
    assert len(args) == len(mod.ARGTYPES) + len(_lib.SPEC_ARGTYPES)
    assert args[-10:] == (_lib.ALGO["NMS"], 0, 3, 0, spec.offset, spec.nms_f,
                          spec.nms_f2, spec.sat_var, spec.sat_msg, 4321)
    assert mod.launches[name] == before + 2
    MAKE[name](code, LayeredSpec(algo="OMS", iters=3))(llr)
    assert built[1:] == [(mod.SOURCE, tuple(_lib.defines("OMS", "pre")))]
    assert len(loaded) == 2


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_a_failed_launch_raises_with_its_error_string(name, monkeypatch):
    """An error the C entry returns raises ``RuntimeError`` with the
    library's error string and code, and counts no launch."""
    _on_meta(monkeypatch, name, err=7)
    code = load_code("576x288")
    mod = KERNELS[name]
    dec = MAKE[name](code, LayeredSpec(iters=3))
    before = mod.launches[name]
    with pytest.raises(RuntimeError,
                       match=rf"^{name} launch failed: stand-in \(7\)$"):
        dec(torch.empty((8, code.N), dtype=torch.int8, device="meta"))
    assert mod.launches[name] == before


@pytest.mark.parametrize("kernel,name,B", [
    ("layered", "2304x1152", 8192), ("layered", "1944x972", 1024),
    ("streamed", "64800x32400", 128), ("streamed", "64800x32400", 512),
    ("streamed", "64800x6480-dvbs2", 256), ("streamed", "16200x7560", 1024),
    ("streamed", "synthqc-256x128x6-z1024", 256),
    ("gather", "4000x2000", 4096), ("gather", "4000x2000", 1024),
    ("gather", "1200x600", 8192), ("gather", "2048x384", 8192)])
def test_sass_reads_the_builds_the_pick_launches(kernel, name, B):
    """``bench/sass.py`` counts the instructions of the OMS/pre builds that
    each kernel's pick launches on the main paths."""
    from ldpcgputegra_tpu_torch.bench import sass

    mod = {"layered": K, "streamed": S, "gather": G}[kernel]
    code = effective_code(load_code(name))
    sym, edges = getattr(sass, f"{kernel}_symbol")(code,
                                                   mod.pick_tile(code, B))
    assert sym.endswith(f"ELi{_lib.ALGO['OMS']}ELb1EE")
    assert sym != getattr(sass, f"{kernel}_symbol")(
        code, mod.pick_tile(code, B), "OMS", "post")[0]
    entry = [e for k, s, e, _ in sass.VARIANTS
             if k == f"{kernel}_minsum" and s == sym]
    assert entry == [edges], (name, B, sym)

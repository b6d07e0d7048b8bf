"""The benchmark-suite path of the port on the CPU, against the JAX
package: the plain versions of the probe kernels (K6 ``_mix_kernel`` and
``_peak_kernel``, K7 ``_copy_fn``'s body, K8 ``roll_microkernel``'s body)
against the Pallas kernels in interpret mode, exact in int32; the suite's
tables and routing; the roofline against JAX's; the bound that
``chip_smoke.py`` prints; the demonstrated-ceiling pass; and the entry
points refusing to run without a card.  Nothing here decides anything
about a card at import time.
"""

import functools
import importlib.util
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from ldpcgputegra_tpu.bench import roofline as j_roofline
from ldpcgputegra_tpu.bench import suite as j_suite
from ldpcgputegra_tpu.bench.vpu_probe import _mix_kernel, _peak_kernel
from ldpcgputegra_tpu.codes.registry import load_code as j_load_code
from ldpcgputegra_tpu.decoder import effective_code as j_effective_code
from ldpcgputegra_tpu.ops.layered import LayeredSpec as JSpec
from ldpcgputegra_tpu_torch.bench import profile_1944 as P
from ldpcgputegra_tpu_torch.bench import roofline as R
from ldpcgputegra_tpu_torch.bench import suite
from ldpcgputegra_tpu_torch.bench import vpu_probe as V
from ldpcgputegra_tpu_torch.codes.registry import load_code
from ldpcgputegra_tpu_torch.decoder import backend_for
from ldpcgputegra_tpu_torch.ops.layered import LayeredSpec

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ints(shape, seed, low=-31, high=32):
    return np.random.default_rng(seed).integers(low, high, shape,
                                                dtype=np.int32)


# ------------------------------------------------------------------ K6 --

@pytest.mark.parametrize("reps", [1, 5])
@pytest.mark.parametrize("lanes", [1, 2, 4])
@pytest.mark.parametrize("kind", ["mix", "peak"])
def test_alu_probe_plain_matches_pallas(kind, lanes, reps):
    x = _ints((8, 128), seed=10 * lanes + reps)
    kernel = _mix_kernel if kind == "mix" else _peak_kernel
    want = pl.pallas_call(
        functools.partial(kernel, reps, lanes),
        out_shape=jax.ShapeDtypeStruct((8, 128), jnp.int32), interpret=True,
    )(x)
    xt = torch.from_numpy(x.ravel())
    if kind == "mix":
        got, wrapped = V.mix_plain(xt, lanes, reps), V.probe_mix(xt, lanes, reps)
    else:
        got, wrapped = V.peak_plain(xt, lanes, reps), V.probe_peak(xt, lanes,
                                                                  reps)
    np.testing.assert_array_equal(got.numpy().reshape(8, 128), np.asarray(want))
    assert torch.equal(wrapped, got)  # a CPU tensor runs the plain version


def _sat(v):
    return max(-128, min(127, v))


def _mix4_scalar(word, chains, reps):
    """The packed mix on one int32 word, byte by byte in Python integers,
    from the ``__v*4`` intrinsics' documented semantics."""
    lanes = [b - 256 if b > 127 else b
             for b in int(np.int64(word) & 0xFFFFFFFF).to_bytes(4, "little")]
    total = 0
    for ln in range(chains):
        out = []
        for b in lanes:
            v, m, p, mn = _sat(b + ln), 3 + ln, 0, 127
            for _ in range(reps):
                c = max(-127, min(127, _sat(v - m)))
                a = min(abs(c), 127)
                p ^= -1 if c > 0 else 0
                mn2 = min(max(a, mn), 31)
                mn3 = min(mn2, a)
                mag = mn2 if a == mn3 else mn3
                v = max(-127, min(127, _sat(c + mag)))
                mn = mn3
            out.append((v, p, mn))
        for k in range(3):
            total += int.from_bytes(bytes(t[k] & 0xFF for t in out), "little")
    total %= 2**32
    return total - 2**32 if total >= 2**31 else total


@pytest.mark.parametrize("chains,reps", [(1, 1), (2, 6), (4, 3)])
def test_int8x4_plain_matches_a_scalar_reference(chains, reps):
    x = _ints(24, seed=chains, low=-2**31, high=2**31 - 1)
    got = V.mix_plain(torch.from_numpy(x), chains, reps, packed=True)
    want = [_mix4_scalar(w, chains, reps) for w in x]
    assert got.tolist() == want


def test_probe_wrappers_check_their_inputs():
    x = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(TypeError):
        V.probe_mix(x.to(torch.int16), 1, 1)
    with pytest.raises(ValueError):
        V.probe_mix(x, 3, 1)  # no such template instantiation
    with pytest.raises(ValueError):
        V.probe_peak(x.view(2, 4), 8, 1)
    with pytest.raises(ValueError):
        V.probe_peak(x, 64, 1)
    with pytest.raises(ValueError):
        P.probe_roll(torch.zeros((1, 24, 8), dtype=torch.int32))  # width 256
    with pytest.raises(ValueError):
        P.probe_roll(torch.zeros((1, 24, 256), dtype=torch.int32), form="x")
    with pytest.raises(ValueError):
        P.probe_roll(torch.zeros((1, 24, 256), dtype=torch.int32), 0)
    with pytest.raises(ValueError):
        V.probe_mix(x, 1, -1)


# ------------------------------------------------------------------ K7 --

def test_copy_probe_plain_matches_pallas():
    def kernel(x_ref, o_ref):  # the body of vpu_probe.py::_copy_fn
        o_ref[...] = x_ref[...] + 1

    x = _ints(4096, seed=3, low=-100, high=100)
    want = pl.pallas_call(
        kernel, grid=(4,),
        in_specs=[pl.BlockSpec((1024,), lambda i: (i,))],
        out_specs=pl.BlockSpec((1024,), lambda i: (i,)),
        out_shape=jax.ShapeDtypeStruct((4096,), jnp.int32), interpret=True,
    )(x)
    xt = torch.from_numpy(x)
    np.testing.assert_array_equal(V.copy_plain(xt).numpy(), np.asarray(want))
    assert torch.equal(V.probe_copy(xt), V.copy_plain(xt))


# ------------------------------------------------------------------ K8 --

def _jax_roll_chain(x, Z, n_rolls, impl):
    """The body of tools/profile_1944.py::roll_microkernel (its :62-73),
    rebuilt here: the function itself times a call on a device and returns
    a time, so it cannot be called on the CPU."""
    shifts = [(7 * k) % Z or 1 for k in range(1, n_rolls + 1)]

    def rot(v, s):
        if impl == "roll":
            return pltpu.roll(v, s, axis=0)
        return jnp.concatenate([v[Z - s:], v[: Z - s]], axis=0)

    def kernel(x_ref, o_ref):
        v = x_ref[...]
        for s in shifts:
            v = rot(v, s) + 1
        o_ref[...] = v

    return np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct(x.shape, jnp.int32),
        interpret=True)(x))


@pytest.mark.parametrize("impl", ["roll", "slice"])
@pytest.mark.parametrize("Z", [24, 81])
def test_roll_probe_plain_matches_pallas(Z, impl):
    n_rolls, TB = 16, 8
    x = _ints((Z, TB), seed=Z)
    want = _jax_roll_chain(x, Z, n_rolls, impl)
    got = P.roll_plain(torch.from_numpy(x)[None], n_rolls)[0]
    np.testing.assert_array_equal(got.numpy(), want)
    assert P.roll_shifts(Z, n_rolls) == [(7 * k) % Z or 1
                                         for k in range(1, n_rolls + 1)]


def test_roll_wrapper_runs_plain_on_cpu_and_bound():
    x = torch.from_numpy(_ints((2, 88, P.TB), seed=5))
    for form in P.FORMS:
        assert torch.equal(P.probe_roll(x, 9, form), P.roll_plain(x, 9))
    # two [96, 256] int32 slabs a rotation at 128 B a clock, 1980 MHz
    assert P.roll_bound_ns(96, 1.98e9) == pytest.approx(1536 / 1.98, rel=1e-12)
    assert P.roll_smem_bytes(96, P.N_ROLLS) == 196608 + 4 * P.N_ROLLS


def _jax_profile_module():
    spec = importlib.util.spec_from_file_location(
        "jax_profile_1944", os.path.join(ROOT, "tools", "profile_1944.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("Z2", [88, 96])
def test_z_twin_matches_jax(Z2):
    want = _jax_profile_module().z_twin(Z2)
    got = P.z_twin(Z2)
    assert (got.name, got.N, got.K, got.M, got.Z) == (
        want.name, want.N, want.K, want.M, want.Z)
    assert len(got.layers) == len(want.layers)
    for a, b in zip(got.layers, want.layers):
        np.testing.assert_array_equal(a.idx, np.asarray(b.idx))


def test_profile_maps_the_jax_backends():
    assert P.BACKENDS == {"pallas": "cuda", "pallas-gather": "cuda-gather",
                          "xla": "torch"}
    spec = LayeredSpec(iters=10)
    assert backend_for(P.z_twin(88), spec, torch.device("cuda")) == "cuda"


# --------------------------------------------------------------- suite --

def test_suite_tables_equal_jax():
    assert suite.CONFIGS == j_suite.CONFIGS
    assert suite.LAT_CONFIGS == j_suite.LAT_CONFIGS
    assert sum(len(e[3]) if len(e) > 3 else 2 for e in suite.CONFIGS) == 40


def test_every_suite_code_routes_to_a_kernel():
    spec = LayeredSpec(algo="OMS", iters=10, early_term=False)
    routes = {e[0]: backend_for(load_code(e[0]), spec, torch.device("cuda"))
              for e in suite.CONFIGS}
    counts = {b: sum(r == b for r in routes.values())
              for b in suite.KERNEL_BACKENDS}
    assert set(routes.values()) <= set(suite.KERNEL_BACKENDS), routes
    # the 9 QC codes, the 11 non-QC codes, the 7 staircase views and synthqc
    assert counts == {"cuda": 9, "cuda-gather": 11, "cuda-streamed": 8}
    for name in suite.LAT_CONFIGS:
        assert routes[name] in suite.KERNEL_BACKENDS


# ------------------------------------------------------------ roofline --

@pytest.mark.parametrize("rates", [(12e12, 3.0e12), (1e15, 1e9)],
                         ids=["ops-bound", "bytes-bound"])
@pytest.mark.parametrize("name,batch", [("576x288", 16384), ("4000x2000", 4096)])
def test_roofline_matches_jax(name, batch, rates):
    r, h = rates
    seconds = 1.234e-3
    want = j_roofline.roofline_report(
        j_load_code(name), JSpec(algo="OMS", iters=10, early_term=False),
        batch, seconds, vpu_rate=r, hbm_rate=h, ops_override=21)
    got = R.roofline_report(load_code(name), LayeredSpec(iters=10), batch,
                            seconds, alu_rate=r, hbm_rate=h)
    assert got["bound"] == {"vpu": "operations", "hbm": "bytes"}[want["bound"]]
    assert got["ceiling"] == want["ceiling"] == "probed"
    assert got["ops_per_edge"] == want["ops_per_edge"] == 21
    for k, jk in (("t_roofline_ms", "t_roofline_ms"),
                  ("t_measured_ms", "t_measured_ms"),
                  ("roofline_frac", "roofline_frac"),
                  ("alu_util", "vpu_util"), ("hbm_util", "hbm_util")):
        assert got[k] == pytest.approx(want[jk], rel=1e-9), k


def test_roofline_counts_the_real_edges_of_the_dvbs2_view():
    """JAX bounds the 64800x32400 view by ``code.M`` = 226,800 edges; the
    port counts 226,799 edge updates an iteration, since the deficient
    circulant's pinned edge is no work."""
    j_code = j_effective_code(j_load_code("64800x32400"))
    assert j_code.M == 226800
    code = load_code("64800x32400")
    assert R.edge_updates(code) == 226799
    batch, iters, r, h = 512, 10, 12e12, 3e12
    spec = LayeredSpec(iters=iters)
    got = R.kernel_model(code, spec, batch)
    want = j_roofline.kernel_model(
        j_code, JSpec(algo="OMS", iters=iters, early_term=False), batch)
    assert got["bytes"] == want["hbm_bytes"]
    assert got["ops"] == 21 * iters * batch * (j_code.M - 1)
    rep = R.roofline_report(code, spec, batch, 1e-3, alu_rate=r, hbm_rate=h)
    j_rep = j_roofline.roofline_report(
        j_code, JSpec(algo="OMS", iters=iters, early_term=False), batch, 1e-3,
        vpu_rate=r, hbm_rate=h, ops_override=21)
    diff = (j_rep["t_roofline_ms"] - rep["t_roofline_ms"]) * 1e-3 * r
    assert diff == pytest.approx(21 * iters * batch, rel=1e-6)


@pytest.mark.parametrize("name,batch,ms", [("2304x1152", 8192, 0.7504),
                                           ("4000x2000", 4096, 0.6171),
                                           ("64800x32400", 512, 1.4578)])
def test_table_bound_reproduces_the_kernel_table(name, batch, ms):
    hw = R.table_spec(132, 1.98e9)
    rep = R.roofline_report(load_code(name), LayeredSpec(iters=10), batch,
                            1e-3, hw=hw)
    assert rep["t_roofline_ms"] == pytest.approx(ms, abs=1e-4)
    assert (rep["bound"], rep["ceiling"]) == ("operations", "table")
    assert hw.alu_rate == 132 * 64 * 1.98e9
    assert hw.hbm_bw == R.TABLE_HBM_BYTES_PER_S == 3.35e12


@pytest.mark.parametrize("ops,nbytes,smem,want", [
    (2e9, 1e6, 0.0, (2e-3, "operations")),
    (1e6, 3e9, 0.0, (1e-3, "bytes")),
    (1e6, 1e6, 5e-3, (5e-3, "shared memory")),
    (3e9, 9e9, 0.0, (3e-3, "operations")),  # a tie goes to operations
])
def test_one_bound_for_every_kernel(ops, nbytes, smem, want):
    t, by = R.bound(ops, nbytes, 1e12, 3e12, smem)
    assert (t, by) == (pytest.approx(want[0], rel=1e-12), want[1])


def test_roofline_labels_the_rate_that_sets_the_bound():
    hw = R.table_spec(132, 1.98e9)
    code, spec = load_code("576x288"), LayeredSpec(iters=10)
    # a probed int32 rate but the data sheet's memory rate: an
    # operations-bound decode is "probed", a bytes-bound one "table"
    assert R.roofline_report(code, spec, 1024, 1e-3, alu_rate=1e13,
                             hw=hw)["ceiling"] == "probed"
    rep = R.roofline_report(code, spec, 1024, 1e-3, alu_rate=1e18, hw=hw)
    assert (rep["bound"], rep["ceiling"]) == ("bytes", "table")


def test_hw_spec_and_probes_need_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        R.hw_spec()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        V.measure_alu_rate()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        V.measure_hbm_bw()


# ---------------------------------------------------- demonstrated pass --

def _row(code, iters, sec, ops, nbytes, **kw):
    return {"code": code, "iters": iters, "backend": "cuda", "batch": 8,
            "roofline_frac": 0.0, "bound": "operations", "ceiling": "probed",
            "_sec": sec, "_ops": ops, "_bytes": nbytes, **kw}


def test_demonstrated_ceiling_keeps_the_probe_when_no_row_beats_it():
    rows = [_row("a", 10, 1e-3, 5e9, 1e6), _row("b", 5, 2e-3, 4e9, 1e6)]
    out, ceiling, best = suite.demonstrated_ceiling(rows, {"alu": 1e13,
                                                           "hbm": 3e12})
    assert (ceiling, best) == (1e13, "probe")
    assert out[0]["roofline_frac"] == pytest.approx(0.5)
    assert out[0]["ceiling"] == "measured(max of probe, demonstrated by probe)"
    assert all(not k.startswith("_") for r in out for k in r)
    assert "_sec" in rows[0] and rows[0]["roofline_frac"] == 0.0  # pure


def test_demonstrated_ceiling_takes_the_best_row_and_flags_suspects():
    rows = [_row("a", 10, 1e-3, 2e10, 1e6),  # 2e13 ops/s beats the probe
            _row("b", 5, 1e-3, 1e10, 1e6),
            _row("c", 10, 1e-3, 1e3, 6e9)]  # bytes-bound beyond the probe
    out, ceiling, best = suite.demonstrated_ceiling(rows, {"alu": 1e13,
                                                           "hbm": 3e12})
    assert (ceiling, best) == (2e13, "a@10it")
    assert out[0]["roofline_frac"] == pytest.approx(1.0)
    assert out[1]["roofline_frac"] == pytest.approx(0.5)
    assert out[0]["ceiling"] == "measured(max of probe, demonstrated by a@10it)"
    assert "roofline_suspect" not in out[0] and "roofline_suspect" not in out[1]
    assert out[2]["bound"] == "bytes" and out[2]["ceiling"] == "probed"
    assert out[2]["roofline_frac"] == pytest.approx(2.0)
    assert out[2]["roofline_suspect"] is True


# --------------------------------------------------------- entry points --

@pytest.mark.parametrize("entry", ["suite", "profile_1944"])
def test_entry_points_refuse_without_a_card(entry, tmp_path, monkeypatch,
                                            capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "out" / "RESULTS.md"
    mod = suite if entry == "suite" else P
    assert mod.main(["--out", str(out)]) != 0
    assert not (tmp_path / "out").exists()
    assert "no CUDA device" in capsys.readouterr().err


# ----------------------------------------------------------------- SASS --

_SASS = """
\t\tFunction : _ZN41_GLOBAL__N__probes_cu17probe_peak_kernelILi2EEEvPKiPiii
        /*0100*/                   VIADD R7, R0, 0x1 ;
        /*0110*/                   NOP ;
        /*0130*/                   VIADDMNMX R0, R0, R2, 0xffffff81, !PT ;
        /*0140*/                   UIADD3 UR5, UR4, 0x8, URZ ;
        /*0150*/                   VIMNMX R0, R0, 0x7f, PT ;
        /*0160*/                   IMAD.MOV.U32 R2, RZ, RZ, 0x3 ;
        /*0170*/                   VIADDMNMX R7, R7, R2, 0xffffff81, !PT ;
        /*0180*/                   VIMNMX R7, R7, 0x7f, PT ;
        /*0190*/              @!P0 BRA 0x130 ;
        /*01a0*/              @P1 BRA 0x1c0 ;
        /*01b0*/                   EXIT ;
\t\tFunction : _ZN41_GLOBAL__N__probes_cu17probe_peak_kernelILi1EEEvPKiPiii
        /*0000*/                   IADD3 R0, R0, 0x3, RZ ;
        /*0010*/              @!P0 BRA 0x0 ;
"""


def test_sass_loop_count():
    loop = V.parse_sass_loop(_SASS, "probe_peak_kernelILi2E")
    assert loop == ["VIADDMNMX", "UIADD3", "VIMNMX", "IMAD.MOV.U32",
                    "VIADDMNMX", "VIMNMX", "BRA"]
    assert [op for op in loop if V.alu_pipe(op)] == [
        "VIADDMNMX", "VIMNMX", "VIADDMNMX", "VIMNMX"]
    assert V.parse_sass_loop(_SASS, "probe_peak_kernelILi1E") == ["IADD3",
                                                                   "BRA"]
    assert V.parse_sass_loop(_SASS, "probe_mix_kernelILi2E") is None
    assert V.alu_pipe("VIADDMNMX") and V.alu_pipe("LOP3.LUT")
    assert not V.alu_pipe("VIADD") and not V.alu_pipe("IMAD.IADD")


_SASS_CHAINS = """
\t\tFunction : _Z17probe_peak_kernelILi4EEvPKiPiii
        /*0000*/                   VIADDMNMX R0, R0, 0x3, R2, !PT ;
        /*0010*/                   VIMNMX R0, R0, 0x7f, PT ;
        /*0020*/                   VIADDMNMX R1, R1, 0x3, R2, !PT ;
        /*0030*/                   VIMNMX R1, R1, 0x7f, PT ;
        /*0040*/                   VIADDMNMX R3, R3, 0x3, R2, !PT ;
        /*0050*/                   VIMNMX R3, R3, 0x7f, PT ;
        /*0060*/                   VIADDMNMX R4, R4, 0x3, R2, !PT ;
        /*0070*/                   VIMNMX R4, R4, 0x7f, PT ;
        /*0080*/                   ISETP.LT.AND P0, PT, R5, UR4, PT ;
        /*0090*/                   UIADD3 UR5, UR5, 0x4, URZ ;
        /*00a0*/              @!P0 BRA 0x0 ;
\t\tFunction : _Z17probe_peak_kernelILi2EEvPKiPiii
        /*0000*/                   VIADDMNMX R0, R0, 0x3, R2, !PT ;
        /*0010*/                   VIMNMX R0, R0, 0x7f, PT ;
        /*0020*/                   VIADDMNMX R1, R1, 0x3, R2, !PT ;
        /*0030*/                   VIMNMX R1, R1, 0x7f, PT ;
        /*0040*/                   ISETP.LT.AND P0, PT, R5, UR4, PT ;
        /*0050*/                   UIADD3 UR5, UR5, 0x4, URZ ;
        /*0060*/              @!P0 BRA 0x0 ;
"""


def test_sass_per_chain_rep_leaves_out_the_loop_control(monkeypatch):
    # one loop body here stands for UNROLL repetitions
    monkeypatch.setattr(V, "_sass_text", _SASS_CHAINS)
    assert V.sass_per_rep("peak", 4) == (11 / V.UNROLL, 9 / V.UNROLL)
    assert V.sass_per_rep("peak", 2) == (7 / V.UNROLL, 5 / V.UNROLL)
    # (9 - 5) ALU instructions for 2 more chains: the ISETP is the loop's
    assert V.sass_per_chain_rep("peak", 4) == 2 / V.UNROLL
    with pytest.raises(ValueError):
        V.sass_per_chain_rep("peak", 1)
    with pytest.raises(RuntimeError, match="no loop"):
        V.sass_per_rep("mix", 4)


@pytest.mark.parametrize("ratio,folded", [(1.0, False), (1.05, False),
                                          (1.06, True), (1.5, True)])
def test_issue_rate_check_in_instruction_units(ratio, folded):
    issue = R.table_spec(132, 1.98e9).alu_rate
    if folded:
        with pytest.raises(RuntimeError, match="dropped work"):
            V.check_issue_rate(ratio * issue, issue, "peak x16")
    else:
        V.check_issue_rate(ratio * issue, issue, "peak x16")


def test_sweep_reps_carry_the_operations_of_a_call():
    per_call = V.OPS_PER_REP * V.BLOCK * 132 * 4 * 8
    r_small, r_large = V.sweep_reps(per_call)
    assert r_large == int(V.OPS_PER_CALL / per_call) == 3302
    assert r_small == r_large // 8
    assert math.isclose(V.HBM_SANITY, 1.05 * 3.35e12)

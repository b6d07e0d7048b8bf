"""The port's multi-device path (``parallel/``) on gloo ranks on the CPU,
against the JAX package's: the batch-sharded step (2 and 4 ranks) against
JAX ``make_sharded_decoder`` on the 8-device CPU mesh, the row-sharded
decode (2 and 4 ranks) and ``dp x tp`` 2x2 against JAX's one-device
``make_layered_decoder``: bits, ``iters_used``, BE and FE, ET on and off.

Each world size is started once a module (``parallel/launch.py``: spawned
processes, a ``file://`` store, one intra-op thread a rank) and runs every
case; the tests read its results.  The 16200x7560 view is in
``tests/test_torch_parallel_dvbs2.py``.
"""

import functools

import numpy as np
import pytest
import torch

from ldpcgputegra_tpu.codes.registry import load_code as j_load_code
from ldpcgputegra_tpu.ops.layered import LayeredSpec as JSpec
from ldpcgputegra_tpu.ops.layered import make_layered_decoder as j_layered
from ldpcgputegra_tpu.parallel import decode_mesh as j_decode_mesh
from ldpcgputegra_tpu.parallel import make_sharded_decoder as j_sharded
from ldpcgputegra_tpu_torch.codes.registry import load_code
from ldpcgputegra_tpu_torch.ops.layered import LayeredSpec
from ldpcgputegra_tpu_torch.parallel import (
    decode_mesh,
    decode_mesh_2d,
    initialize_distributed,
    local_batch_size,
    make_rowsharded_decoder,
)
from ldpcgputegra_tpu_torch.parallel.dryrun import decode_cases, dryrun_multichip
from ldpcgputegra_tpu_torch.parallel.launch import run_ranks
from ldpcgputegra_tpu_torch.parallel.rowshard import rowshard_supported


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _llrs(n, b, seed):
    rng = np.random.default_rng(seed)
    return np.clip(8.0 * rng.normal(-1.0, 0.8, size=(b, n)), -31, 31
                   ).astype(np.int8)


DP_KW = dict(algo="OMS", iters=5)
DP_LLR = _llrs(576, 16, seed=3)
ET_KW = dict(algo="OMS", iters=10, early_term=True)
STRONG = np.full((8, 576), -31, np.int8)
ROW = [(name, et) for name in ("576x288", "2304x1152") for et in (False,
                                                                   True)]


def _row_kw(et):
    return dict(algo="OMS", iters=6, early_term=True) if et else \
        dict(algo="OMS", iters=4)


@functools.lru_cache(maxsize=None)
def _row_llr(name):
    return _llrs(load_code(name).N, 3, seed=5)


def _cases(world):
    cases = [
        {"kind": "sharded", "code": "576x288", "spec": LayeredSpec(**DP_KW),
         "llr": DP_LLR},
        {"kind": "sharded", "code": "576x288", "spec": LayeredSpec(**ET_KW),
         "llr": STRONG},
        {"kind": "rowshard", "code": "576x288", "spec": LayeredSpec(**ET_KW),
         "llr": STRONG[:2]},
    ]
    cases += [{"kind": "rowshard", "code": name,
               "spec": LayeredSpec(**_row_kw(et)), "llr": _row_llr(name)}
              for name, et in ROW]
    if world == 4:
        llr4 = _llrs(576, 4, seed=13)
        cases += [{"kind": "dp_tp", "code": "576x288",
                   "spec": LayeredSpec(**_row_kw(et)), "llr": llr4,
                   "dp": 2, "tp": 2} for et in (False, True)]
        cases.append({"kind": "dp_tp", "code": "576x288",
                      "spec": LayeredSpec(**_row_kw(True)), "llr": llr4,
                      "dp": 2, "tp": 2, "ref_bits": _j_layered(
                          "576x288", True, llr4)[0]})
    return cases


@functools.lru_cache(maxsize=None)
def _ranks(world):
    return run_ranks(decode_cases, world, (_cases(world), "cpu"))


def _j_layered(name, et, llr):
    bits, it = j_layered(j_load_code(name), JSpec(**_row_kw(et)))(llr)
    return np.asarray(bits), int(it)


@functools.lru_cache(maxsize=None)
def _j_row(name, et):
    return _j_layered(name, et, _row_llr(name))


@functools.lru_cache(maxsize=None)
def _j_dp(strong):
    spec = JSpec(**(ET_KW if strong else DP_KW))
    bits, it, be, fe = j_sharded(j_load_code("576x288"), spec,
                                 j_decode_mesh())(STRONG if strong else DP_LLR)
    return np.asarray(bits), int(it), int(be), int(fe)


@pytest.mark.parametrize("world", [2, 4])
def test_dp_matches_jax_sharded(world):
    """Each rank's rows and the summed counters equal JAX's sharded step on
    the 8-device mesh (576x288 OMS 5, B=16)."""
    res = [r[0] for r in _ranks(world)]
    jbits, jit, jbe, jfe = _j_dp(False)
    np.testing.assert_array_equal(np.concatenate([r["bits"] for r in res]),
                                  jbits)
    for r in res:
        assert (r["iters"], r["be"], r["fe"]) == (jit, jbe, jfe)
    assert jfe > 0


@pytest.mark.parametrize("world", [2, 4])
def test_dp_early_term_vote(world):
    """Noiseless input stops at iteration 1 on every rank, as in JAX."""
    res = [r[1] for r in _ranks(world)]
    jbits, jit, jbe, jfe = _j_dp(True)
    assert jit == 1 and jbe == jfe == 0
    for r in res:
        assert (r["iters"], r["be"], r["fe"]) == (1, 0, 0)
        assert r["bits"].sum() == 0


@pytest.mark.parametrize("world", [2, 4])
def test_rowshard_noiseless_one_iteration(world):
    for r in _ranks(world):
        assert r[2]["iters"] == 1 and r[2]["bits"].sum() == 0


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name,et", ROW)
def test_rowshard_matches_jax(name, et, world):
    """Every rank's bits and iters_used equal JAX's one-device layered
    decode of the same three codewords."""
    jbits, jit = _j_row(name, et)
    for r in _ranks(world):
        got = r[3 + ROW.index((name, et))]
        np.testing.assert_array_equal(got["bits"], jbits)
        assert got["iters"] == jit
        assert got["be"] is None
    assert et or jit == 4


@pytest.mark.parametrize("et", [False, True])
def test_dp_tp_matches_jax(et):
    """2x2: each rank's dp rows equal JAX's one-device decode; iters_used
    is the maximum over dp, BE/FE the sums over dp only."""
    llr4 = _cases(4)[7 + et]["llr"]
    jbits, jit = _j_layered("576x288", et, llr4)
    err = jbits.astype(np.int64)
    for rank, r in enumerate(_ranks(4)):
        got = r[7 + et]
        i = rank // 2
        np.testing.assert_array_equal(got["bits"], jbits[2 * i:2 * i + 2])
        assert got["iters"] == jit
        assert (got["be"], got["fe"]) == (int(err.sum()),
                                          int(err.any(1).sum()))
    assert err.any(1).sum() > 0


def test_dp_tp_counts_against_ref_bits():
    """Counted against the decoder's own output, nothing is in error."""
    for r in _ranks(4):
        assert (r[9]["be"], r[9]["fe"]) == (0, 0)


def test_rowshard_supported():
    assert rowshard_supported(load_code("576x288"), 4)
    assert rowshard_supported(load_code("16200x7560"), 8)  # the Z=360 view
    assert not rowshard_supported(load_code("576x288"), 5)
    assert not rowshard_supported(load_code("200x100"), 2)  # not QC


def test_one_rank_world_needs_no_group():
    """At world size 1 nothing is initialised, the 1-D mesh holds no group
    and the row-sharded decode is the plain one."""
    initialize_distributed("gloo")
    assert not torch.distributed.is_initialized()
    mesh = decode_mesh()
    assert (mesh.dp_rank, mesh.dp_size, mesh.dp_group) == (0, 1, None)
    assert local_batch_size(16, mesh) == 16
    dec = make_rowsharded_decoder(load_code("576x288"),
                                  LayeredSpec(**_row_kw(True)), mesh,
                                  device="cpu")
    bits, it = dec(torch.from_numpy(_row_llr("576x288")))
    jbits, jit = _j_row("576x288", True)
    np.testing.assert_array_equal(bits.numpy(), jbits)
    assert int(it) == jit


def test_mesh_checks():
    with pytest.raises(ValueError, match="nccl"):
        initialize_distributed("mpi")
    with pytest.raises(AssertionError, match="ranks"):
        decode_mesh_2d(2, 2)  # 4 ranks > the world of 1
    with pytest.raises(ValueError, match="start 2 ranks"):
        decode_mesh(n_devices=2)
    with pytest.raises(AssertionError, match="1-D mesh"):
        make_rowsharded_decoder(load_code("576x288"), LayeredSpec(),
                                decode_mesh_2d(1, 1), device="cpu")
    mesh = decode_mesh_2d(1, 1)
    with pytest.raises(ValueError, match="divisible"):
        local_batch_size(3, type(mesh)(dp_rank=0, dp_size=2))


def test_dryrun_multichip():
    """The counterpart of ``__graft_entry__.dryrun_multichip`` on 4 gloo
    ranks: sharded step, 4-way row sharding and 2x2, each bit-exact."""
    out = dryrun_multichip(4, device="cpu")
    assert out.startswith("dryrun_multichip ok: 4 ranks on cpu")
    assert "bit-exact over 4-way" in out and "2x2 mesh" in out


def test_failing_rank_raises():
    with pytest.raises(RuntimeError, match="unknown case kind"):
        run_ranks(decode_cases, 2, ([{"kind": "bogus", "code": "576x288",
                                      "spec": LayeredSpec(),
                                      "llr": STRONG}], "cpu"))

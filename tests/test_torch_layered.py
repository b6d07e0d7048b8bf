"""The plain PyTorch layered decoder against the JAX package's XLA decoder,
the committed vectors and the golden oracle: bit-exact in bits and
``iters_used``.  Inputs come from a numpy seed and go to both as the same
int8 arrays.
"""

import dataclasses
import glob
import os

import numpy as np
import pytest
import torch

from ldpcgputegra_tpu.codes.registry import load_code as j_load_code
from ldpcgputegra_tpu.golden.decoder import GoldenParams, decode_golden
from ldpcgputegra_tpu.ops.layered import LayeredSpec as JSpec
from ldpcgputegra_tpu.ops.layered import make_layered_decoder as j_decoder
from ldpcgputegra_tpu_torch.codes.dvbs2 import to_qc_form
from ldpcgputegra_tpu_torch.codes.registry import load_code
from ldpcgputegra_tpu_torch.decoder import effective_code, make_decoder
from ldpcgputegra_tpu_torch.kernels import gather as G
from ldpcgputegra_tpu_torch.kernels import layered as K
from ldpcgputegra_tpu_torch.kernels import streamed as S
from ldpcgputegra_tpu_torch.kernels.layered import make_cuda_decoder
from ldpcgputegra_tpu_torch.ops.layered import (
    LayeredSpec,
    make_layered_decoder,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the cores, and the
    many small tensor ops here run far slower on a pool of threads that
    competes with them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


VEC_DIR = os.path.join(os.path.dirname(__file__), "vectors")
VECTORS = sorted(p for p in glob.glob(os.path.join(VEC_DIR, "*.npz"))
                 if not os.path.basename(p).startswith("refcheck_"))


def _llrs(n, b, seed, std):
    """int8 all-zero-codeword LLRs; ``std`` is a scalar or one per frame."""
    rng = np.random.default_rng(seed)
    std = np.broadcast_to(np.asarray(std, dtype=np.float64), (b,))[:, None]
    return np.clip(8.0 * (-1.0 + std * rng.standard_normal((b, n))),
                   -31, 31).astype(np.int8)


def _batches(n, b=48, seed=0):
    """A mixed batch (frames converge at different iterations, some never)
    and a clean one (all converge early)."""
    return [_llrs(n, b, seed, np.linspace(0.35, 0.95, b)),
            _llrs(n, b, seed + 1, 0.4)]


def _check(name, kw, batches):
    port = make_layered_decoder(load_code(name), LayeredSpec(**kw))
    ref = j_decoder(j_load_code(name), JSpec(**kw))
    for llr in batches:
        bits, iters = port(torch.from_numpy(llr))
        rb, ri = ref(llr)
        assert bits.dtype == torch.uint8 and iters.dtype == torch.int32
        np.testing.assert_array_equal(bits.numpy(), np.asarray(rb))
        assert int(iters) == int(ri)


@pytest.mark.parametrize("et", [False, True])
@pytest.mark.parametrize("minclamp", ["pre", "post"])
@pytest.mark.parametrize("algo", ["MS", "OMS", "NMS", "2NMS"])
def test_plain_matches_jax_all_variants(algo, minclamp, et):
    """Every algorithm x minclamp x ET on 155x93 (odd Z = 31)."""
    _check("155x93", dict(algo=algo, iters=5, minclamp=minclamp,
                          early_term=et), _batches(155, b=64))


@pytest.mark.parametrize("et", [False, True])
@pytest.mark.parametrize("name", ["576x288", "1944x972", "2304x1152"])
def test_plain_matches_jax_main_codes(name, et):
    """The main-path codes, OMS/pre, with ET off and on."""
    _check(name, dict(algo="OMS", iters=4, early_term=et),
           _batches(j_load_code(name).N, seed=3))


def test_et_freezes_converged_frames():
    """ET output of each frame equals a fixed-iteration decode stopped at
    that frame's own convergence iteration (golden per-frame count)."""
    code = load_code("576x288")
    gcode = j_load_code("576x288")
    llr = _llrs(code.N, 12, 7, np.linspace(0.35, 0.9, 12))
    bits, iters = make_layered_decoder(
        code, LayeredSpec(iters=6, early_term=True))(torch.from_numpy(llr))
    gp = GoldenParams(algo="OMS", iters=6, early_term=True)
    used = []
    for f in range(llr.shape[0]):
        gb, gi = decode_golden(gcode, llr[f], gp)
        used.append(gi)
        np.testing.assert_array_equal(bits[f].numpy(), gb)
    assert int(iters) == max(used)
    assert min(used) < max(used)  # the batch really mixes convergence times


@pytest.mark.parametrize("path", VECTORS, ids=os.path.basename)
def test_plain_matches_committed_vectors(path):
    d = np.load(path)
    spec = LayeredSpec(algo=str(d["algo"]), iters=int(d["iters"]),
                       minclamp=str(d["minclamp"]), offset=int(d["offset"]))
    bits, iters = make_layered_decoder(load_code(str(d["code"])), spec)(
        torch.from_numpy(d["llr"]))
    np.testing.assert_array_equal(bits.numpy(), d["bits"])
    assert int(iters) == int(d["iters"])


@pytest.mark.parametrize("algo,minclamp", [("OMS", "pre"), ("2NMS", "post")])
def test_plain_matches_golden(algo, minclamp):
    code = load_code("576x288")
    gcode = j_load_code("576x288")
    llr = _llrs(code.N, 4, 11, 0.8)
    bits, _ = make_layered_decoder(
        code, LayeredSpec(algo=algo, iters=3, minclamp=minclamp))(
            torch.from_numpy(llr))
    gp = GoldenParams(algo=algo, iters=3, minclamp=minclamp)
    for f in range(llr.shape[0]):
        np.testing.assert_array_equal(bits[f].numpy(),
                                      decode_golden(gcode, llr[f], gp)[0])


# each decode kernel's wrapper: (module, its decoder, its launch counter)
_WRAPPERS = {"layered": (K, K.make_cuda_decoder, "layered_minsum"),
             "gather": (G, G.make_gather_decoder, "gather_minsum"),
             "streamed": (S, S.make_streamed_decoder, "streamed_minsum")}


@pytest.mark.parametrize("kernel,name,b", [
    ("layered", "576x288", 20), ("gather", "200x100", 13),
    ("gather", "2048x384", 13), ("gather", "1024x518", 13),
    ("streamed", "16200x10800", 5)])
def test_cuda_wrapper_runs_plain_on_cpu_tensors(kernel, name, b):
    """Each kernel's wrapper runs the plain version on a CPU tensor (a
    staircase code through its QC view, as ``make_decoder`` takes it) and
    launches nothing."""
    mod, make, counter = _WRAPPERS[kernel]
    code = effective_code(load_code(name))
    spec = LayeredSpec(iters=3, early_term=True)
    llr = torch.from_numpy(_llrs(code.N, b, 2, np.linspace(0.3, 0.9, b)))
    before = mod.launches[counter]
    kb, ki = make(code, spec)(llr)
    pb, pi = make_layered_decoder(code, spec)(llr)
    assert torch.equal(kb, pb) and int(ki) == int(pi)
    assert mod.launches[counter] == before  # no kernel on the CPU


@pytest.mark.parametrize("kernel", sorted(_WRAPPERS))
def test_decoder_input_checks(kernel):
    code = load_code("576x288")
    dec = make_layered_decoder(code, LayeredSpec(iters=2))
    with pytest.raises(TypeError):
        dec(torch.zeros((2, code.N), dtype=torch.int16))
    with pytest.raises(ValueError):
        dec(torch.zeros((2, code.N + 1), dtype=torch.int8))
    wrap = _WRAPPERS[kernel][1](code, LayeredSpec(iters=2))
    with pytest.raises(TypeError):
        wrap(torch.zeros((2, code.N), dtype=torch.int16))
    with pytest.raises(ValueError):
        wrap(torch.zeros((2, code.N + 1), dtype=torch.int8))
    with pytest.raises(ValueError):
        wrap(torch.zeros((0, code.N), dtype=torch.int8))
    with pytest.raises(ValueError, match="no kernel"):
        wrap(torch.zeros((2, code.N), dtype=torch.int8, device="meta"))


def test_layered_spec_validation_matches_reference():
    for bad in (dict(sat_var=128), dict(sat_msg=0), dict(nms_f=33),
                dict(nms_f2=0)):
        with pytest.raises(ValueError):
            JSpec(**bad)
        with pytest.raises(ValueError):
            LayeredSpec(**bad)
    assert [f.name for f in LayeredSpec.__dataclass_fields__.values()] == [
        f.name for f in JSpec.__dataclass_fields__.values()]
    assert LayeredSpec() == LayeredSpec(**JSpec().__dict__)


@pytest.mark.parametrize("schedule", ["auto", "reference", "colored"])
def test_plain_decodes_non_qc_200x100(schedule):
    """The non-QC 200x100 decodes bit-exact against JAX in every schedule."""
    _check("200x100", dict(iters=4, early_term=True, schedule=schedule),
           _batches(200, b=32, seed=5))


def test_unported_codes_and_schedules_raise():
    # flooding has no layers: make_decoder sends it to ops/flooding.py
    with pytest.raises(NotImplementedError, match="ops/flooding.py"):
        make_layered_decoder(load_code("576x288"),
                             LayeredSpec(schedule="flooding"))
    # the QC kernel walks code.layers: a colored (non-QC) order must never
    # reach it
    with pytest.raises(NotImplementedError, match="non-QC layers"):
        make_cuda_decoder(load_code("576x288"), LayeredSpec(schedule="colored"))
    # the staircase 16200x7560 decodes through its QC view: make_decoder on
    # the raw code gives the view's bits in the original column order
    raw = load_code("16200x7560")
    view = to_qc_form(raw)
    llr = torch.from_numpy(_llrs(raw.N, 3, 9, 0.6))
    spec = LayeredSpec(iters=3)
    bits, _ = make_decoder(raw, spec, device="cpu")(llr)
    vb, _ = make_layered_decoder(dataclasses.replace(view, col_perm=None),
                                 spec)(llr[:, view.col_perm])
    assert torch.equal(bits, vb[:, np.argsort(view.col_perm)])

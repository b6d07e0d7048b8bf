"""The port's flooding decoder (``ops/flooding.py``, plain PyTorch) against
the JAX package's (``ldpcgputegra_tpu/ops/flooding.py``, XLA on the CPU):
bits and ``iters_used`` equal at all four algorithms, both minclamp
forms, early termination on and off, on a QC code and a non-QC code; the
port's NumPy oracle against JAX's; and the factory's dispatch of the
flooding schedule on the original code."""

import numpy as np
import pytest
import torch

from ldpcgputegra_tpu.channel.encoder import make_encoder as j_make_encoder
from ldpcgputegra_tpu.codes.registry import load_code as j_load_code
from ldpcgputegra_tpu.codes.registry import (
    make_random_regular_code as j_random_regular,
)
from ldpcgputegra_tpu.golden import GoldenParams as JGolden
from ldpcgputegra_tpu.golden import decode_golden as j_decode_golden
from ldpcgputegra_tpu.ops.flooding import flooding_golden as j_golden
from ldpcgputegra_tpu.ops.flooding import make_flooding_decoder as j_flooding
from ldpcgputegra_tpu.ops.layered import LayeredSpec as JSpec
from ldpcgputegra_tpu_torch.codes.registry import (
    load_code,
    make_random_regular_code,
)
from ldpcgputegra_tpu_torch.decoder import backend_for, make_decoder
from ldpcgputegra_tpu_torch.golden import GoldenParams, decode_golden
from ldpcgputegra_tpu_torch.ops.flooding import (
    flooding_golden,
    make_flooding_decoder,
)
from ldpcgputegra_tpu_torch.ops.layered import LayeredSpec


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the cores, and the
    many small tensor ops here run far slower on a pool of threads that
    competes with them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ALGOS = ["MS", "OMS", "NMS", "2NMS"]
MINCLAMPS = ["pre", "post"]
ITERS = 6


def _codes():
    """(port code, JAX code) by name: a QC code and a non-QC one."""
    return {
        "576x288": (load_code("576x288"), j_load_code("576x288")),
        "rand512": (make_random_regular_code(512, 256, 8, seed=3),
                    j_random_regular(512, 256, 8, seed=3)),
    }


def _inputs(n: int):
    """A batch of mixed noise (some frames converge early, some never)
    and a clean one (every frame converges in the first iterations)."""
    rng = np.random.default_rng(n)
    std = np.linspace(0.3, 1.0, 12)[:, None]
    mixed = np.clip(8.0 * (-1.0 + std * rng.standard_normal((12, n))),
                    -31, 31).astype(np.int8)
    clean = np.clip(8.0 * (-1.0 + 0.3 * rng.standard_normal((12, n))),
                    -31, 31).astype(np.int8)
    return mixed, clean


@pytest.fixture(scope="module")
def jax_results():
    """Each JAX reference decoded once for the module: {(code, algo,
    minclamp, et): [(bits, iters_used) per input]}."""
    out = {}
    for name, (_, jcode) in _codes().items():
        inputs = _inputs(jcode.N)
        for algo in ALGOS:
            for mc in MINCLAMPS:
                for et in (False, True):
                    dec = j_flooding(jcode, JSpec(algo=algo, iters=ITERS,
                                                  minclamp=mc, early_term=et))
                    out[name, algo, mc, et] = [
                        (np.asarray(b), int(u))
                        for b, u in (dec(x) for x in inputs)]
    return out


@pytest.mark.parametrize("name", ["576x288", "rand512"])
@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("minclamp", MINCLAMPS)
@pytest.mark.parametrize("et", [False, True])
def test_flooding_matches_jax(jax_results, name, algo, minclamp, et):
    code = _codes()[name][0]
    dec = make_flooding_decoder(code, LayeredSpec(
        algo=algo, iters=ITERS, minclamp=minclamp, early_term=et))
    used_all = []
    for x, (jbits, jused) in zip(_inputs(code.N),
                                 jax_results[name, algo, minclamp, et]):
        bits, used = dec(torch.from_numpy(x))
        assert bits.dtype == torch.uint8 and used.dtype == torch.int32
        np.testing.assert_array_equal(bits.numpy(), jbits)
        assert int(used) == jused
        used_all.append(jused)
    if et:  # the clean batch ends early, the mixed one runs longer
        assert used_all[1] < ITERS and used_all[1] < used_all[0]


@pytest.mark.parametrize("algo,minclamp", [("OMS", "pre"), ("MS", "post"),
                                           ("2NMS", "pre")])
def test_flooding_golden_matches_jax(algo, minclamp):
    code, jcode = _codes()["rand512"]
    spec = LayeredSpec(algo=algo, iters=4, minclamp=minclamp)
    jspec = JSpec(algo=algo, iters=4, minclamp=minclamp)
    llr = _inputs(code.N)[0][:3]
    bits = make_flooding_decoder(code, spec)(torch.from_numpy(llr))[0].numpy()
    for b in range(3):
        ref = flooding_golden(code, llr[b], spec)
        np.testing.assert_array_equal(ref, j_golden(jcode, llr[b], jspec))
        np.testing.assert_array_equal(bits[b], ref)


@pytest.mark.parametrize("algo,minclamp,et", [("OMS", "pre", True),
                                              ("2NMS", "post", False)])
def test_golden_decoder_matches_jax_and_the_plain_decoder(algo, minclamp, et):
    """The port's copy of the NumPy golden decoder (flooding's oracle
    imports its f()) equals JAX's, and the plain layered decoder in the
    reference schedule equals it, bits and iterations."""
    code, jcode = _codes()["576x288"]
    kw = dict(algo=algo, iters=5, minclamp=minclamp, early_term=et)
    llr = _inputs(code.N)[0][:4]
    dec = make_decoder(code, LayeredSpec(schedule="reference", **kw),
                       device="cpu")
    for x in llr:
        bits, used = decode_golden(code, x, GoldenParams(**kw))
        jbits, jused = j_decode_golden(jcode, x, JGolden(**kw))
        np.testing.assert_array_equal(bits, jbits)
        assert used == jused
        pb, pu = dec(torch.from_numpy(x[None]))
        np.testing.assert_array_equal(pb.numpy()[0], bits.astype(np.uint8))
        assert int(pu) == used


def test_flooding_dispatch_on_the_original_code():
    """A staircase code floods in its own column order (not its QC
    view's): a noiseless codeword decodes to itself, and the factory
    names the backend on every device, whatever backend was asked for."""
    code = load_code("16200x7560")
    spec = LayeredSpec(algo="OMS", iters=4, schedule="flooding")
    for dev in ("cpu", torch.device("cuda")):
        for backend in ("auto", "cuda", "torch"):
            assert backend_for(code, spec, dev, backend) == "torch-flooding"
    info = np.random.default_rng(42).integers(0, 2, (2, code.K), np.int8)
    coded = j_make_encoder(j_load_code("16200x7560"), "staircase").encode(info)
    llr = np.where(coded != 0, 31, -31).astype(np.int8)
    bits, used = make_decoder(code, spec, device="cpu")(torch.from_numpy(llr))
    np.testing.assert_array_equal(bits.numpy(), coded.astype(np.uint8))
    assert int(used) == 4
    bits, used, ok = make_decoder(code, spec, device="cpu", emit_mask=True)(
        torch.from_numpy(llr))
    assert bool(ok.all())


def test_flooding_checks_its_input():
    dec = make_flooding_decoder(load_code("576x288"))
    with pytest.raises(TypeError):
        dec(torch.zeros((2, 576), dtype=torch.int16))
    with pytest.raises(ValueError):
        dec(torch.zeros((2, 575), dtype=torch.int8))

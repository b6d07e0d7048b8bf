"""The port's decoder extras (``decoder/extras.py``: the fake and the
hybrid host + device decoders), ``make_layered_decoder``'s ``node_major``
option, against the JAX package's; and the card as the entry points'
default device."""

import os

os.environ["OMP_NUM_THREADS"] = "1"  # before the native library loads

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from ldpcgputegra_tpu.codes.registry import load_code as j_load_code  # noqa: E402
from ldpcgputegra_tpu.decoder.extras import (  # noqa: E402
    make_fake_decoder as j_fake,
)
from ldpcgputegra_tpu.decoder.extras import (  # noqa: E402
    make_hybrid_decoder as j_hybrid,
)
from ldpcgputegra_tpu.ops.layered import LayeredSpec as JSpec  # noqa: E402
from ldpcgputegra_tpu.ops.layered import (  # noqa: E402
    make_layered_decoder as j_layered,
)
from ldpcgputegra_tpu_torch.codes.registry import load_code  # noqa: E402
from ldpcgputegra_tpu_torch.decoder import (  # noqa: E402
    effective_code,
    make_decoder,
)
from ldpcgputegra_tpu_torch.decoder.extras import (  # noqa: E402
    make_fake_decoder,
    make_hybrid_decoder,
)
from ldpcgputegra_tpu_torch.ops.layered import (  # noqa: E402
    LayeredSpec,
    make_layered_decoder,
)
from ldpcgputegra_tpu_torch.parallel.dryrun import (  # noqa: E402
    dryrun_multichip,
)
from ldpcgputegra_tpu_torch.parallel.dryrun import (  # noqa: E402
    main as dryrun_main,
)
from ldpcgputegra_tpu_torch.sim import cli  # noqa: E402
from ldpcgputegra_tpu_torch.sim.sweep import SweepConfig, run_sweep  # noqa: E402


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


def test_fake_decoder_matches_jax():
    llr = _llrs(576, 4, seed=0)
    bits, used = make_fake_decoder(load_code("576x288"), device="cpu")(
        torch.from_numpy(llr))
    jbits, jused = j_fake(j_load_code("576x288"))(llr)
    np.testing.assert_array_equal(bits.numpy(), np.asarray(jbits))
    assert int(used) == int(jused) == 0 and bits.dtype == torch.uint8


@pytest.mark.parametrize("fraction", [0.0, 0.5, 0.3, 1.0])
def test_hybrid_decoder_matches_pure_device(fraction):
    """Any split of the batch gives the plain decoder's bits, which are
    JAX's hybrid decoder's at 0.5; iters_used is the larger slice's."""
    code = load_code("576x288")
    kw = dict(algo="OMS", iters=5, early_term=True)
    llr = _llrs(code.N, 256, seed=3)
    hybrid = make_hybrid_decoder(code, LayeredSpec(**kw),
                                 host_fraction=fraction, device="cpu")
    hb, hit = hybrid(torch.from_numpy(llr))
    pb, pit = make_layered_decoder(code, LayeredSpec(**kw))(
        torch.from_numpy(llr))
    np.testing.assert_array_equal(hb.numpy(), pb.numpy())
    assert int(hit) == int(pit) and hb.dtype == torch.uint8
    if fraction == 0.5:
        jb, jit = j_hybrid(j_load_code("576x288"), JSpec(**kw),
                           host_fraction=0.5, backend="xla")(llr)
        np.testing.assert_array_equal(hb.numpy(), jb)
        assert int(hit) == int(jit)


def test_hybrid_rejects_a_bad_fraction():
    with pytest.raises(ValueError, match="host_fraction"):
        make_hybrid_decoder(load_code("576x288"), host_fraction=1.5,
                            device="cpu")


@pytest.mark.parametrize("name,et", [("576x288", False), ("576x288", True),
                                     ("200x100", True)])
def test_node_major_matches_jax(name, et):
    """``node_major``: [N, B] in and out, the bits of JAX's node-major
    decode and of the port's frame-major one; the input is not changed."""
    code = load_code(name)
    kw = dict(algo="OMS", iters=4, early_term=et)
    llr = _llrs(code.N, 5, seed=8)
    x = torch.from_numpy(llr.T.copy())
    bits, it = make_layered_decoder(code, LayeredSpec(**kw),
                                    node_major=True)(x)
    assert torch.equal(x, torch.from_numpy(llr.T))
    jbits, jit = j_layered(j_load_code(name), JSpec(**kw),
                           node_major=True)(llr.T)
    np.testing.assert_array_equal(bits.numpy(), np.asarray(jbits))
    fb, fit = make_layered_decoder(code, LayeredSpec(**kw))(
        torch.from_numpy(llr))
    np.testing.assert_array_equal(bits.numpy(), fb.numpy().T)
    assert int(it) == int(jit) == int(fit)
    with pytest.raises(ValueError, match=r"\[%d, B\]" % code.N):
        make_layered_decoder(code, LayeredSpec(**kw), node_major=True)(
            torch.from_numpy(llr))


def test_node_major_on_a_qc_view():
    """A staircase code's QC view permutes axis 0 in and back out."""
    view = effective_code(load_code("16200x7560"))
    spec = LayeredSpec(algo="OMS", iters=2)
    llr = torch.from_numpy(_llrs(view.N, 2, seed=9))
    nb, _ = make_layered_decoder(view, spec, node_major=True)(
        llr.t().contiguous())
    fb, _ = make_layered_decoder(view, spec)(llr)
    assert torch.equal(nb.t(), fb)


def test_the_card_is_the_default(monkeypatch, capfd):
    """Without a card, the entry points refuse to run unasked on the CPU;
    device='cpu' runs the plain versions; --info resolves as for a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    code = load_code("576x288")
    for build in (lambda: make_decoder(code, LayeredSpec()),
                  lambda: make_fake_decoder(code),
                  lambda: make_hybrid_decoder(code),
                  lambda: dryrun_multichip(2)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
    with pytest.raises(RuntimeError, match="--device cpu"):
        dryrun_main(["2"])
    cfg = dict(code="576x288", iters=3, snr_min=2.0, snr_max=2.0, batch=32,
               max_frames=32, pipeline_depth=1)
    with pytest.raises(RuntimeError, match="--device cpu"):
        run_sweep(SweepConfig(**cfg), progress=False)
    (p,) = run_sweep(SweepConfig(device="cpu", **cfg), progress=False).points
    assert p.frames == 32
    bits, _ = make_decoder(code, LayeredSpec(), device="cpu")(
        torch.from_numpy(_llrs(code.N, 2, seed=1)))
    assert bits.device.type == "cpu"
    cli.main(["--code", "1944x972", "--info"])
    out = capfd.readouterr().out
    assert "backend resolved as for a card" in out
    assert "backend      : cuda" in out

"""Two-phase early termination graphed on the card (``sim/scan.py`` over
``decoder/twophase.py``'s ``step``, ``sim/sweep.py``'s two-phase mode):
a graphed batch's bits are byte for byte the eager two-phase decode's, at
B=8192 on the QC kernel and on a gather-kernel code; the QC kernel's
convergence mask under capture equals the mask outside it; a sweep whose
tail every batch overflows is repaired to the eager decode's counts, with
the repairs counted and the masked launches counted under their own key.
Every test here needs an NVIDIA GPU and skips without one.

On a machine with a card (and without jax, which ``tests/conftest.py``
imports), run:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_twophase.py -q
"""

import dataclasses

import pytest
import torch

from ldpcgputegra_tpu_torch.channel.awgn import AwgnChannel
from ldpcgputegra_tpu_torch.codes.registry import load_code
from ldpcgputegra_tpu_torch.decoder import make_decoder, twophase
from ldpcgputegra_tpu_torch.ops.layered import LayeredSpec
from ldpcgputegra_tpu_torch.sim.analyzer import count_errors
from ldpcgputegra_tpu_torch.sim.scan import ScanSteps
from ldpcgputegra_tpu_torch.sim.sweep import SweepConfig, batch_seed, run_sweep

pytestmark = pytest.mark.cuda

SPEC = LayeredSpec(algo="OMS", iters=10, offset=1, minclamp="pre")


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _channel(code, snr, dev):
    chan = AwgnChannel(code.N, code.K, device=dev)
    chan.configure(snr)
    return chan


@pytest.mark.parametrize("name,batch,snr,tail,backend", [
    ("2304x1152", 8192, 3.0, 256, "cuda"),
    ("4000x2000", 4096, 2.5, 512, "cuda-gather"),
])
def test_graphed_step_equals_the_eager_decode(dev, name, batch, snr, tail,
                                              backend):
    from ldpcgputegra_tpu_torch.decoder import backend_for

    code = load_code(name)
    assert backend_for(code, SPEC, dev) == backend
    tp = twophase.make_twophase_decoder(code, SPEC, k1=5, device=dev)
    chan = _channel(code, snr, dev)
    seeds = [batch_seed(2**31 + 3, 0, k) for k in range(3)]

    def step(g):
        """A batch's bits and its unconverged count, as one int64 row."""
        bits, n_bad = tp.step(chan.generate_zero_int8(g, batch), tail)
        return torch.cat([bits.view(-1).to(torch.int64), n_bad[None]])

    got = ScanSteps(step, 3, dev)(seeds)
    for j, s in enumerate(seeds):
        want, stats = tp(chan.generate_zero_int8(chan.generator(s), batch))
        n_bad = stats["phase2_frames"]
        assert 0 < n_bad <= tail, "the tail must hold every unconverged frame"
        assert int(got[j, -1]) == n_bad
        assert torch.equal(got[j, :-1].view(batch, code.N).to(torch.uint8),
                           want), "graphed bits differ from eager"


def test_k1_mask_under_capture_equals_the_mask_outside(dev):
    code = load_code("2304x1152")
    dec1 = make_decoder(code, dataclasses.replace(SPEC, iters=5),
                        device=dev, emit_mask=True)
    chan = _channel(code, 3.0, dev)
    seeds = [batch_seed(2**31 + 5, 0, k) for k in range(2)]
    got = ScanSteps(lambda g: dec1(chan.generate_zero_int8(g, 8192))[2], 2,
                    dev)(seeds)
    for j, s in enumerate(seeds):
        _, _, ok = dec1(chan.generate_zero_int8(chan.generator(s), 8192))
        assert torch.equal(got[j], ok) and 0 < int((~ok).sum()) < 8192


def test_forced_overflow_is_repaired_exactly(dev):
    """A tail of 16 frames at 3.0 dB, where a batch of 8192 leaves about
    46 frames unconverged: every batch is repaired at its fetch, to the
    eager two-phase decode's counts."""
    from ldpcgputegra_tpu_torch.kernels import layered as K

    code = load_code("2304x1152")
    rows = {}
    cfg = SweepConfig(code="2304x1152", algo="OMS", iters=10, et="twophase",
                      twophase_k1=5, twophase_tail=16, snr_min=3.0,
                      snr_max=3.0, batch=8192, max_fe=10**9, auto_fe=False,
                      max_frames=8 * 8192, scan_steps=4, pipeline_depth=2,
                      seed=2**31 + 7, device="cuda")
    before = dict(twophase.stats)
    masked = K.launches["layered_minsum_mask"]
    run_sweep(cfg, progress=False, on_counts=lambda p, k, r: rows.update(
        {k + j: tuple(x) for j, x in enumerate(r)}))
    masked = K.launches["layered_minsum_mask"] - masked
    delta = {k: twophase.stats[k] - before[k] for k in before}
    tp = twophase.make_twophase_decoder(code, SPEC, k1=5, device=dev)
    chan = _channel(code, 3.0, dev)
    for k, row in rows.items():
        bits, stats = tp(chan.generate_zero_int8(
            chan.generator(batch_seed(cfg.seed, 0, k)), 8192))
        assert row == (*count_errors(bits), stats["phase2_frames"])
    over = [r for r in rows.values() if r[2] > 16]
    assert over and delta["repairs"] == len(over)
    assert delta["repaired_frames"] == sum(r[2] for r in over)
    # a masked launch a batch in the graph's replays, one a repair, and
    # the warm-up's before the capture
    assert masked == len(rows) + len(over) + 1

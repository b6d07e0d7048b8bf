"""``scan_steps`` in the port's sweep (``sim/scan.py``; on the CPU the S
batches of a dispatch run as a loop, on the card as one CUDA graph
replay): a port of ``tests/test_sweep_scan.py``.  Batch k's generator
keeps its seed ``batch_seed(seed, point, k)``, so the counters are the
same for any ``scan_steps`` over the same batch set, and a budget that S
does not divide overshoots to whole groups."""

import pytest
import torch

from ldpcgputegra_tpu_torch.sim.scan import ScanSteps
from ldpcgputegra_tpu_torch.sim.sweep import SweepConfig, run_sweep


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the cores, and the
    many small tensor ops here run far slower on a pool of threads that
    competes with them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(**kw):
    base = dict(
        code="576x288",
        algo="OMS",
        iters=5,
        snr_min=1.0,
        snr_max=2.0,
        snr_step=1.0,
        batch=128,
        max_fe=10**9,  # the frame budget decides the batch set exactly
        auto_fe=False,
        max_frames=512,
        seed=7,
        # depth 1: the stop check runs after every fetch, so both runs
        # decode exactly the k range rounded up to whole groups
        pipeline_depth=1,
        device="cpu",
    )
    base.update(kw)
    return SweepConfig(**base)


@pytest.fixture(scope="module")
def ref():
    return run_sweep(_cfg(), progress=False)


def test_scan_steps_counters_identical(ref):
    # 512 frames = 4 batches = one scan_steps=4 group: both runs decode
    # batches k=0..3, so the counters are identical
    scan = run_sweep(_cfg(scan_steps=4), progress=False)
    assert len(ref.points) == len(scan.points) == 2
    for a, b in zip(ref.points, scan.points):
        assert a.frames == b.frames == 512
        assert (a.be, a.fe, a.batches) == (b.be, b.fe, b.batches)
        assert a.fe > 0


def test_scan_steps_nondivisible_budget(ref):
    # a 4-batch budget in groups of 3 overshoots to 6 batches (2 groups);
    # every decoded batch is counted once
    scan = run_sweep(_cfg(scan_steps=3), progress=False)
    for a, b in zip(ref.points, scan.points):
        assert a.frames == 512
        assert b.frames == 768 and b.batches == 6
        # the same seeds k=0..3 underlie both; the extra batches only add
        assert b.be >= a.be and b.fe >= a.fe


def test_scan_steps_checkpoint_resume(tmp_path):
    ck = str(tmp_path / "ck.json")
    cfg = _cfg(scan_steps=4, checkpoint=ck)
    res1 = run_sweep(cfg, progress=False)
    res2 = run_sweep(cfg, progress=False)
    for a, b in zip(res1.points, res2.points):
        assert (a.frames, a.be, a.fe) == (b.frames, b.be, b.fe)


@pytest.mark.parametrize("code,encoder,batch,iters", [
    ("576x288", "gf2", 128, 5),
    ("16200x7560", "staircase", 8, 2),
])
def test_scan_steps_coded_path_folded(code, encoder, batch, iters):
    # the coded path folds scan_steps batches a dispatch too, each batch
    # drawing its info bits, then its noise, from its own seed: a budget
    # of one group gives the same counters at S = 1 and S = 4
    kw = dict(code=code, encoder=encoder, batch=batch, iters=iters,
              max_frames=4 * batch, snr_max=1.0)
    a = run_sweep(_cfg(**kw), progress=False)
    b = run_sweep(_cfg(scan_steps=4, **kw), progress=False)
    for pa, pb in zip(a.points, b.points):
        assert (pa.frames, pa.be, pa.fe) == (pb.frames, pb.be, pb.fe) \
            and pa.frames == 4 * batch and pa.fe > 0


def test_scan_steps_loop_on_the_cpu():
    """On the CPU a dispatch is a loop: [S, 2] counts from S generators,
    batch j from seeds[j], with no graph."""
    seen = []

    def step(gen):
        seen.append(gen.initial_seed())
        return torch.randint(0, 9, (2,), generator=gen)

    scan = ScanSteps(step, 3, "cpu")
    out = scan([11, 12, 13])
    assert out.shape == (3, 2) and seen == [11, 12, 13]
    assert torch.equal(out, scan([11, 12, 13]))
    assert scan.graph is None and scan.replays == 0
    with pytest.raises(ValueError):
        scan([1, 2])


@pytest.mark.parametrize("scan_steps", [1, 4])
def test_window_spans(scan_steps, capfd, monkeypatch):
    """Each fetch window reports its dispatch and fetch spans and its
    batches, to ``on_window`` and, with LDPC_TPU_DEBUG_TIMING=1, as the
    JAX sweep's (DBG) line."""
    monkeypatch.setenv("LDPC_TPU_DEBUG_TIMING", "1")
    spans = []
    (p,) = run_sweep(_cfg(snr_max=1.0, scan_steps=scan_steps,
                          pipeline_depth=2),
                     progress=False, on_window=lambda *w: spans.append(w)).points
    # depth 2 keeps a dispatch in flight past the budget: it is counted
    assert sum(w[2] for w in spans) == p.batches
    assert p.batches in (4 + scan_steps, 4 + 2 * scan_steps - 1)
    assert all(d >= 0 and f >= 0 and n % scan_steps == 0 for d, f, n in spans)
    out = capfd.readouterr().out
    assert out.count("(DBG) window: dispatch ") == len(spans)

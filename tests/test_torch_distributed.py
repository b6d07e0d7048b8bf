"""The port's multi-process Monte-Carlo point (``sim/distributed.py``) on
gloo ranks on the CPU: its counters equal a one-process ``run_sweep`` over
the same per-batch seeds, and ``run_dp_tp_point`` resumes from its
checkpoint to the same counters."""

import functools
import json

import pytest
import torch

from ldpcgputegra_tpu_torch.ops.layered import LayeredSpec
from ldpcgputegra_tpu_torch.parallel.launch import run_ranks
from ldpcgputegra_tpu_torch.sim import distributed
from ldpcgputegra_tpu_torch.sim.distributed import (
    run_distributed_point,
    run_dp_tp_point,
)
from ldpcgputegra_tpu_torch.sim.sweep import SweepConfig, run_sweep

CODE, SNR, BATCH, BATCHES, SEED = "576x288", 2.0, 32, 3, 1234
SPEC = LayeredSpec(algo="OMS", iters=4, early_term=True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _counts(a):
    return None if a is None else (a.frames, a.bit_errors, a.frame_errors)


def _point_rank(rank):
    return _counts(run_distributed_point(CODE, SNR, BATCH, BATCHES, SPEC,
                                         seed=SEED, device="cpu"))


def _dp_tp_rank(rank, batches, checkpoint):
    return _counts(run_dp_tp_point(CODE, SNR, BATCH, batches, SPEC, seed=SEED,
                                   dp=2, tp=2, checkpoint=checkpoint,
                                   device="cpu"))


@functools.lru_cache(maxsize=None)
def _one_process():
    """The same batches through one process's sweep (point 0, one batch
    in flight so that it stops at the frame budget)."""
    (p,) = run_sweep(SweepConfig(
        code=CODE, algo="OMS", iters=4, early_term=True, snr_min=SNR,
        snr_max=SNR, batch=BATCH, max_frames=BATCH * BATCHES, max_fe=10**9,
        auto_fe=False, seed=SEED, pipeline_depth=1, device="cpu"),
        progress=False).points
    return p.frames, p.be, p.fe


@pytest.mark.parametrize("world", [2, 4])
def test_distributed_point_matches_one_process(world):
    res = run_ranks(_point_rank, world)
    assert res[1:] == [None] * (world - 1)  # rank 0 reports
    assert res[0] == _one_process()
    assert res[0][2] > 0


def test_dp_tp_point_resumes_from_its_checkpoint(tmp_path):
    """2x2 ranks: one batch, then a resumed call to three, equal a run of
    three at once and the one-process sweep; the checkpoint holds the
    whole point."""
    ck = str(tmp_path / "ck.json")
    part = run_ranks(_dp_tp_rank, 4, (1, ck))
    assert part[0][0] == BATCH
    with open(ck) as f:
        assert json.load(f)["batches"] == 1
    resumed = run_ranks(_dp_tp_rank, 4, (BATCHES, ck))
    assert len(set(resumed)) == 1  # every rank returns the counters
    assert resumed[0] == _one_process()
    with open(ck) as f:
        st = json.load(f)
    assert (st["frames"], st["be"], st["fe"], st["batches"]) == (
        *resumed[0], BATCHES)
    whole = run_dp_tp_point(CODE, SNR, BATCH, BATCHES, SPEC, seed=SEED,
                            dp=1, tp=1, device="cpu")
    assert _counts(whole) == resumed[0]


def test_main_at_one_rank(capfd):
    """Without torchrun the world is one rank and no group is made."""
    distributed.main(["--dist-backend", "gloo", "--device", "cpu",
                      "--code", CODE, "--snr", str(SNR), "--batch",
                      str(BATCH), "--batches", str(BATCHES), "--iters", "4"])
    out = capfd.readouterr().out
    frames, be, fe = _one_process()
    assert f"RESULT frames={frames} be={be} fe={fe} " in out
    assert "ranks=1 backend=gloo" in out
    with pytest.raises(SystemExit):
        distributed.main(["--code", CODE])  # the backend must be named

"""The calibration of ``bench/ber_check.py::exact_p`` under the BER book's
sequential stop, by a seeded numpy simulation on the CPU.

``exact_p`` conditions on the two frame counts as if they were fixed, but
each point of the book stops at its adaptive FE target (``run_sweep``:
``ErrorAnalyzer.fe_limit``, checked after each fetched window, then the
batches still in flight are counted too), so the frame count depends on
the errors.  Here both sides of a pair draw frame errors at one FER, in
each curve's batch size of ``bench/ber_curves.py::CURVES``, with the bit
errors of an erroneous frame taken from the curve's deepest point in the
book, and stop as ``run_sweep`` does at the book's limits (``--max-fe``
100, ``--max-frames`` 3,000,000, pipeline depth 2).  The stop rule is
held against ``run_sweep`` itself, driven by a scripted decoder.  The
false-alarm rates at p < 0.01 and p < 1e-4 over all pairs are printed
(``pytest -s``); the 1e-4 gate's must stay below 1e-3.
"""

import ast
import inspect
import json
import os

import numpy as np
import pytest
import torch

from ldpcgputegra_tpu_torch.bench import ber_curves
from ldpcgputegra_tpu_torch.bench.ber_check import P_FAIL, P_WATCH, exact_p
from ldpcgputegra_tpu_torch.sim import sweep
from ldpcgputegra_tpu_torch.sim.analyzer import ErrorAnalyzer
from ldpcgputegra_tpu_torch.sim.sweep import SweepConfig, run_sweep

FERS = (1e-1, 1e-2, 1e-3, 1e-4)
TRIALS = 250  # pairs a (curve, FER)
SEED = 20261017


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _book_limits():
    """``ber_curves.main``'s ``--max-fe`` and ``--max-frames`` defaults."""
    tree = ast.parse(inspect.getsource(ber_curves.main))
    out = {}
    for c in ast.walk(tree):
        if (isinstance(c, ast.Call) and getattr(c.func, "attr", "") ==
                "add_argument" and c.args[0].value in ("--max-fe",
                                                       "--max-frames")):
            kw = {k.arg: k.value for k in c.keywords}
            out[c.args[0].value] = kw["default"].value
    return out["--max-fe"], out["--max-frames"]


MAX_FE, MAX_FRAMES = _book_limits()
DEPTH = SweepConfig().pipeline_depth


def fe_limit(ber, max_fe):
    """``ErrorAnalyzer.fe_limit`` (``auto_fe``) on an array of BERs."""
    return np.select([ber < 1e-9, ber < 1e-8, ber < 1e-7, ber < 1e-6],
                     [max_fe // 16, max_fe // 8, max_fe // 4, max_fe // 2],
                     max_fe)


def stop(fe, batch, counted_bits, w, max_fe, max_frames, depth):
    """(FE, frames) where ``run_sweep`` stops each row of ``fe`` [T, L]
    (frame errors a batch, ``w`` bit errors each): the limit is checked
    after every fetch of ``max(1, depth // 2)`` batches, then the
    ``depth - fetch`` batches still in flight are counted too."""
    fetch = max(1, depth // 2)
    T, L = fe.shape
    cum = np.cumsum(fe, axis=1)
    k = np.arange(1, L + 1)
    frames = k * batch
    ber = w * cum / (frames * counted_bits)
    hit = ((cum >= fe_limit(ber, max_fe)) | (frames >= max_frames)) & (
        k % fetch == 0)
    assert hit.any(axis=1).all(), "a row never stops: draw more batches"
    last = hit.argmax(axis=1) + depth - fetch + 1  # batches counted
    assert (last <= L).all()
    return cum[np.arange(T), last - 1], last * batch


def _scenarios():
    """(curve id, batch, counted bits, bit errors an erroneous frame) for
    every curve of the book: its batch, and BE / FE at its deepest point
    with a frame error."""
    out = []
    for ent in ber_curves.CURVES:
        extra = ent[7] if len(ent) > 7 else {}
        cid = ber_curves.curve_id(*ent[:3], extra.get("tag", ""))
        n, k = (int(x) for x in ent[0].split("x"))
        with open(os.path.join(ber_curves.DATA_DIR, cid + ".json")) as f:
            pts = [p for p in json.load(f)["points"] if p["fe"]]
        deep = pts[-1]
        counted = k if extra.get("count_bits") == "info" else n
        out.append((cid, ent[6], counted, deep["be"] / deep["fe"]))
    return out


def test_fe_limit_equals_the_analyzer():
    for n in (576, 64800):
        for frames in (512, 10 ** 5, 3 * 10 ** 6):
            for be in (0, 1, 7, 50, 3000, 10 ** 6):
                a = ErrorAnalyzer(n=n, k=n // 2, max_fe=MAX_FE)
                a.add_counts(frames, be, 0)
                got = fe_limit(np.array(be / (frames * n)), MAX_FE)
                assert int(got) == a.fe_limit(), (n, frames, be)


@pytest.mark.parametrize("depth,fer,w,max_fe,batches", [
    (2, 0.02, 3, 20, 60),     # the FE target
    (1, 0.02, 3, 20, 60),
    (4, 0.05, 3, 20, 60),
    (2, 0.001, 3, 20, 40),    # the frame budget
    (2, 2e-4, 1, 20, 1000),   # the adaptive target (BER < 1e-6)
])
def test_stop_rule_equals_run_sweep(monkeypatch, depth, fer, w, max_fe,
                                    batches):
    """``stop`` against ``run_sweep`` on the CPU, the decoder replaced by
    one that makes the scripted frame errors, ``w`` bits each."""
    batch, n = 64, 576
    rng = np.random.default_rng(SEED + depth)
    fe = rng.binomial(batch, fer, size=(1, batches + depth))
    calls = [0]

    def scripted(code, spec, backend="auto", device=None):
        def decode(llr):
            bits = torch.zeros(llr.shape, dtype=torch.uint8)
            bits[: int(fe[0, calls[0]]), :w] = 1
            calls[0] += 1
            return bits, torch.zeros((), dtype=torch.int32)
        return decode

    monkeypatch.setattr(sweep, "make_decoder", scripted)
    res = run_sweep(SweepConfig(
        code="576x288", batch=batch, snr_min=2.0, snr_max=2.0, max_fe=max_fe,
        max_frames=batches * batch, pipeline_depth=depth, device="cpu"),
        progress=False)
    (p,) = res.points
    want_fe, want_frames = stop(fe, batch, n, w, max_fe, batches * batch,
                                depth)
    assert (p.fe, p.frames) == (int(want_fe[0]), int(want_frames[0]))
    assert p.frames == calls[0] * batch


def test_false_alarm_rates_under_the_sequential_stop():
    rng = np.random.default_rng(SEED)
    ps, rows = [], []
    for cid, batch, counted, w in _scenarios():
        L = -(-MAX_FRAMES // batch) + DEPTH
        for fer in FERS:
            side = [stop(rng.binomial(batch, fer, size=(TRIALS, L)), batch,
                         counted, w, MAX_FE, MAX_FRAMES, DEPTH)
                    for _ in range(2)]
            (f1, n1), (f2, n2) = side
            p = np.array([exact_p(int(a), int(b), int(c), int(d))
                          for a, b, c, d in zip(f1, n1, f2, n2)])
            ps.append(p)
            rows.append((fer, p))
    ps = np.concatenate(ps)
    rate, rate_fail = (float((ps < x).mean()) for x in (P_WATCH, P_FAIL))
    for fer in FERS:
        p = np.concatenate([q for f, q in rows if f == fer])
        print(f"[calibration] FER {fer:g}: {p.size} pairs, "
              f"p < {P_WATCH}: {(p < P_WATCH).mean():.4f}, "
              f"p < {P_FAIL}: {(p < P_FAIL).mean():.5f}")
    print(f"[calibration] {ps.size} pairs: p < {P_WATCH}: {rate:.4f} "
          f"({int((ps < P_WATCH).sum())}), p < {P_FAIL}: {rate_fail:.5f} "
          f"({int((ps < P_FAIL).sum())})")
    assert ps.size == len(ber_curves.CURVES) * len(FERS) * TRIALS
    assert rate_fail < 1e-3

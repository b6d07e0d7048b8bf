"""The program's spans (``utils/profiling.py``): nothing kept with no
profiler running; under one, a span per decode call in each kernel
wrapper, the sweep's dispatch, fetch and accounting and each group's
reseeding with their parents, requests and counts, on the readings that
``on_window`` receives; and the same spans in ``trace()``'s Chrome trace,
as annotations on the calling thread.  On the CPU, where the wrappers run
their plain version."""

import glob
import json
import threading

import pytest
import torch

from ldpcgputegra_tpu_torch.codes.registry import load_code
from ldpcgputegra_tpu_torch.decoder import make_decoder
from ldpcgputegra_tpu_torch.ops.layered import LayeredSpec
from ldpcgputegra_tpu_torch.sim.sweep import SweepConfig, run_sweep
from ldpcgputegra_tpu_torch.utils import profiling
from ldpcgputegra_tpu_torch.utils.profiling import span, spans, trace


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the cores, and the
    many small tensor ops here run far slower on a pool of threads that
    competes with them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def _new(before: int, name: str = "ldpc.") -> list:
    """The records kept since ``before`` whose name starts with ``name``."""
    return [r for r in spans()[before:] if r.name.startswith(name)]


def test_no_profiler_records_nothing():
    before = len(spans())
    off = span("x")
    assert span("y", request=(0, 1), count=8, start=1.0) is off
    with span("decode", count=4) as sp:
        sp.end = 2.0
        sp.count = 5
    assert sp is off
    assert len(spans()) == before
    with _profile():
        on = span("x")
    assert on is not off and isinstance(on, profiling.Span)
    assert on.name == "ldpc.x" and len(spans()) == before


@pytest.mark.parametrize("backend", ["cuda", "cuda-gather", "cuda-streamed"])
def test_each_wrapper_records_one_decode_span_a_call(backend):
    code = load_code("576x288")
    dec = make_decoder(code, LayeredSpec(iters=3), backend=backend,
                       device="cpu")
    llrs = [torch.full((b, code.N), -7, dtype=torch.int8) for b in (8, 3)]
    dec(llrs[0])  # the plain version's build, outside the profile
    before = len(spans())
    with _profile():
        for x in llrs:
            dec(x)
    got = _new(before)
    assert [(r.name, r.count, r.parent) for r in got] == [
        ("ldpc.decode", 8, None), ("ldpc.decode", 3, None)]
    assert got[0].request != got[1].request
    assert all(0 < r.end - r.start < 60 for r in got)
    assert got[0].end <= got[1].start


def test_sweep_records_its_spans_per_group():
    """scan_steps 4 at depth 2 on the CPU: a dispatch stretch, a fetch and
    an accounting each window, one reseeding each group under its
    dispatch, and the same readings as ``on_window``'s."""
    windows = []
    cfg = SweepConfig(code="576x288", iters=3, snr_min=1.0, snr_max=1.0,
                      batch=32, max_fe=10**9, auto_fe=False,
                      max_frames=32 * 12, scan_steps=4, pipeline_depth=2,
                      seed=11, backend="cuda-streamed", device="cpu")
    before = len(spans())
    with _profile():
        (p,) = run_sweep(cfg, progress=False,
                         on_window=lambda *w: windows.append(w)).points
    got = _new(before)
    by = {n: [r for r in got if r.name == "ldpc." + n]
          for n in ("sweep.dispatch", "sweep.fetch", "sweep.account",
                    "scan.prepare", "decode")}
    disp, fetch = by["sweep.dispatch"], by["sweep.fetch"]
    acct = by["sweep.account"]
    assert len(disp) == len(fetch) == len(acct) == len(windows) >= 3
    # one reading an edge: on_window's spans are the records' durations
    for (d_s, f_s, n), d, f in zip(windows, disp, fetch):
        assert d_s == d.end - d.start and f_s == f.end - f.start
        assert d.end == f.start and f.count == n
    for d, f, a, d_next in zip(disp, fetch, acct, disp[1:]):
        assert d.end == f.start and f.end <= a.start
        assert a.end == d_next.start and a.request == f.request
    # each group: (point, first batch), its reseeding under its dispatch
    assert [d.request for d in disp] == [(0, 0), (0, 8), (0, 12), (0, 16)]
    assert [d.count for d in disp] == [8, 4, 4, 0]
    assert [f.request for f in fetch] == [(0, 0), (0, 4), (0, 8), (0, 12)]
    assert sum(f.count for f in fetch) == p.batches == 16
    prep = by["scan.prepare"]
    assert len(prep) == 4 and all(r.count == 4 for r in prep)
    assert [r.parent for r in prep] == [disp[0], disp[0], disp[1], disp[2]]
    assert all(r.request == r.parent.request for r in prep)
    # on the CPU the S steps run after their reseeding, in the dispatch
    assert len(by["decode"]) == 16
    assert all(r.parent.name == "ldpc.sweep.dispatch" for r in by["decode"])


def test_trace_holds_the_spans_on_the_callers_thread(tmp_path):
    code = load_code("576x288")
    dec = make_decoder(code, LayeredSpec(iters=3), backend="cuda-streamed",
                       device="cpu")
    x = torch.full((8, code.N), -7, dtype=torch.int8)
    dec(x)
    with _profile():  # the profiler's first annotation, outside the trace
        with span("warm"):
            pass
    before = len(spans())
    with trace(str(tmp_path)) as where:
        with span("outer", count=2):
            dec(x)
            dec(x)
    got = _new(before)
    assert [r.name for r in got] == ["ldpc.decode"] * 2 + ["ldpc.outer"]
    assert all(r.parent is got[2] for r in got[:2])
    (path,) = glob.glob(where + "/*.pt.trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ann = sorted((e for e in events if e.get("ph") == "X"
                  and e.get("cat") == "user_annotation"
                  and e["name"].startswith("ldpc.")), key=lambda e: e["ts"])
    assert [e["name"] for e in ann] == ["ldpc.outer"] + ["ldpc.decode"] * 2
    tid = threading.get_native_id()
    recs = sorted(got, key=lambda r: r.start)
    for e, r in zip(ann, recs):
        assert e["tid"] == tid and e["name"] == r.name
        rec_us = 1e6 * (r.end - r.start)
        assert abs(e["dur"] - rec_us) <= max(0.05 * rec_us, 50.0), (
            e["name"], e["dur"], rec_us)


def test_encoder_spans_and_counter():
    """The table encoder's scatter build at set-up is the span
    ``ldpc.encoder.build`` (count: its pairs, 43200 at 16200x10800); each
    encode is an ``ldpc.encode`` span (count: the frames) and one more in
    ``encodes[kind]``; a coded sweep at scan_steps 2 encodes each batch
    once, each encode inside its dispatch; ``sim/scan.py`` carries the
    counter over graph replays."""
    from ldpcgputegra_tpu_torch.channel import encoder as E
    from ldpcgputegra_tpu_torch.sim import scan

    assert any(c is E.encodes for c in scan._launch_counters())
    code = load_code("16200x10800")
    before = len(spans())
    with _profile():
        enc = E.make_encoder(code, "table")
        n0 = dict(E.encodes)
        enc.encode(torch.zeros((3, code.K), dtype=torch.int8))
    got = _new(before)
    assert [(r.name, r.count) for r in got] == [
        ("ldpc.encoder.build", 43200), ("ldpc.encode", 3)]
    assert {k: E.encodes[k] - n0[k] for k in n0} == {
        "fake": 0, "table": 1, "staircase": 0, "gf2": 0}
    cfg = SweepConfig(code="576x288", iters=3, snr_min=1.0, snr_max=1.0,
                      batch=16, max_fe=10**9, auto_fe=False,
                      max_frames=16 * 4, scan_steps=2, pipeline_depth=1,
                      encoder="gf2", seed=5, device="cpu")
    before = len(spans())
    n0 = dict(E.encodes)
    with _profile():
        (p,) = run_sweep(cfg, progress=False).points
    got = _new(before)
    assert E.encodes["gf2"] - n0["gf2"] == p.batches == 4
    encs = [r for r in got if r.name == "ldpc.encode"]
    assert [r.count for r in encs] == [16] * 4
    assert all(r.parent is not None and r.parent.name == "ldpc.sweep.dispatch"
               for r in encs)

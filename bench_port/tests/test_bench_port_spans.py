"""The readers of the program's spans, ``wrapper_host_ms`` and
``refill_ms_per_group``: on synthetic records, each keeps only the calls
or groups of the window, gives their mean, and gives None where there is
nothing to read (no spans, or a program without them); and on the CPU a
traced run of the sweep kind, cut small, reads a refill."""

import types

import pytest
import torch

from bench_port import cell
from ldpcgputegra_tpu_torch.utils import profiling
from ldpcgputegra_tpu_torch.utils.profiling import Span

from ._small import ROOT, small_run

CTX = types.SimpleNamespace(timeline=None, layer={}, hw={})


def _reader(name):
    return cell.load_reader(name, ROOT)


def _span(name, start, end, parent=None, count=None):
    return Span("ldpc." + name, count=count, start=start, end=end,
                parent=parent)


def _use(monkeypatch, records):
    monkeypatch.setattr(profiling, "spans", lambda: list(records))


def test_wrapper_host_ms_is_the_mean_call(monkeypatch):
    calls = [_span("decode", 1.0, 1.001, count=128),
             _span("decode", 2.0, 2.003, count=128)]
    capture = _span("sweep.dispatch", 0.0, 0.5)
    records = [_span("decode.pick", 1.0002, 1.0009, calls[0], 1), calls[0],
               _span("decode.pick", 2.0002, 2.0029, calls[1], 1), calls[1],
               # a decode in the program's own span (a graph's capture) is
               # not a caller's call
               _span("decode", 0.1, 0.4, capture, 512), capture,
               _span("sweep.fetch", 3.0, 3.5)]
    _use(monkeypatch, records)
    assert _reader("wrapper_host_ms")(CTX) == pytest.approx(2.0)
    _use(monkeypatch, [])
    assert _reader("wrapper_host_ms")(CTX) is None
    _use(monkeypatch, records[-3:])
    assert _reader("wrapper_host_ms")(CTX) is None


def _sweep_records():
    """A sweep traced from its start: the capture's decodes and the first
    two groups' reseeding, then three windows; refills of 1.5 and 2.5 ms
    after the first two fetches, none after the last (the drain)."""
    out = []
    d0 = _span("sweep.dispatch", 0.0, 1.0)
    out += [_span("decode", 0.1, 0.2, d0), _span("decode", 0.3, 0.4, d0),
            _span("scan.prepare", 0.5, 0.5001, d0, 16),
            _span("scan.prepare", 0.6, 0.6001, d0, 16), d0]
    t = 1.0
    for refill in (0.0015, 0.0025, None):
        out.append(_span("sweep.fetch", t, t + 0.1))
        end = t + 0.1
        out.append(_span("sweep.account", end + 0.0001, end + 0.0002))
        if refill is not None:
            d = _span("sweep.dispatch", end + 0.0002, end + 0.003)
            out += [_span("scan.prepare", end + refill - 0.0001,
                          end + refill, d, 16), d]
        t = end + 0.003
    return out


def test_refill_keeps_the_groups_after_the_first_fetch(monkeypatch):
    records = _sweep_records()
    _use(monkeypatch, records)
    assert _reader("refill_ms_per_group")(CTX) == pytest.approx(2.0)
    # a fetch with no reseeding before the next fetch has no refill
    no_prep = [r for r in records if not (r.name == "ldpc.scan.prepare"
                                          and r.start > 1.0)]
    _use(monkeypatch, no_prep)
    assert _reader("refill_ms_per_group")(CTX) is None
    _use(monkeypatch, [])
    assert _reader("refill_ms_per_group")(CTX) is None


def test_readers_give_none_for_a_program_without_spans(monkeypatch):
    monkeypatch.delattr(profiling, "spans")
    for name in ("wrapper_host_ms", "refill_ms_per_group"):
        assert _reader(name)(CTX) is None


def test_traced_sweep_on_the_cpu_reads_a_refill(monkeypatch):
    from bench_port.window import Window

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        run = small_run("sweep_s16_b512")
        run.setup()
        before = len(profiling.spans())
        win = Window(True, run.window_name)
        run.measure(win, 1.5)
    finally:
        torch.set_num_threads(n)
    records = profiling.spans()[before:]
    fetches = [r for r in records if r.name == "ldpc.sweep.fetch"]
    assert len(fetches) == len(run.groups) >= 3
    _use(monkeypatch, records)
    refill = _reader("refill_ms_per_group")(CTX)
    assert refill is not None and 0 < refill < 1e3 * win.seconds, [
        (r.name, r.start, r.end) for r in records]

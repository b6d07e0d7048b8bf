"""The benchmark's configuration of the paper's (4000,2000) code on the
CPU: the reference's check-order file against the raw matrix, against its
own regeneration (``bench_port/reference/colored_order.py``) and against
the program's coloured layers; the reference's decode in that order
against the program's plain decoder, and one message bit less against
it; the ``k3_roofline`` reader on a made-up timeline; and the span of the
program's colouring."""

import functools
import json
import os
import types

import numpy as np
import pytest
import torch

from bench_port import cell
from bench_port.common import make_inputs, program_spec
from bench_port.reference import colored_order
from bench_port.reference.codes import schedule_for
from bench_port.reference.decoder import Fixed, decode
from bench_port.trace import Timeline
from bench_port.yardstick import decode_bound_s, int32_rate
from ldpcgputegra_tpu_torch.codes.registry import load_code
from ldpcgputegra_tpu_torch.codes.schedule import build_layers
from ldpcgputegra_tpu_torch.utils.profiling import spans

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 2**31 + 5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the cores, and the
    reference's 2000 one-check layers are many small tensor ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config() -> dict:
    with open(os.path.join(ROOT, "bench_port", "configs",
                           "paper_4000x2000.json")) as f:
        return json.load(f)


def _order() -> dict:
    with open(os.path.join(ROOT, _config()["code_file"])) as f:
        return json.load(f)


def test_order_file_holds_each_check_of_the_matrix_once():
    from ldpcgputegra_tpu_torch.bench.roofline import edge_updates

    cfg, doc = _config(), _order()
    raw = np.load(os.path.join(ROOT, colored_order.MATRIX))
    deg = int(raw["classes"][0][0])
    assert [[deg, 2000]] == raw["classes"].tolist()
    checks = raw["edges"].astype(np.int64).reshape(-1, deg)
    rows = [tuple(r["cols"]) for r in doc["rows"]]
    assert sorted(rows) == sorted(map(tuple, checks.tolist()))
    assert len(set(rows)) == len(rows) == 2000
    assert all(r["shifts"] == [0] * deg for r in doc["rows"])
    assert (doc["Z"], doc["N"], doc["K"]) == (1, cfg["n"], cfg["k"])
    sched = schedule_for(cfg, ROOT)
    assert (sched.n, sched.k, len(sched.layers)) == (4000, 2000, 2000)
    assert sched.edge_updates == cfg["edge_updates"] == 12000
    assert edge_updates(load_code(cfg["code"])) == 12000


def test_order_file_regenerates_byte_for_byte():
    with open(os.path.join(ROOT, colored_order.ORDER)) as f:
        committed = f.read()
    assert colored_order.dumps(colored_order.document(ROOT)) == committed


def test_order_is_the_programs_coloured_layers():
    doc = _order()
    layers = build_layers(load_code(_config()["code"]), "auto")
    assert [lay.idx.shape[0] for lay in layers] == doc["layers"]
    assert len(layers) == 11 and sum(doc["layers"]) == 2000
    rows = np.asarray([r["cols"] for r in doc["rows"]], np.int64)
    at = 0
    for lay in layers:
        size = lay.idx.shape[0]
        assert np.array_equal(lay.idx, rows[at: at + size])
        at += size


@functools.lru_cache(maxsize=None)
def _inputs():
    return make_inputs(_config(), {"batch": 8, "ebn0_db": 1.5}, SEED, 0, 1,
                       "cpu")[0]


@functools.lru_cache(maxsize=None)
def _reference(early_term: bool, msg_bits=None):
    cfg = _config()
    over = {} if msg_bits is None else {"msg_bits": msg_bits}
    return decode(schedule_for(cfg, ROOT), _inputs().clone(),
                  Fixed.of(cfg, early_term, **over))


@pytest.mark.parametrize("early_term", [False, True])
def test_reference_in_the_order_equals_the_programs_plain_decoder(early_term):
    from ldpcgputegra_tpu_torch.decoder import make_decoder

    cfg = _config()
    bits, used, frame_iters = _reference(early_term)
    dec = make_decoder(load_code(cfg["code"]), program_spec(cfg, early_term),
                       device="cpu")
    p_bits, p_used = dec(_inputs().clone())
    assert int(bits.sum()) > 0  # the decode has errors to get right
    if early_term:  # frames freeze at different iterations
        assert int(frame_iters.min()) < int(frame_iters.max())
    assert torch.equal(bits, p_bits) and used == int(p_used)


def test_reference_one_message_bit_less_differs():
    cfg = _config()
    bits, _, _ = _reference(False)
    low, _, _ = _reference(False, cfg["msg_bits"] - 1)
    assert int((low != bits).sum()) > 0


def _ctx(kernels, iters_per_frame=3.0):
    tl = Timeline(window_s=1.0, busy_s=0.9, kernels=kernels, gaps=[])
    return types.SimpleNamespace(
        timeline=tl, hw={"sms": 132, "clock_hz": 1.98e9},
        layer={"batch": 4096, "n": 4000, "edge_updates": 12000,
               "iters_per_frame": iters_per_frame})


def test_k3_roofline_reads_the_gather_kernel():
    read = cell.load_reader("k3_roofline", ROOT)
    ctx = _ctx({"void gather_minsum_kernel<4, 2, true>(Args)": [0.6, 600],
                "void at::native::elementwise_kernel<128, 2>": [0.3, 4800]})
    bound = decode_bound_s(12000, 3.0, 4096, 4000, int32_rate(132, 1.98e9))
    assert read(ctx) == pytest.approx(100.0 * bound / (0.6 / 600))
    assert 0.0 < read(ctx) <= 100.0
    assert read(_ctx({"void streamed_minsum_kernel<1, 8, 1, true>":
                      [0.6, 60]})) is None
    assert read(types.SimpleNamespace(timeline=None, hw=ctx.hw,
                                      layer=ctx.layer)) is None


def test_colouring_is_one_span_and_the_lookup_none():
    fresh = load_code.__wrapped__("4000x2000")

    def colour_spans(before):
        return [s for s in spans() if s.name == "ldpc.schedule.color"
                and id(s) not in before]

    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        before = {id(s) for s in spans()}
        layers = build_layers(fresh, "auto")
        made = colour_spans(before)
        before |= {id(s) for s in made}
        assert build_layers(fresh, "auto") is layers
        again = colour_spans(before)
    assert [s.count for s in made] == [len(layers)] == [11]
    assert again == []

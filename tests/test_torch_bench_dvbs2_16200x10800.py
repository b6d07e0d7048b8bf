"""The benchmark's configuration of the DVB-S2 short frame at rate 2/3
(``bench_port/configs/dvbs2_16200x10800.json``) on the CPU: the
reference's encoder (``bench_port/reference/coded.py``, written from the
standard's description) against every check of the raw matrix and
against the program's table encoder; the reference's LLRs of coded bits
against the program's channel; the reference's decode of coded frames
against the program's plain decoder, ET on and off, and one message bit
less against it; the frozen edge count against the reference's schedule
and the program's roofline."""

import json
import os

import numpy as np
import pytest
import torch

from bench_port.common import program_spec
from bench_port.reference.channel import seeded
from bench_port.reference.codes import schedule_for
from bench_port.reference.coded import coded_frames, encode, info_bits
from bench_port.reference.decoder import Fixed, decode
from bench_port.yardstick import batch_seed
from ldpcgputegra_tpu_torch.channel.awgn import AwgnChannel, ChannelSpec
from ldpcgputegra_tpu_torch.channel.bitgen import generate_info_bits
from ldpcgputegra_tpu_torch.channel.encoder import make_encoder
from ldpcgputegra_tpu_torch.codes.registry import load_code
from ldpcgputegra_tpu_torch.quant import QuantSpec

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 2**31 + 21


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config() -> dict:
    with open(os.path.join(ROOT, "bench_port", "configs",
                           "dvbs2_16200x10800.json")) as f:
        return json.load(f)


def _checks(cfg) -> list:
    """Each check of the raw matrix file: its VNs."""
    d = np.load(os.path.join(ROOT, cfg["code_file"]))
    edges, out, pos = d["edges"].astype(np.int64), [], 0
    for deg, count in d["classes"]:
        size = int(deg) * int(count)
        out.extend(edges[pos: pos + size].reshape(int(count), int(deg)))
        pos += size
    assert pos == edges.size
    return out


def _program_frames(cfg, seed, batch, ebn0):
    """The program's bit draw, table encoder and channel on the CPU."""
    enc = make_encoder(load_code(cfg["code"]), "table")
    chan = AwgnChannel(cfg["n"], cfg["k"], ChannelSpec(quant=QuantSpec(
        cfg["quant_factor"], cfg["bits_llr"])), "cpu")
    chan.configure(ebn0)
    gen = chan.generator(seed)
    cw = enc.encode(generate_info_bits(gen, batch, cfg["k"]))
    return cw, chan.generate_int8(gen, cw)


def test_reference_codewords_satisfy_the_matrix_and_equal_the_programs():
    cfg = _config()
    info = info_bits(seeded(SEED, "cpu"), 8, cfg["k"], "cpu")
    cw = encode(os.path.join(ROOT, cfg["encoder_file"]), info)
    assert cw.shape == (8, cfg["n"]) and cw.dtype == torch.int8
    assert torch.equal(cw[:, :cfg["k"]], info)  # systematic
    checks = _checks(cfg)
    assert len(checks) == cfg["n"] - cfg["k"]
    bits = cw.numpy().astype(np.int64)
    for vns in checks:
        assert not (bits[:, vns].sum(1) & 1).any()
    assert int(cw[:, cfg["k"]:].sum()) > 0
    prog = make_encoder(load_code(cfg["code"]), "table").encode(info)
    assert torch.equal(prog, cw)


@pytest.mark.parametrize("ebn0", [0.0, 2.4])
def test_reference_coded_llrs_equal_the_programs_channel(ebn0):
    cfg = _config()
    seed = batch_seed(SEED, 0, 5)
    cw, llr = coded_frames(seeded(seed, "cpu"), cfg, ROOT, 6, ebn0)
    p_cw, p_llr = _program_frames(cfg, seed, 6, ebn0)
    assert torch.equal(cw, p_cw) and torch.equal(llr, p_llr)
    # both symbols are sent, and the clamp engages at 0 dB
    assert int((llr > 0).sum()) > 0 and int((llr < 0).sum()) > 0
    if ebn0 == 0.0:
        assert int(llr.abs().max()) == (1 << (cfg["bits_llr"] - 1)) - 1


@pytest.fixture(scope="module")
def coded16():
    """16 coded frames at 2.2 dB and the program's plain decodes."""
    from ldpcgputegra_tpu_torch.decoder import make_decoder

    cfg = _config()
    cw, llr = coded_frames(seeded(batch_seed(SEED, 0, 6), "cpu"), cfg, ROOT,
                           16, 2.2)
    out = {}
    for et in (False, True):
        dec = make_decoder(load_code(cfg["code"]), program_spec(cfg, et),
                           device="cpu")
        out[et] = dec(llr)
    return cfg, cw, llr, out


@pytest.mark.parametrize("early_term", [False, True])
def test_reference_decode_equals_the_programs_plain_decoder(coded16,
                                                            early_term):
    cfg, cw, llr, prog = coded16
    bits, used, _ = decode(schedule_for(cfg, ROOT), llr,
                           Fixed.of(cfg, early_term))
    p_bits, p_used = prog[early_term]
    assert torch.equal(bits, p_bits) and used == int(p_used)
    err = bits[:, :cfg["k"]] != cw[:, :cfg["k"]].to(torch.uint8)
    # frames to get right and frames that fail
    assert int(err.any(1).sum()) > 0 and int((~err.any(1)).sum()) > 0


def test_one_message_bit_less_differs(coded16):
    cfg, _, llr, prog = coded16
    bits, used, _ = decode(schedule_for(cfg, ROOT), llr,
                           Fixed.of(cfg, True, msg_bits=cfg["msg_bits"] - 1))
    p_bits, p_used = prog[True]
    assert not torch.equal(bits, p_bits) or used != int(p_used)


def test_frozen_edge_count_recomputes():
    from ldpcgputegra_tpu_torch.bench.roofline import edge_updates

    cfg = _config()
    sched = schedule_for(cfg, ROOT)
    assert (sched.n, sched.k) == (cfg["n"], cfg["k"]) == (16200, 10800)
    assert len(sched.layers) == 38
    assert sched.edge_updates == cfg["edge_updates"] == 53999
    assert edge_updates(load_code(cfg["code"])) == 53999

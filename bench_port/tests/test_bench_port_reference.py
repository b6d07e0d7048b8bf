"""The reference against the program's plain decoder and channel on the
CPU, the frozen edge counts against each code's matrix, and the control:
the reference at one message bit less fails the comparison."""

import json
import os

import pytest
import torch

from bench_port.common import make_inputs, passes, program_spec
from bench_port.reference.codes import schedule_for
from bench_port.reference.decoder import Fixed, decode
from bench_port.yardstick import batch_seed

from ._small import ROOT, drive, small_config, small_run


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _config(name):
    with open(os.path.join(ROOT, "bench_port", "configs", name + ".json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", ["wimax_2304x1152", "dvbs2_64800x32400"])
def test_frozen_edge_counts_recompute_from_the_matrix(name):
    from ldpcgputegra_tpu_torch.bench.roofline import edge_updates
    from ldpcgputegra_tpu_torch.codes.registry import load_code

    cfg = _config(name)
    sched = schedule_for(cfg, ROOT)
    assert (sched.n, sched.k) == (cfg["n"], cfg["k"])
    assert sched.edge_updates == cfg["edge_updates"]
    assert edge_updates(load_code(cfg["code"])) == cfg["edge_updates"]


@pytest.mark.parametrize("name,batch,iters", [("wimax_2304x1152", 24, 10),
                                              ("dvbs2_64800x32400", 2, 3)])
@pytest.mark.parametrize("early_term", [False, True])
def test_reference_equals_the_programs_plain_decoder(name, batch, iters,
                                                     early_term):
    from ldpcgputegra_tpu_torch.codes.registry import load_code
    from ldpcgputegra_tpu_torch.decoder import make_decoder

    cfg = dict(_config(name), iters=iters)
    x = make_inputs(cfg, {"batch": batch, "ebn0_db": 1.2}, 2**31 + 5, 0, 1,
                    "cpu")[0]
    bits, used, _ = decode(schedule_for(cfg, ROOT), x,
                           Fixed.of(cfg, early_term))
    dec = make_decoder(load_code(cfg["code"]), program_spec(cfg, early_term),
                       device="cpu")
    p_bits, p_used = dec(x)
    assert int(bits.sum()) > 0  # the decode has errors to get right
    assert torch.equal(bits, p_bits) and used == int(p_used)


def test_reference_channel_equals_the_programs():
    from ldpcgputegra_tpu_torch.channel.awgn import AwgnChannel, ChannelSpec
    from ldpcgputegra_tpu_torch.quant import QuantSpec

    cfg = small_config()
    seed = batch_seed(2**31 + 11, 0, 3)
    ref = make_inputs(cfg, {"batch": 8, "ebn0_db": 2.0}, 2**31 + 11, 0, 4,
                      "cpu")[3]
    chan = AwgnChannel(cfg["n"], cfg["k"], ChannelSpec(quant=QuantSpec(
        cfg["quant_factor"], cfg["bits_llr"])), "cpu")
    chan.configure(2.0)
    assert torch.equal(chan.generate_zero_int8(chan.generator(seed), 8), ref)


@pytest.mark.parametrize("traffic", ["decode_b8192", "block_b128",
                                     "sweep_s16_b512"])
def test_sound_run_passes_and_the_control_fails(traffic):
    run = small_run(traffic)
    assert passes(drive(run))
    assert run.attempted > 0 and run.failed == 0
    cfg = small_config()
    control = run.check(msg_bits=cfg["msg_bits"] - 1,
                        bits_llr=cfg["bits_llr"] - 1)
    assert not passes(control), control
    # each number has a reading from the control above the sound run's 0
    if traffic == "sweep_s16_b512":
        assert all(c["value"] > 0 for c in control), control

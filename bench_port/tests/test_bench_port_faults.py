"""A run on the CPU with its timed path broken underneath comes out as not
correct: a decode that returns its input state unchanged, half of the
batch left out (its answers, or its counts, taken from the other half),
one answer altered where it is produced (a bit, ``iters_used``, an LLR of
the sweep's channel).  The cells run on one card,
so no exchange between cards can be left out."""

import pytest
import torch

from bench_port.common import passes

from ._small import drive, small_run


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _unchanged(dec):
    def f(llr):
        bits, iters = dec(llr)
        return (llr > 0).to(torch.uint8), iters
    return f


def _half(dec):
    def f(llr):
        h = llr.shape[0] // 2
        bits, iters = dec(llr[:h].contiguous())
        return torch.cat([bits, bits[: llr.shape[0] - h]]), iters
    return f


def _altered(dec):
    def f(llr):
        bits, iters = dec(llr)
        bits = bits.clone()
        bits[0, 0] ^= 1
        return bits, iters
    return f


def _wrong_iters(dec):
    def f(llr):
        bits, iters = dec(llr)
        return bits, iters - 1
    return f


def _half_counts(count):
    def f(decoded, reference=None, info_only=False, k=None):
        h = decoded.shape[0] // 2
        be, fe = count(decoded[:h], reference, info_only, k)
        return be * 2, fe * 2
    return f


@pytest.mark.parametrize("traffic", ["decode_b8192", "block_b128",
                                     "sweep_s16_b512"])
@pytest.mark.parametrize("fault", [_unchanged, _half, _altered])
def test_broken_decode_is_not_correct(monkeypatch, traffic, fault):
    import ldpcgputegra_tpu_torch.decoder as decoder
    import ldpcgputegra_tpu_torch.sim.sweep as sweep

    made = decoder.make_decoder

    def broken(*a, **k):
        return fault(made(*a, **k))

    monkeypatch.setattr(decoder, "make_decoder", broken)
    monkeypatch.setattr(sweep, "make_decoder", broken)
    run = small_run(traffic)
    assert not passes(drive(run))


@pytest.mark.parametrize("traffic", ["decode_b8192", "block_b128"])
def test_wrong_iters_used_is_not_correct(monkeypatch, traffic):
    import ldpcgputegra_tpu_torch.decoder as decoder

    made = decoder.make_decoder
    monkeypatch.setattr(decoder, "make_decoder",
                        lambda *a, **k: _wrong_iters(made(*a, **k)))
    assert not passes(drive(small_run(traffic)))


def test_sweep_with_an_altered_llr_is_not_correct(monkeypatch):
    from ldpcgputegra_tpu_torch.channel.awgn import AwgnChannel

    made = AwgnChannel.generate_zero_int8

    def altered(self, gen, batch):
        llr = made(self, gen, batch).clone()
        llr[0, 0] = -llr[0, 0] if llr[0, 0] else 1
        return llr

    monkeypatch.setattr(AwgnChannel, "generate_zero_int8", altered)
    run = small_run("sweep_s16_b512")
    numbers = drive(run)
    assert not passes(numbers)
    assert {c["name"]: c["value"] for c in numbers}["llr_mismatch"] > 0


def test_sweep_counting_half_the_batch_is_not_correct(monkeypatch):
    import ldpcgputegra_tpu_torch.sim.sweep as sweep

    monkeypatch.setattr(sweep, "count_errors_async",
                        _half_counts(sweep.count_errors_async))
    assert not passes(drive(small_run("sweep_s16_b512")))

"""The ``coded_sweep`` kind on the CPU at a small size: the cell's
configuration (the DVB-S2 short frame at rate 2/3, its table encoder) at
4 iterations, 6 frames a batch, 2 batches a group.  A sound run passes;
the control (one message bit and one LLR bit less) does not, by each of
its LLRs and counts; a fault planted in the program's encoder is caught
by ``codeword_mismatch``.  The readers of the coded forms' rooflines read
their kernels by name, and nothing where those did not run."""

import types

import pytest
import torch

from bench_port import cell
from bench_port.common import passes

from ._small import ROOT, drive

CELL = "dvbs2_16200x10800.coded_b512"


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def small_coded_run(seed: int = 2**31 + 9):
    bench = cell.load_benchmark(ROOT)
    w = cell.workload(bench, CELL)
    cfg = dict(cell.load_config(bench, w["config"], ROOT), iters=4)
    tr = dict(cell.load_traffic(w["traffic"], ROOT), batch=6, scan_steps=2,
              ebn0_db=1.6)
    return cell.load_kind(tr["kind"], ROOT)(cfg, tr, seed, "cpu", ROOT)


def _numbers(numbers):
    return {c["name"]: c["value"] for c in numbers}


def test_sound_run_passes_and_the_control_fails():
    run = small_coded_run()
    numbers = drive(run)
    assert passes(numbers), numbers
    assert set(_numbers(numbers)) == {"codeword_mismatch", "llr_mismatch",
                                      "count_mismatch"}
    assert run.attempted > 0 and run.failed == 0 and run.checked >= 1
    assert run.layer["counted_cols"] == 10800
    assert run.cfg.encoder == "table" and run.cfg.count_bits == "info"
    cfg = run.config
    control = _numbers(run.check(msg_bits=cfg["msg_bits"] - 1,
                                 bits_llr=cfg["bits_llr"] - 1))
    assert control["codeword_mismatch"] == 0  # the reference's own
    assert control["llr_mismatch"] > 0 and control["count_mismatch"] > 0


def test_a_planted_encoder_fault_is_caught(monkeypatch):
    from ldpcgputegra_tpu_torch.channel.encoder import QCAccumulateEncoder

    made = QCAccumulateEncoder._encode

    def flipped(self, info_bits):
        cw = made(self, info_bits).clone()
        cw[0, -1] ^= 1  # one parity bit of the first frame
        return cw

    monkeypatch.setattr(QCAccumulateEncoder, "_encode", flipped)
    numbers = drive(small_coded_run())
    assert not passes(numbers)
    assert _numbers(numbers)["codeword_mismatch"] > 0


@pytest.mark.parametrize("metric,kernel,nbytes", [
    ("awgn_quantize_roofline", "awgn_quantize_coded_kernel", 512 * 16200 * 6),
    ("count_errors_roofline", "count_errors_ref_kernel", 512 * 10800 * 2)])
def test_the_coded_forms_rooflines(metric, kernel, nbytes):
    read = cell.load_reader(metric, ROOT)
    calls = {"void (anonymous namespace)::" + kernel + "(int)": [4e-5, 2],
             "void (anonymous namespace)::awgn_quantize_kernel(int)": [1.0, 9],
             "void (anonymous namespace)::count_errors_kernel<true>(int)":
                 [1.0, 9]}

    def timeline(kernels):
        def kern(part):
            hits = [v for k, v in kernels.items() if part in k]
            return sum(v[0] for v in hits), sum(v[1] for v in hits)
        return types.SimpleNamespace(kernel=kern)

    layer = {"batch": 512, "n": 16200, "counted_cols": 10800}
    got = read(types.SimpleNamespace(timeline=timeline(calls), layer=layer))
    assert got == pytest.approx(100.0 * nbytes / 3.35e12 / 2e-5)
    del calls["void (anonymous namespace)::" + kernel + "(int)"]
    assert read(types.SimpleNamespace(timeline=timeline(calls),
                                      layer=layer)) is None
    assert read(types.SimpleNamespace(timeline=None, layer=layer)) is None

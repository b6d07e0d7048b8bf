"""The channel's and the count's kernels (``kernels/channel.py``,
``csrc/channel_count.cu``) on the CPU, without a card and without JAX:
which calls take them (``AwgnChannel.generate_zero_int8`` and
``generate_int8`` of a plain AWGN spec on a CUDA device,
``count_errors_async`` of any CUDA tensor, against the all-zero codeword
or against a reference), that every other spec and every CPU tensor keep
the chain of PyTorch operations, that a CPU sweep never reaches the
kernels, the plain versions (of the all-zero codeword and of coded bits)
against that chain, the wrappers' checks, the rows the count's kernel
reads in each layout, alone and beside a reference, and the C entries'
arguments against the wrapper's.  The kernels themselves are held to the chain on the card
(``tests/test_torch_cuda_channel.py``).
"""

import os
import re

import numpy as np
import pytest
import torch

from ldpcgputegra_tpu_torch.channel.awgn import AwgnChannel, ChannelSpec
from ldpcgputegra_tpu_torch.kernels import _lib
from ldpcgputegra_tpu_torch.kernels import channel as C
from ldpcgputegra_tpu_torch.quant import QuantSpec
from ldpcgputegra_tpu_torch.sim.analyzer import count_errors_async


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def no_kernels(monkeypatch):
    """Every way into the kernels raises: the wrappers, their launch and
    the library's build."""
    def refuse(*args, **kwargs):
        raise AssertionError("a kernel of channel_count.cu was reached")

    for name in ("awgn_quantize", "count_errors", "_launch"):
        monkeypatch.setattr(C, name, refuse)
    monkeypatch.setattr(_lib, "build_library", refuse)


# (spec, taken on a CUDA device)
SPECS = [
    (ChannelSpec(), True),
    (ChannelSpec(qpsk=True), True),
    (ChannelSpec(es_n0=True), True),
    (ChannelSpec(opt_llr=True), True),
    (ChannelSpec(quant=QuantSpec(factor=5, bits_llr=8)), True),
    (ChannelSpec(fading="rayleigh"), False),
    (ChannelSpec(normalize=True), False),
    (ChannelSpec(no_channel=True), False),
    (ChannelSpec(inject_flip_p=0.01), False),
]


@pytest.mark.parametrize("spec,fused", SPECS)
def test_channel_rule(spec, fused):
    """The one-kernel path is a CUDA device and plain AWGN; a CPU channel
    never takes it."""
    ch = AwgnChannel(576, 288, spec, device="cpu")
    assert not ch._fused()
    ch.device = torch.device("cuda", 0)
    assert ch._fused() is fused


def _chain(ch, seed, batch):
    """The chain of PyTorch operations: ``generate_int8`` of the zero
    codeword."""
    zeros = torch.zeros((batch, ch.n), dtype=torch.int8)
    return ch.generate_int8(ch.generator(seed), zeros)


@pytest.mark.parametrize("spec", [s for s, _ in SPECS])
def test_cpu_channel_keeps_the_chain(spec, no_kernels):
    ch = AwgnChannel(576, 288, spec, device="cpu")
    ch.configure(1.5)
    assert torch.equal(ch.generate_zero_int8(ch.generator(9), 16),
                       _chain(ch, 9, 16))


@pytest.mark.parametrize("qpsk", [False, True])
@pytest.mark.parametrize("ebn0", [-2.0, 0.0, 2.0, 6.0])
@pytest.mark.parametrize("opt_llr", [False, True])
def test_plain_version_is_the_chain(qpsk, ebn0, opt_llr):
    """``awgn_quantize_plain`` (and the wrapper on a CPU tensor) on the
    chain's own draw gives the chain's bytes; the clamp engages on both
    sides at -2 dB."""
    spec = ChannelSpec(qpsk=qpsk, opt_llr=opt_llr)
    ch = AwgnChannel(1944, 972, spec, device="cpu")
    ch.configure(ebn0)
    noise = torch.randn((40, 1944), generator=ch.generator(5))
    amp = 1.0 / np.sqrt(2.0) if qpsk else 1.0
    sat = spec.quant.sat
    want = _chain(ch, 5, 40)
    assert torch.equal(C.awgn_quantize_plain(noise, amp, ch._scalars, sat),
                       want)
    assert torch.equal(C.awgn_quantize(noise, amp, ch._scalars, sat), want)
    if ebn0 == -2.0 and not opt_llr:
        assert int(want.max()) == sat and int(want.min()) == -sat


def test_plain_version_is_float32_op_by_op():
    """The plain version rounds each of its float32 operations on its own,
    as the kernel's __fmul_rn and __fadd_rn do: numpy in float32, one
    operation at a time, gives the same bytes, also at values just beside
    each quantizer step."""
    rng = np.random.default_rng(3)
    sigma, factor, amp = np.float32(0.8413), np.float32(8.0), np.float32(1.0)
    n = rng.standard_normal(200_000).astype(np.float32)
    steps = ((np.arange(-40, 41) / 8.0 + 1.0) / sigma).astype(np.float32)
    n = np.concatenate([n, steps, np.nextafter(steps, np.float32(0)),
                        np.nextafter(steps, np.float32(9))])
    y = np.float32(-amp) + sigma * n
    q = np.clip(y * factor, np.float32(-31), np.float32(31))
    want = np.trunc(q).astype(np.int8)
    scalars = torch.tensor([sigma, factor, 0.0], dtype=torch.float32)
    got = C.awgn_quantize_plain(torch.from_numpy(n), float(amp), scalars, 31)
    np.testing.assert_array_equal(got.numpy(), want)


class _OnCard:
    """A CPU tensor that says it lies on the card: the count's rule reads
    its device, shape, layout and type, and the chain computes on it."""

    def __init__(self, t):
        self.t = t
        self.device = torch.device("cuda", 0)
        self.dtype, self.shape = t.dtype, t.shape

    def dim(self):
        return self.t.dim()

    def is_contiguous(self):
        return self.t.is_contiguous()

    def __ne__(self, other):
        return self.t != other


def _bytes(shape, seed, high=2):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, high, shape, dtype=np.uint8))


@pytest.mark.parametrize("info_only,k,cols", [(False, None, 96),
                                              (True, 40, 40),
                                              (True, 500, 96),
                                              (True, None, 96),
                                              (False, 40, 96)])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.int8, torch.bool])
def test_count_rule_takes_the_kernel(monkeypatch, info_only, k, cols, dtype):
    """Bytes on the card, no reference: the kernel, over the first ``k``
    columns with ``info_only``."""
    seen = []

    def fake(decoded, n, reference=None):
        assert reference is None
        seen.append(n)
        return torch.tensor([7, 3])

    monkeypatch.setattr(C, "count_errors", fake)
    be, fe = count_errors_async(_OnCard(_bytes((12, 96), 1).to(dtype)),
                                info_only=info_only, k=k)
    assert seen == [cols] and (int(be), int(fe)) == (7, 3)
    assert be.dim() == 0 and be.dtype == torch.int64


@pytest.mark.parametrize("case", ["reference", "cpu"])
def test_count_rule_keeps_the_chain(no_kernels, case):
    """Frames on the CPU, with a reference (of another type) or without
    one: the chain."""
    x = _bytes((12, 96), 2)
    ref = _bytes((12, 96), 3).to(torch.int32) if case == "reference" else None
    err = x != 0 if ref is None else x != ref
    per = err.sum(dim=1)
    want = (int(per.sum()), int((per != 0).sum()))
    be, fe = count_errors_async(x, reference=ref)
    assert (int(be), int(fe)) == want


@pytest.mark.parametrize("case", ["3-D", "strided", "bool", "int32"])
def test_count_rule_on_the_card(monkeypatch, case):
    """Every tensor on the card with no reference goes to the kernel's
    wrapper, whatever its layout and type: the wrapper reads or copies
    the layout, and raises on what it cannot count; nothing on the card
    takes the chain."""
    x = _bytes((12, 96), 2)
    if case == "3-D":
        x = x.view(12, 8, 12)
    elif case == "strided":
        x = _bytes((12, 192), 2)[:, ::2]
    elif case == "bool":
        x = x.bool()
    elif case == "int32":
        x = x.to(torch.int32)
    seen = []

    def fake(decoded, n, reference=None):
        assert reference is None
        seen.append((decoded.t, n))
        return torch.tensor([1, 1])

    monkeypatch.setattr(C, "count_errors", fake)
    count_errors_async(_OnCard(x), info_only=True, k=10)
    assert len(seen) == 1 and seen[0][0] is x and seen[0][1] == 10


def _read(rows, stride, shape, cols):
    """The bytes the count's kernel reads: ``shape[0]`` rows ``stride``
    bytes apart from ``rows``' first byte, the first ``cols`` of each."""
    return rows.as_strided((shape[0], cols), (stride, 1))


@pytest.mark.parametrize("case", ["contiguous", "info", "offset", "one-row",
                                  "columns", "transposed", "expanded",
                                  "bool", "int8"])
def test_count_rows_of_each_layout(case):
    """``_byte_rows``: uint8 rows of unit column stride and their row
    stride, read in place where the rows lie apart in memory (the first k
    columns, a view off the row's start, one row; bool and int8 as bytes),
    else from a contiguous copy (every other column, a transpose, rows
    broadcast from one); the kernel's reads are the frames' bytes."""
    big = _bytes((12, 96), 9, high=256)
    x, cols, in_place = big, 96, True
    if case == "info":
        x, cols = big[:, :40], 40
    elif case == "offset":
        x, cols = big[:, 3:], 50
    elif case == "one-row":
        x, cols = big[5:6, 7:], 60
    elif case == "columns":
        x, in_place = _bytes((12, 192), 9)[:, ::2], False
    elif case == "transposed":
        x, cols, in_place = _bytes((96, 12), 9).t(), 90, False
    elif case == "expanded":
        x, in_place = big[:1].expand(12, 96), False
    elif case == "bool":
        x = big > 100
    elif case == "int8":
        x = big.view(torch.int8)
    rows, stride = C._byte_rows(x)
    assert rows.dtype == torch.uint8 and rows.shape == x.shape
    assert (rows.data_ptr() == x.data_ptr()) is in_place
    assert rows.shape[1] <= 1 or rows.stride(1) == 1
    assert x.shape[0] == 1 or stride == rows.stride(0) >= rows.shape[1]
    got = _read(rows, stride, x.shape, cols)
    assert torch.equal(got, x[:, :cols].view(torch.uint8))
    assert torch.equal(C.count_errors_plain(got, cols),
                       C.count_errors_plain(x, cols))


@pytest.mark.parametrize("case", ["01", "bytes", "zero", "one", "info",
                                  "ragged", "int8"])
def test_count_plain_is_the_chain(case):
    """``count_errors_plain`` (and the wrapper on a CPU tensor) against
    ``count_errors_async``'s chain: random 0/1 bytes, other nonzero bytes,
    all-zero and all-one frames, the first k columns, a ragged batch."""
    B, N, cols = 33, 1944, 1944
    x = _bytes((B, N), 4)
    if case == "bytes":
        x = _bytes((B, N), 5, high=256) * (_bytes((B, N), 6) > 0)
    elif case == "zero":
        x = torch.zeros((B, N), dtype=torch.uint8)
    elif case == "one":
        x = torch.ones((B, N), dtype=torch.uint8)
        x[::3] = 0
    elif case == "info":
        cols = 972
    elif case == "ragged":
        x, cols = _bytes((7, 1943), 7), 1943
    elif case == "int8":
        x = (_bytes((B, N), 8, high=256) - 128).to(torch.int8)
    be, fe = count_errors_async(x, info_only=True, k=cols)
    want = torch.stack([be, fe])
    assert torch.equal(C.count_errors_plain(x, cols), want)
    assert torch.equal(C.count_errors(x, cols), want)


def test_wrappers_check_their_inputs():
    s = torch.tensor([0.5, 8.0, 0.0])
    with pytest.raises(TypeError):
        C.awgn_quantize(torch.zeros(4, dtype=torch.float64), 1.0, s, 31)
    with pytest.raises(TypeError):
        C.awgn_quantize(torch.zeros(4), 1.0, s[:1], 31)
    with pytest.raises(TypeError):
        C.awgn_quantize(torch.zeros(4), 1.0, s.double(), 31)
    with pytest.raises(TypeError):
        C.count_errors(torch.zeros((2, 4), dtype=torch.int32), 4)
    with pytest.raises(TypeError):
        C.count_errors(torch.zeros((2, 4), dtype=torch.float32), 4)
    with pytest.raises(ValueError):
        C.count_errors(torch.zeros(4, dtype=torch.uint8), 4)
    with pytest.raises(ValueError):
        C.count_errors(torch.zeros((2, 2, 4), dtype=torch.uint8), 4)
    with pytest.raises(ValueError):
        C.count_errors(torch.zeros((2, 4), dtype=torch.uint8), 5)
    # a reference of another type or shape than the frames'
    u8 = torch.zeros((2, 4), dtype=torch.uint8)
    for ref in (u8.to(torch.int8), u8.to(torch.int32), u8[:1], u8.numpy()):
        with pytest.raises(TypeError):
            C.count_errors(u8, 4, ref)
    meta = torch.empty((2, 4), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        C.count_errors(meta, 4)
    with pytest.raises(ValueError, match="no kernel"):
        C.count_errors(meta.bool(), 4)


def test_cpu_sweep_never_launches(no_kernels):
    """A CPU sweep, graphed-step loop included, runs the chain with every
    way into the kernels refusing, and counts no launch."""
    from ldpcgputegra_tpu_torch.sim.sweep import SweepConfig, run_sweep

    before = dict(C.launches)
    res = run_sweep(SweepConfig(code="576x288", iters=3, snr_min=1.0,
                                snr_max=1.0, batch=32, max_frames=4 * 32,
                                max_fe=10**9, auto_fe=False, scan_steps=2,
                                device="cpu"), progress=False)
    assert res.points[0].frames >= 4 * 32 and res.points[0].be > 0
    assert C.launches == before


def test_scan_counts_the_channel_launches():
    """``sim/scan.py`` takes the channel's counter back after a capture and
    adds its launches at each replay, as it does the decoders'."""
    from ldpcgputegra_tpu_torch.sim import scan

    assert any(c is C.launches for c in scan._launch_counters())


def test_scan_replayed_reads_each_counter_by_identity():
    """``ScanSteps.replayed`` gives a counter's own launches a replay,
    wherever the counter lies among the launch counters, and raises for
    a dict that is not one of them."""
    from ldpcgputegra_tpu_torch.channel import encoder as E
    from ldpcgputegra_tpu_torch.sim import scan

    steps = scan.ScanSteps(lambda g: torch.zeros(2), 2, "cpu")
    with pytest.raises(KeyError):
        steps.replayed(C.launches)
    counters = scan._launch_counters()
    steps.per_replay = [{"at": i} for i in range(len(counters))]
    for c in (C.launches, E.encodes):
        i = next(i for i, x in enumerate(counters) if x is c)
        assert steps.replayed(c) == {"at": i}
    with pytest.raises(KeyError):
        steps.replayed(dict(C.launches))


def _entry_params(src, name):
    m = re.search(rf"int {name}\((.*?)\)\s*\{{", src, re.S)
    return [p.strip().split()[-1].lstrip("*") for p in m.group(1).split(",")]


def test_c_entries_match_the_wrapper():
    """Each C entry of ``channel_count.cu`` takes as many arguments as the
    wrapper declares, the stream last; no kernel name
    holds ``_minsum`` (the benchmark's readers count those as decode
    time)."""
    with open(C.SOURCE) as f:
        src = f.read()
    for fn in ("awgn_quantize_launch", "awgn_quantize_coded_launch",
               "count_errors_launch", "count_errors_ref_launch"):
        params = _entry_params(src, fn)
        assert len(params) == len(C._FUNCTIONS[fn][0]), (fn, params)
        assert params[-1] == "stream", params
    kernels = re.findall(r"^(\w+_kernel)\(", src, re.M)
    assert kernels == ["awgn_quantize_kernel", "awgn_quantize_coded_kernel",
                       "count_errors_kernel", "count_errors_ref_kernel"], \
        kernels
    assert "_minsum" not in src
    # no header of its own: the decode libraries' hashes do not move
    assert not re.search(r'#include "', src)
    assert os.path.dirname(C.SOURCE) == _lib.CSRC


# ------------------------------------------------------- the coded forms --

def _coded_chain(ch, seed, bits):
    """The chain of PyTorch operations for coded bits: ``generate_float``
    then the quantizer, as ``generate_int8`` runs them off the kernel."""
    from ldpcgputegra_tpu_torch.channel.awgn import _quantize

    gen = ch.generator(seed)
    return _quantize(gen, ch.generate_float(gen, bits), ch._scalars[1],
                     ch.spec)


@pytest.mark.parametrize("qpsk", [False, True])
@pytest.mark.parametrize("ebn0", [-2.0, 2.0])
@pytest.mark.parametrize("dtype", [torch.int8, torch.uint8, torch.bool,
                                   torch.int32])
def test_coded_plain_version_is_the_chain(qpsk, ebn0, dtype):
    """``awgn_quantize_plain`` with coded bits (and the wrapper on a CPU
    tensor) on the chain's own draw gives the chain's bytes: +amp for a 1,
    -amp for a 0, the same float order; the CPU channel keeps the chain."""
    ch = AwgnChannel(1944, 972, ChannelSpec(qpsk=qpsk), device="cpu")
    ch.configure(ebn0)
    bits = _bytes((40, 1944), 11).to(dtype)
    noise = torch.randn((40, 1944), generator=ch.generator(5))
    amp = 1.0 / np.sqrt(2.0) if qpsk else 1.0
    sat = ch.spec.quant.sat
    want = _coded_chain(ch, 5, bits)
    assert torch.equal(ch.generate_int8(ch.generator(5), bits), want)
    assert torch.equal(C.awgn_quantize_plain(noise, amp, ch._scalars, sat,
                                             bits), want)
    assert torch.equal(C.awgn_quantize(noise, amp, ch._scalars, sat, bits),
                       want)
    # a 1 and a 0 under the same noise give LLRs of the two symbols
    zero = C.awgn_quantize_plain(noise, amp, ch._scalars, sat)
    assert torch.equal(want[bits == 0], zero[bits == 0])


@pytest.mark.parametrize("spec,fused", SPECS)
def test_coded_channel_rule(monkeypatch, spec, fused):
    """``generate_int8`` takes the coded kernel where ``generate_zero_int8``
    takes the zero one: on a fused CUDA channel one ``randn`` draw of the
    bits' shape from the generator given, and the draw and the bits go to
    ``awgn_quantize``."""
    seen, drawn = [], []

    def fake(noise, amp, scalars, sat, bits=None):
        seen.append((noise, amp, sat, bits))
        return "llr"

    def randn(shape, generator=None, device=None):
        drawn.append((tuple(shape), generator, device))
        return torch.zeros(shape)

    ch = AwgnChannel(576, 288, spec, device="cpu")
    ch.configure(1.5)
    ch.device = torch.device("cuda", 0)
    assert ch._fused() is fused
    if not fused:
        return
    monkeypatch.setattr(C, "awgn_quantize", fake)
    monkeypatch.setattr(torch, "randn", randn)
    bits = _bytes((6, 576), 12)

    class Sent:  # coded bits that move to the card as ``bits``
        def to(self, device):
            assert device == ch.device
            return bits

    gen = object()
    assert ch.generate_int8(gen, Sent()) == "llr"
    assert drawn == [((6, 576), gen, ch.device)]
    ((noise, amp, sat, got),) = seen
    assert got is bits and noise.shape == (6, 576) and sat == spec.quant.sat
    assert amp == (1.0 / np.sqrt(2.0) if spec.qpsk else 1.0)


@pytest.mark.parametrize("dtype", [torch.uint8, torch.int8, torch.bool])
@pytest.mark.parametrize("info_only,k,cols", [(False, None, 96),
                                              (True, 40, 40)])
def test_count_rule_takes_the_kernel_with_a_reference(monkeypatch, dtype,
                                                      info_only, k, cols):
    """Frames on the card and any reference: the kernel's wrapper, given
    the reference as it came (the wrapper raises on one that is not of
    the frames' type, shape and device); nothing on the card takes the
    chain."""
    seen = []

    def fake(decoded, n, reference=None):
        seen.append((decoded, n, reference))
        return torch.tensor([5, 2])

    monkeypatch.setattr(C, "count_errors", fake)
    x = _OnCard(_bytes((12, 96), 1).to(dtype))
    ref = _OnCard(_bytes((12, 96), 2).to(dtype))
    other = _bytes((12, 96), 2).to(torch.int32)  # another type and device
    wide = _OnCard(x.t.to(torch.int32))  # frames of four bytes a bit
    for frames, r in ((x, ref), (x, other), (wide, _OnCard(other))):
        be, fe = count_errors_async(frames, reference=r, info_only=info_only,
                                    k=k)
        assert seen[-1][0] is frames and seen[-1][1:] == (cols, r)
        assert (int(be), int(fe)) == (5, 2)
    assert len(seen) == 3


@pytest.mark.parametrize("case", ["01", "bytes", "info", "ragged", "int8",
                                  "bool"])
def test_count_plain_with_a_reference_is_the_chain(case):
    """``count_errors_plain`` (and the wrapper on a CPU tensor) against a
    reference: the bytes that differ, as ``count_errors_async``'s chain
    counts them."""
    B, N, cols = 33, 1944, 1944
    x, ref = _bytes((B, N), 4), _bytes((B, N), 14)
    if case == "bytes":
        x, ref = _bytes((B, N), 5, high=256), _bytes((B, N), 15, high=256)
    elif case == "info":
        cols = 972
    elif case == "ragged":
        x, ref, cols = _bytes((7, 1943), 7), _bytes((7, 1943), 17), 1943
    elif case == "int8":
        x = (_bytes((B, N), 8, high=256) - 128).to(torch.int8)
        ref = (_bytes((B, N), 18, high=256) - 128).to(torch.int8)
    elif case == "bool":
        x, ref = x.bool(), ref.bool()
    err = (x != ref)[:, :cols].sum(1)
    want = torch.stack([err.sum(), (err != 0).sum()])
    assert torch.equal(C.count_errors_plain(x, cols, ref), want)
    assert torch.equal(C.count_errors(x, cols, ref), want)
    be, fe = count_errors_async(x, reference=ref, info_only=True, k=cols)
    assert torch.equal(torch.stack([be, fe]), want)


@pytest.mark.parametrize("case", ["same", "info", "offset", "stride",
                                  "one-row", "columns"])
def test_count_row_pairs(case):
    """``_byte_row_pair``: the frames and the reference read in place
    where each reference row lies at its frame row's offset from a 16-byte
    boundary, else fresh copies of the counted columns of both; the bytes
    the kernel reads are the frames' and the reference's."""
    big = _bytes((12, 128), 21, high=256)
    rbig = _bytes((12, 128), 22, high=256)
    x, ref, cols, in_place = big[:, :96], rbig[:, :96], 96, True
    if case == "info":
        cols = 40
    elif case == "offset":  # both 3 bytes off a boundary
        x, ref = big[:, 3:99], rbig[:, 3:99]
    elif case == "stride":  # rows 128 and 96 bytes apart: 32 = 0 mod 16
        ref = _bytes((12, 96), 23)
    elif case == "one-row":
        x, ref, in_place = big[:1, 5:101], rbig[:1, :96], False
    elif case == "columns":  # the reference's rows 100 bytes apart
        ref, in_place = _bytes((12, 100), 24)[:, :96], False
    rows, stride, rrows, rstride = C._byte_row_pair(x, ref, cols)
    assert (rows.data_ptr() == x.data_ptr()) is in_place
    assert (rows.data_ptr() - rrows.data_ptr()) % 16 == 0
    assert x.shape[0] == 1 or (stride - rstride) % 16 == 0
    got = _read(rows, stride, x.shape, cols)
    assert torch.equal(got, x[:, :cols])
    assert torch.equal(_read(rrows, rstride, x.shape, cols), ref[:, :cols])

"""The channel's and the count's kernels on the card (``kernels/channel.py``,
``csrc/channel_count.cu``) against the chain of PyTorch operations they
replace: ``awgn_quantize`` through ``AwgnChannel.generate_zero_int8`` and,
for coded bits, ``generate_int8`` byte for byte on the same seed, with the
generator left where the chain leaves it; ``count_errors`` through
``count_errors_async`` on every kind of frame and every layout of the
frames, with and without a reference; a CUDA graph of sweep batches (the
all-zero codeword, and coded batches with the info bits' draw and the
encoder) against eager ones, with the kernels' launches and the encodes
counted at each replay and not at the capture; the SASS of both forms of
``awgn_quantize`` free of fused multiply-adds.  Every test here needs an
NVIDIA GPU and skips without one.

On a machine with a card (and without jax, which ``tests/conftest.py``
imports), run:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_channel.py -q
"""

import numpy as np
import pytest
import torch

from ldpcgputegra_tpu_torch.channel.awgn import AwgnChannel, ChannelSpec
from ldpcgputegra_tpu_torch.kernels import channel as C
from ldpcgputegra_tpu_torch.quant import QuantSpec
from ldpcgputegra_tpu_torch.sim.analyzer import count_errors_async

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    C.build()
    return torch.device("cuda", 0)


def _chain(ch, gen, batch):
    zeros = torch.zeros((batch, ch.n), dtype=torch.int8, device=ch.device)
    return ch.generate_int8(gen, zeros)


@pytest.mark.parametrize("n,k,batch", [(64800, 32400, 5), (4000, 2000, 33),
                                       (1944, 972, 7)])
@pytest.mark.parametrize("ebn0", [-2.0, 0.0, 2.0, 6.0])
@pytest.mark.parametrize("qpsk", [False, True])
@pytest.mark.parametrize("seed", [11, 2**31 + 5])
def test_awgn_quantize_equals_the_chain(dev, n, k, batch, ebn0, qpsk, seed):
    """The kernel's LLRs are the chain's, byte for byte, and each path
    leaves its generator where the other does; the clamp engages on both
    sides at -2 dB."""
    ch = AwgnChannel(n, k, ChannelSpec(qpsk=qpsk), device=dev)
    ch.configure(ebn0)
    g1, g2 = ch.generator(seed), ch.generator(seed)
    before = C.launches["awgn_quantize"]
    got = ch.generate_zero_int8(g1, batch)
    assert C.launches["awgn_quantize"] == before + 1
    want = _chain(ch, g2, batch)
    assert got.dtype == torch.int8 and got.shape == (batch, n)
    assert torch.equal(got, want)
    assert torch.equal(torch.randn(1000, generator=g1, device=dev),
                       torch.randn(1000, generator=g2, device=dev))
    if ebn0 == -2.0 and n == 64800:
        sat = ch.spec.quant.sat
        assert int(got.max()) == sat and int(got.min()) == -sat


@pytest.mark.parametrize("spec", [ChannelSpec(opt_llr=True),
                                  ChannelSpec(es_n0=True, qpsk=True),
                                  ChannelSpec(quant=QuantSpec(factor=5,
                                                              bits_llr=8))])
def test_awgn_quantize_other_quantizers(dev, spec):
    """A factor that is no power of two (``opt_llr``, 5) and 8-bit LLRs."""
    ch = AwgnChannel(1944, 972, spec, device=dev)
    ch.configure(1.0)
    got = ch.generate_zero_int8(ch.generator(3), 64)
    assert torch.equal(got, _chain(ch, ch.generator(3), 64))


def test_awgn_quantize_against_its_plain_version(dev):
    """The wrapper on the card against its plain version on the card, at
    an element count that is no multiple of 16 (the scalar tail)."""
    ch = AwgnChannel(1944, 972, device=dev)
    ch.configure(0.5)
    noise = torch.randn(1000003, device=dev,
                        generator=ch.generator(8)) * 3.0
    for amp in (1.0, 1.0 / np.sqrt(2.0)):
        assert torch.equal(C.awgn_quantize(noise, amp, ch._scalars, 31),
                           C.awgn_quantize_plain(noise, amp, ch._scalars, 31))


def test_awgn_quantize_reads_the_scalars_when_it_runs(dev):
    """sigma and the factor are read from the device when the kernel runs:
    a graph captured at one SNR point serves another."""
    ch = AwgnChannel(4000, 2000, device=dev)
    ch.configure(0.0)
    graph = torch.cuda.CUDAGraph()
    gen = ch.generator(0)
    graph.register_generator_state(gen)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        ch.generate_zero_int8(ch.generator(0), 16)  # the library, loaded
        graph.capture_begin()
        out = ch.generate_zero_int8(gen, 16)
        graph.capture_end()
    torch.cuda.current_stream(dev).wait_stream(side)
    for ebn0 in (0.0, 3.0):
        ch.configure(ebn0)
        gen.manual_seed(21)
        graph.replay()
        assert torch.equal(out, _chain(ch, ch.generator(21), 16))


def _frames(case, B, N, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    if case == "01":
        return torch.randint(0, 2, (B, N), dtype=torch.uint8, device="cuda",
                             generator=g)
    if case == "bytes":
        x = torch.randint(0, 256, (B, N), dtype=torch.uint8, device="cuda",
                          generator=g)
        return x * (torch.rand((B, N), device="cuda", generator=g) < 0.01)
    if case == "zero":
        return torch.zeros((B, N), dtype=torch.uint8, device="cuda")
    if case == "one":
        x = torch.ones((B, N), dtype=torch.uint8, device="cuda")
        x[::2] = 0
        return x
    if case == "int8":
        return torch.randint(-128, 128, (B, N), dtype=torch.int8,
                             device="cuda", generator=g)
    if case == "sparse":  # one error in a few frames, at the row's ends
        x = torch.zeros((B, N), dtype=torch.uint8, device="cuda")
        x[1, 0] = x[2, N - 1] = x[B - 1, N // 2] = 1
        return x
    raise ValueError(case)


CASES = ["01", "bytes", "zero", "one", "int8", "sparse"]


@pytest.mark.parametrize("B,N", [(512, 64800), (4096, 4000), (37, 1944),
                                 (3, 7), (65, 1943)])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("info_only", [False, True])
def test_count_errors_equals_the_chain(dev, B, N, case, info_only):
    """``count_errors_async`` through the kernel against the chain of
    PyTorch operations on the same frames (on the CPU, where the chain
    runs): all of each row, or its first k = N/2 columns."""
    x = _frames(case, B, N, B + N)
    k = N // 2
    before = C.launches["count_errors"]
    got = torch.stack(count_errors_async(x, info_only=info_only, k=k))
    assert C.launches["count_errors"] == before + 1
    want = torch.stack(count_errors_async(x.cpu(), info_only=info_only,
                                          k=k))
    assert got.dtype == torch.int64 and torch.equal(got.cpu(), want)


@pytest.mark.parametrize("offset", [1, 5, 15])
def test_count_errors_rows_off_a_boundary(dev, offset):
    """Frames that start off a 16-byte boundary (a contiguous view into a
    larger buffer): the bytes before the first boundary and after the
    last one of each row."""
    B, N = 19, 1000
    buf = _frames("01", 1, B * N + 16, offset)
    x = buf.view(-1)[offset:offset + B * N].view(B, N)
    assert x.is_contiguous() and x.data_ptr() % 16 == offset
    got = torch.stack(count_errors_async(x)).cpu()
    assert torch.equal(got, C.count_errors_plain(x.cpu(), N))


@pytest.mark.parametrize("case", ["info", "offset", "one-row", "columns",
                                  "transposed", "expanded", "bool"])
def test_count_errors_of_each_layout(dev, case):
    """Frames in any layout count through the kernel, one launch each, as
    the chain counts them on the CPU: rows that lie apart in memory (the
    first k columns, a view off the row's start, one row) read in place,
    other layouts (every other column, a transpose, one row broadcast)
    copied; bool frames read as bytes."""
    B, N = 37, 1944
    big = _frames("bytes", B, N + 16, 41)
    x, k = big[:, :N], N // 2
    if case == "offset":
        x = big[:, 5:5 + N]
    elif case == "one-row":
        x = big[3:4, 7:7 + N]
    elif case == "columns":
        x = _frames("01", B, 2 * N, 42)[:, ::2]
    elif case == "transposed":
        x = _frames("01", N, B, 43).t()
    elif case == "expanded":
        x = big[1:2, :N].expand(B, N)
    elif case == "bool":
        x = _frames("01", B, N, 44).bool()
    for info_only in (False, True):
        before = C.launches["count_errors"]
        got = torch.stack(count_errors_async(x, info_only=info_only, k=k))
        assert C.launches["count_errors"] == before + 1
        want = torch.stack(count_errors_async(x.cpu(), info_only=info_only,
                                              k=k))
        assert torch.equal(got.cpu(), want), (case, info_only)


@pytest.mark.parametrize("what", ["3-D", "int32"])
def test_count_errors_refuses_what_it_cannot_count(dev, what):
    """On the card, frames the kernel cannot count raise: no chain of
    PyTorch operations runs in its place."""
    x = _frames("01", 12, 96, 45)
    x = x.view(12, 8, 12) if what == "3-D" else x.to(torch.int32)
    with pytest.raises((TypeError, ValueError)):
        count_errors_async(x)


@pytest.mark.parametrize("what", ["int32", "int8", "rows", "cpu"])
def test_count_errors_refuses_a_reference_it_cannot_count(dev, what):
    """On the card, a reference of another type, shape or device than the
    frames' raises: no chain of PyTorch operations runs in its place."""
    x = _frames("01", 12, 96, 46)
    ref = _frames("01", 12, 96, 47)
    ref = {"int32": lambda r: r.to(torch.int32),
           "int8": lambda r: r.to(torch.int8), "rows": lambda r: r[:6],
           "cpu": lambda r: r.cpu()}[what](ref)
    with pytest.raises(TypeError):
        count_errors_async(x, reference=ref, info_only=True, k=48)


def test_graph_replay_counts_launches(dev):
    """A CUDA graph of S sweep batches (channel, decode, count) gives the
    eager batches' counts; each replay adds S launches of each kernel,
    the capture none (its warm-up batch, eager, one)."""
    from ldpcgputegra_tpu_torch.codes.registry import load_code
    from ldpcgputegra_tpu_torch.decoder import make_decoder
    from ldpcgputegra_tpu_torch.ops.layered import LayeredSpec
    from ldpcgputegra_tpu_torch.sim.scan import ScanSteps

    code, B, S = load_code("4000x2000"), 256, 3
    chan = AwgnChannel(code.N, code.K, device=dev)
    chan.configure(1.5)
    dec = make_decoder(code, LayeredSpec(algo="OMS", iters=5,
                                         early_term=True), device=dev)

    def step(g):
        return torch.stack(count_errors_async(
            dec(chan.generate_zero_int8(g, B))[0]))

    scan = ScanSteps(step, S, dev)
    zero = ("awgn_quantize", "count_errors")
    for i, seeds in enumerate(([5, 6, 7], [9, 5, 8])):
        before = dict(C.launches)
        out = scan(seeds)
        torch.cuda.synchronize()
        ran = {k: C.launches[k] - before[k] for k in before}
        assert ran == {k: (S + (i == 0)) * (k in zero) for k in before}, ran
        eager = torch.stack([step(chan.generator(s)) for s in seeds])
        assert torch.equal(out, eager)
        assert int(out[:, 1].sum()) > 0  # frames fail at 1.5 dB
    assert scan.replayed(C.launches) == {
        "awgn_quantize": S, "count_errors": S, "awgn_quantize_coded": 0,
        "count_errors_ref": 0}


def test_awgn_quantize_sass_has_no_ffma(dev):
    """Each multiply and add of the channel is rounded on its own."""
    from ldpcgputegra_tpu_torch.bench import sass

    ops = sass.opcodes(C.build()["path"], "awgn_quantize_kernel")
    assert ops and not any(o.startswith("FFMA") for o in ops), ops


def test_awgn_quantize_coded_sass_has_no_ffma(dev):
    """The coded form rounds each multiply and add on its own too."""
    from ldpcgputegra_tpu_torch.bench import sass

    ops = sass.opcodes(C.build()["path"], "awgn_quantize_coded_kernel")
    assert ops and not any(o.startswith("FFMA") for o in ops), ops


def _coded_chain(ch, gen, bits):
    """The chain of PyTorch operations for coded bits on the card."""
    from ldpcgputegra_tpu_torch.channel.awgn import _quantize

    return _quantize(gen, ch.generate_float(gen, bits), ch._scalars[1],
                     ch.spec)


@pytest.mark.parametrize("n,k,batch", [(16200, 10800, 5), (4000, 2000, 33),
                                       (1944, 972, 7)])
@pytest.mark.parametrize("ebn0", [-2.0, 2.0])
@pytest.mark.parametrize("qpsk", [False, True])
@pytest.mark.parametrize("seed", [12, 2**31 + 6])
def test_awgn_quantize_coded_equals_the_chain(dev, n, k, batch, ebn0, qpsk,
                                              seed):
    """``generate_int8`` of random coded bits through the kernel gives the
    chain's bytes, and each path leaves its generator where the other
    does."""
    ch = AwgnChannel(n, k, ChannelSpec(qpsk=qpsk), device=dev)
    ch.configure(ebn0)
    bits = torch.randint(0, 2, (batch, n), dtype=torch.int8, device=dev,
                         generator=ch.generator(seed + 1))
    g1, g2 = ch.generator(seed), ch.generator(seed)
    before = dict(C.launches)
    got = ch.generate_int8(g1, bits)
    ran = {k: C.launches[k] - before[k] for k in before}
    assert ran == {"awgn_quantize": 0, "count_errors": 0,
                   "awgn_quantize_coded": 1, "count_errors_ref": 0}, ran
    want = _coded_chain(ch, g2, bits)
    assert got.dtype == torch.int8 and torch.equal(got, want)
    assert torch.equal(torch.randn(1000, generator=g1, device=dev),
                       torch.randn(1000, generator=g2, device=dev))
    if ebn0 == -2.0 and n == 16200:
        sat = ch.spec.quant.sat
        assert int(got.max()) == sat and int(got.min()) == -sat


@pytest.mark.parametrize("case", ["uint8", "bool", "int32", "columns",
                                  "offset", "tail"])
def test_awgn_quantize_coded_of_each_kind_of_bits(dev, case):
    """Bits of every type and layout the chain takes give its bytes: one
    byte a bit read in place where it lies on a boundary, anything else
    copied first; an element count that is no multiple of 16."""
    n, batch = 1944, 9
    if case == "tail":
        n = 1943
    ch = AwgnChannel(n, n // 2, device=dev)
    ch.configure(1.0)
    bits = torch.randint(0, 2, (batch, n), dtype=torch.int8, device=dev,
                         generator=ch.generator(31))
    if case == "uint8":
        bits = bits.to(torch.uint8)
    elif case == "bool":
        bits = bits.bool()
    elif case == "int32":
        bits = bits.to(torch.int32) * 7
    elif case == "columns":
        bits = torch.randint(0, 2, (batch, 2 * n), dtype=torch.int8,
                             device=dev, generator=ch.generator(32))[:, ::2]
    elif case == "offset":
        bits = torch.randint(0, 2, (batch * n + 3,), dtype=torch.int8,
                             device=dev, generator=ch.generator(33))
        bits = bits[3:].view(batch, n)
    got = ch.generate_int8(ch.generator(34), bits)
    assert torch.equal(got, _coded_chain(ch, ch.generator(34), bits))


def _counted_chain(x, ref, info_only, k):
    return torch.stack(count_errors_async(x.cpu(), reference=ref.cpu(),
                                          info_only=info_only, k=k))


@pytest.mark.parametrize("case", ["contiguous", "info", "offset", "one-row",
                                  "columns", "transposed", "expanded",
                                  "bool", "misaligned"])
def test_count_errors_ref_of_each_layout(dev, case):
    """Frames and a reference of the same type and shape in any layout
    count through the kernel, one launch each, as the chain counts them
    on the CPU; a reference whose rows lie at other offsets from a 16-byte
    boundary than the frames' rows is copied with them."""
    B, N = 37, 1944
    big = _frames("bytes", B, N + 16, 51)
    rbig = _frames("01", B, N + 16, 52)
    x, ref, k = big[:, :N], rbig[:, :N], N // 2
    if case == "contiguous":
        x, ref = _frames("01", B, N, 53), _frames("01", B, N, 54)
    elif case == "offset":
        x, ref = big[:, 5:5 + N], rbig[:, 5:5 + N]
    elif case == "one-row":
        x, ref = big[3:4, 7:7 + N], rbig[3:4, 7:7 + N]
    elif case == "columns":
        x = _frames("01", B, 2 * N, 55)[:, ::2]
        ref = _frames("01", B, 2 * N, 56)[:, ::2]
    elif case == "transposed":
        x, ref = _frames("01", N, B, 57).t(), _frames("01", N, B, 58).t()
    elif case == "expanded":
        x, ref = big[1:2, :N].expand(B, N), rbig[2:3, :N].expand(B, N)
    elif case == "bool":
        x, ref = _frames("01", B, N, 59).bool(), _frames("01", B, N, 60).bool()
    elif case == "misaligned":
        x, ref = big[:, 5:5 + N], rbig[:, 2:2 + N]
    for info_only in (False, True):
        before = C.launches["count_errors_ref"]
        got = torch.stack(count_errors_async(x, reference=ref,
                                             info_only=info_only, k=k))
        assert C.launches["count_errors_ref"] == before + 1
        assert torch.equal(got.cpu(), _counted_chain(x, ref, info_only, k)), \
            (case, info_only)


@pytest.mark.parametrize("B,N", [(512, 16200), (512, 64800), (4096, 4000),
                                 (3, 7), (65, 1943)])
def test_count_errors_ref_equals_the_chain(dev, B, N):
    """Decoded-like frames against the bits sent, at the sweep's shapes
    and ragged ones: all of each row, or its first k = N * 2 / 3."""
    x = _frames("01", B, N, B + N)
    ref = x.clone()
    flip = _frames("sparse", B, N, 1)
    ref[flip != 0] ^= 1
    ref[B // 2] ^= 1
    k = 2 * N // 3
    for info_only in (False, True):
        got = torch.stack(count_errors_async(x, reference=ref,
                                             info_only=info_only, k=k))
        assert torch.equal(got.cpu(), _counted_chain(x, ref, info_only, k))


def test_coded_graph_counts_launches_and_encodes(dev):
    """A CUDA graph of S coded sweep batches (the info bits' draw, the
    table encoder, the coded channel, K2, the count against the bits
    sent) gives the eager batches' counts, bit for bit; each replay adds
    S launches of the coded forms and of K2 and S table encodes, and no
    launch of the zero forms."""
    from ldpcgputegra_tpu_torch.channel import encoder as E
    from ldpcgputegra_tpu_torch.channel.bitgen import generate_info_bits
    from ldpcgputegra_tpu_torch.codes.registry import load_code
    from ldpcgputegra_tpu_torch.decoder import make_decoder
    from ldpcgputegra_tpu_torch.kernels import streamed
    from ldpcgputegra_tpu_torch.ops.layered import LayeredSpec
    from ldpcgputegra_tpu_torch.sim.scan import ScanSteps

    code, B, S = load_code("16200x10800"), 128, 3
    chan = AwgnChannel(code.N, code.K, device=dev)
    chan.configure(2.2)
    enc = E.make_encoder(code, "table")
    dec = make_decoder(code, LayeredSpec(algo="OMS", iters=10,
                                         early_term=True), device=dev)

    def step(g):
        coded = enc.encode(generate_info_bits(g, B, code.K))
        decoded, _ = dec(chan.generate_int8(g, coded))
        return torch.stack(count_errors_async(
            decoded, reference=coded.view(torch.uint8), info_only=True,
            k=code.K))

    scan = ScanSteps(step, S, dev)
    for i, seeds in enumerate(([5, 6, 7], [9, 5, 8])):
        before = dict(C.launches)
        k2, n_enc = streamed.launches["streamed_minsum"], dict(E.encodes)
        out = scan(seeds)
        torch.cuda.synchronize()
        ran = {k: C.launches[k] - before[k] for k in before}
        n = S + (i == 0)  # the capture's warm-up batch, eager
        assert ran == {"awgn_quantize": 0, "count_errors": 0,
                       "awgn_quantize_coded": n, "count_errors_ref": n}, ran
        assert streamed.launches["streamed_minsum"] - k2 == n
        assert {k: E.encodes[k] - n_enc[k] for k in n_enc} == {
            "fake": 0, "table": n, "staircase": 0, "gf2": 0}
        eager = torch.stack([step(chan.generator(s)) for s in seeds])
        assert torch.equal(out, eager)
        assert int(out[:, 1].sum()) > 0  # frames fail at 2.2 dB
    assert scan.replayed(C.launches) == {
        "awgn_quantize": 0, "count_errors": 0, "awgn_quantize_coded": S,
        "count_errors_ref": S}
    assert scan.replayed(E.encodes) == {"fake": 0, "table": S,
                                        "staircase": 0, "gf2": 0}


@pytest.mark.parametrize("code,encoder", [("16200x10800", "table"),
                                          ("576x288", "gf2")])
def test_coded_sweep_graphed_equals_eager(dev, code, encoder):
    """``run_sweep`` on the coded path: the same counters at scan_steps 1
    (eager batches) and 4 (graph replays) over the same batches."""
    from ldpcgputegra_tpu_torch.sim.sweep import SweepConfig, run_sweep

    kw = dict(code=code, encoder=encoder, count_bits="info", iters=10,
              snr_min=2.0, snr_max=2.4, snr_step=0.4, batch=128,
              max_fe=10**9, auto_fe=False, max_frames=8 * 128,
              pipeline_depth=1, device="cuda")
    a = run_sweep(SweepConfig(**kw), progress=False).points
    before = C.launches["awgn_quantize_coded"]
    b = run_sweep(SweepConfig(scan_steps=4, **kw), progress=False).points
    assert [(p.frames, p.be, p.fe) for p in a] == [
        (p.frames, p.be, p.fe) for p in b]
    assert any(p.fe > 0 for p in a)
    # two points, 8 batches each, and each graph's warm-up batch
    assert C.launches["awgn_quantize_coded"] - before == 2 * 8 + 1

"""The port's quantizer (bit-exact) and AWGN channel (statistical) against
the JAX package's."""

import math

import jax
import numpy as np
import pytest
import torch

from ldpcgputegra_tpu.channel.awgn import AwgnChannel as JChannel
from ldpcgputegra_tpu.channel.awgn import sigma_for_snr as j_sigma
from ldpcgputegra_tpu.quant import QuantSpec as JQuant
from ldpcgputegra_tpu.quant import dequantize_llr as j_dequantize
from ldpcgputegra_tpu.quant import optimal_llr_factor as j_opt
from ldpcgputegra_tpu.quant import quantize_llr as j_quantize
from ldpcgputegra_tpu_torch.channel.awgn import AwgnChannel, ChannelSpec, sigma_for_snr
from ldpcgputegra_tpu_torch.quant import (
    QuantSpec,
    dequantize_llr,
    llr_histogram,
    optimal_llr_factor,
    quantize_llr,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the cores, and the
    many small tensor ops here run far slower on a pool of threads that
    competes with them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _edge_floats(factor: float, sat: int) -> np.ndarray:
    """±0, each integer step k/factor, the float just under it (toward
    zero), values beyond saturation, ±inf, plus random floats."""
    steps = np.arange(-sat - 3, sat + 4, dtype=np.float64) / factor
    steps = steps.astype(np.float32)
    under = np.nextafter(steps, np.float32(0)).astype(np.float32)
    away = np.where(steps >= 0, np.inf, -np.inf).astype(np.float32)
    over = np.nextafter(steps, away).astype(np.float32)
    special = np.array([0.0, -0.0, 1e6, -1e6, 3.4e38, -3.4e38, np.inf,
                        -np.inf, 1e-30, -1e-30], dtype=np.float32)
    rnd = np.random.default_rng(0).normal(0.0, 3.0, 100_000).astype(np.float32)
    return np.concatenate([steps, under, over, special, rnd])


@pytest.mark.parametrize("bits_llr,factor", [(6, None), (8, None), (6, 5.37),
                                             (5, 2.0)])
def test_quantizer_bit_exact(bits_llr, factor):
    f = 8.0 if factor is None else factor
    x = _edge_floats(f, (1 << (bits_llr - 1)) - 1)
    got = quantize_llr(torch.from_numpy(x), QuantSpec(bits_llr=bits_llr),
                       factor).numpy()
    ref = np.asarray(j_quantize(jax.numpy.asarray(x), JQuant(bits_llr=bits_llr), factor))
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, ref)


def test_quant_helpers_match_reference():
    for sigma in (0.3, 0.7, 1.2):
        for bits in (4, 6, 8):
            assert optimal_llr_factor(sigma, QuantSpec(bits_llr=bits)) == \
                j_opt(sigma, JQuant(bits_llr=bits))
    q = np.arange(-31, 32, dtype=np.int8)
    np.testing.assert_array_equal(dequantize_llr(torch.from_numpy(q)).numpy(),
                                  np.asarray(j_dequantize(q)))
    h = llr_histogram(torch.from_numpy(q))
    assert len(h) == 63 and abs(sum(h.values()) - 100.0) < 1e-9


@pytest.mark.parametrize("es_n0,qpsk", [(False, False), (True, False),
                                        (True, True)])
def test_sigma_matches_reference(es_n0, qpsk):
    for snr in (-1.0, 0.5, 2.25, 6.0):
        for rate in (0.5, 0.6, 5 / 6):
            assert sigma_for_snr(snr, rate, es_n0, qpsk) == j_sigma(
                snr, rate, es_n0, qpsk)


def test_noise_std_within_one_percent():
    ch = AwgnChannel(1024, 512)
    sigma = ch.configure(1.5)
    y = ch.generate_float(ch.generator(3), torch.zeros((1024, 1024),
                                                       dtype=torch.int8))
    noise = (y + 1.0).double()  # 2^20 samples
    assert abs(float(noise.std()) / sigma - 1.0) < 0.01
    assert abs(float(noise.mean())) < 4 * sigma / 1024


@pytest.mark.parametrize("snr", [0.5, 2.0])
def test_raw_hard_error_rate_matches_jax_channel(snr):
    """Quantized LLRs > 0 are raw bit errors on the all-zero codeword; the
    port's rate is within 4 binomial sigma of the JAX channel's."""
    n, batch = 1944, 540  # 1,049,760 samples each
    ch = AwgnChannel(n, 972)
    ch.configure(snr)
    q = ch.generate_zero_int8(ch.generator(11), batch)
    jch = JChannel(n, 972)
    jch.configure(snr)
    jq = np.asarray(jch.generate_zero_int8(jax.random.key(11), batch))
    m = n * batch
    p_port = float((q > 0).sum()) / m
    p_jax = float((jq > 0).sum()) / m
    p = 0.5 * (p_port + p_jax)
    assert abs(p_port - p_jax) < 4 * math.sqrt(2 * p * (1 - p) / m)


def test_channel_modes():
    zeros = torch.zeros((256, 1024), dtype=torch.int8)
    ones = torch.ones((256, 1024), dtype=torch.int8)
    n = zeros.numel()
    # noiseless: exact BPSK symbols, quantized to ±factor
    ch = AwgnChannel(1024, 512, ChannelSpec(no_channel=True))
    ch.configure(1.0)
    g = ch.generator(0)
    assert torch.equal(ch.generate_int8(g, zeros),
                       torch.full_like(zeros, -8))
    assert torch.equal(ch.generate_int8(g, ones), torch.full_like(ones, 8))
    # QPSK amplitude 1/sqrt(2)
    ch = AwgnChannel(1024, 512, ChannelSpec(qpsk=True))
    s = ch.configure(1.0)
    y = ch.generate_float(ch.generator(1), zeros).double()
    assert abs(float(y.mean()) + 1 / math.sqrt(2)) < 4 * s / math.sqrt(n)
    # Rayleigh: E[h^2] = 1, so the mean stays -1
    ch = AwgnChannel(1024, 512, ChannelSpec(fading="rayleigh"))
    ch.configure(3.0)
    y = ch.generate_float(ch.generator(2), zeros).double()
    assert abs(float(y.mean()) + 1.0) < 4 * float(y.std()) / math.sqrt(n)
    # normalization by 2/sigma^2
    ch = AwgnChannel(1024, 512, ChannelSpec(normalize=True))
    s = ch.configure(2.0)
    y = ch.generate_float(ch.generator(4), zeros).double()
    assert abs(float(y.mean()) + 2 / s**2) < 4 * (2 / s) / math.sqrt(n)
    # sign-flip injection: the flipped share is p within 4 binomial sigma
    p = 0.1
    ch = AwgnChannel(1024, 512, ChannelSpec(no_channel=True, inject_flip_p=p))
    ch.configure(1.0)
    q = ch.generate_int8(ch.generator(5), zeros)
    share = float((q > 0).double().mean())
    assert abs(share - p) < 4 * math.sqrt(p * (1 - p) / n)
    # the sigma-adaptive quantizer scale
    ch = AwgnChannel(1024, 512, ChannelSpec(opt_llr=True))
    s = ch.configure(1.0)
    assert ch.factor == optimal_llr_factor(s)


def test_same_seed_same_frames():
    ch = AwgnChannel(576, 288)
    ch.configure(1.0)
    a = ch.generate_zero_int8(ch.generator(42), 8)
    b = ch.generate_zero_int8(ch.generator(42), 8)
    c = ch.generate_zero_int8(ch.generator(43), 8)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.shape == (8, 576) and a.dtype == torch.int8
    assert int(a.abs().max()) <= 31
    with pytest.raises(RuntimeError):
        AwgnChannel(576, 288).generate_zero_int8(ch.generator(0), 1)

"""Why the coded-info twin's BER runs above the zero-info twin's at equal
FER: the same NumPy info bits and float noise through both packages
(encode, BPSK map, ``quantize_llr``, decode, count the info bits), then
the sign-flipped all-zero twin of each frame (the LLR negated at the
codeword's ones).  Min-sum with these integer forms is sign-symmetric, so
``bits ^ c`` equals the twin's bits except where the final APP is 0, whose
hard decision is bit 0 (``ops/layered.py``, JAX ``ops/layered.py``): at a
codeword 1 that is an error the twin does not make.  Those positions are
the whole gap in bit errors.  ET off, OMS 10, exact everywhere."""

import numpy as np
import pytest
import torch

from ldpcgputegra_tpu.channel.encoder import make_encoder as j_make_encoder
from ldpcgputegra_tpu.codes.registry import load_code as j_load_code
from ldpcgputegra_tpu.decoder import make_decoder as j_make_decoder
from ldpcgputegra_tpu.ops.layered import LayeredSpec as JSpec
from ldpcgputegra_tpu.quant import quantize_llr as j_quantize_llr
from ldpcgputegra_tpu_torch.channel.awgn import sigma_for_snr
from ldpcgputegra_tpu_torch.channel.encoder import make_encoder
from ldpcgputegra_tpu_torch.codes.code import committed_edges
from ldpcgputegra_tpu_torch.codes.registry import load_code
from ldpcgputegra_tpu_torch.codes.schedule import build_layers
from ldpcgputegra_tpu_torch.decoder import make_decoder
from ldpcgputegra_tpu_torch.ops.layered import LayeredSpec, _layer_step
from ldpcgputegra_tpu_torch.quant import quantize_llr

SPEC = dict(algo="OMS", iters=10)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _final_app(code, llr: np.ndarray) -> np.ndarray:
    """The plain decoder's APP [B, N] after ``SPEC``'s iterations, by its
    own layer step (a code without a QC view's column permutation)."""
    spec = LayeredSpec(**SPEC)
    V = torch.from_numpy(llr).t().contiguous()
    idxs = [torch.as_tensor(committed_edges(lay)[0].T.astype(np.int64))
            for lay in build_layers(code, spec.schedule)]
    msgs = [torch.zeros((*i.shape, V.shape[1]), dtype=torch.int8)
            for i in idxs]
    for _ in range(spec.iters):
        for li, idx in enumerate(idxs):
            msgs[li], _ = _layer_step(V, msgs[li], idx, spec)
    return V.t().numpy()


# (code, encoder, Eb/N0 dB, frames): low SNR, so that frames fail
@pytest.mark.parametrize("name,kind,snr,B", [("576x288", "gf2", 1.5, 48),
                                             ("16200x10800", "table", 1.8, 3)])
def test_coded_info_gap_is_the_tie_at_app_zero(name, kind, snr, B):
    code, j_code = load_code(name), j_load_code(name)
    rng = np.random.default_rng(2026)
    info = rng.integers(0, 2, (B, code.K), dtype=np.int8)
    noise = rng.standard_normal((B, code.N)).astype(np.float32)
    c = make_encoder(code, kind).encode(torch.from_numpy(info)).numpy()
    np.testing.assert_array_equal(c, j_make_encoder(j_code, kind).encode(info))
    sigma = np.float32(sigma_for_snr(snr, code.rate))
    y = np.where(c != 0, 1.0, -1.0).astype(np.float32) + sigma * noise
    q = quantize_llr(torch.from_numpy(y)).numpy()
    np.testing.assert_array_equal(q, np.asarray(j_quantize_llr(y)))
    twin = np.where(c != 0, -q, q).astype(np.int8)

    dec = make_decoder(code, LayeredSpec(**SPEC), device="cpu")
    j_dec = j_make_decoder(j_code, JSpec(**SPEC))
    out = {}
    for label, llr in (("coded", q), ("twin", twin)):
        bits = dec(torch.from_numpy(llr))[0].numpy().astype(np.int8)
        np.testing.assert_array_equal(bits, np.asarray(j_dec(llr)[0]))
        out[label] = bits
    K = code.K
    err = (out["coded"] ^ c)[:, :K] != 0  # the sweep counts the first K
    t_err = out["twin"][:, :K] != 0
    be, fe = int(err.sum()), int(err.any(1).sum())
    t_be, t_fe = int(t_err.sum()), int(t_err.any(1).sum())
    assert fe == t_fe > 0
    # every position where the two decodes disagree is a codeword 1 that
    # the coded frame decided 0 and its twin decided 0 too
    diff = (out["coded"] ^ c) != out["twin"]
    assert diff.any()
    assert (c[diff] == 1).all() and not out["coded"][diff].any()
    assert not out["twin"][diff].any()
    assert be - t_be == int(diff[:, :K].sum()) > 0
    if code.col_perm is None and name == "576x288":
        app = _final_app(code, q)
        np.testing.assert_array_equal((app > 0).astype(np.int8), out["coded"])
        assert (app[diff] == 0).all()
        # and every APP of 0 at a codeword 1 is such a position
        np.testing.assert_array_equal(diff, (app == 0) & (c == 1))

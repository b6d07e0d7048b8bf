"""The ported JAX tools on the CPU, without JAX: ``bench/hw_validate.py``'s
pair logic and pairs, ``bench/et_skip_diag.py``'s clean inputs and ET
tiles, ``bench/profile_16200.py``'s perm-free twin, the convergence
statistics of ``bench/et_study.py``, ``bench/vectors_check.py`` and
``bench/encoder_matrix_check.py`` on the committed files and on tampered
copies, and each tool's refusal without a card.  Exact everywhere."""

import os
import shutil

import numpy as np
import pytest
import torch

from ldpcgputegra_tpu_torch.bench import (
    encoder_matrix_check,
    et_skip_diag,
    et_study,
    hw_validate,
    kernel_et,
    profile_16200,
    vectors_check,
)
from ldpcgputegra_tpu_torch.codes.registry import load_code
from ldpcgputegra_tpu_torch.decoder import (
    backend_for,
    effective_code,
    make_decoder,
)
from ldpcgputegra_tpu_torch.kernels import layered, streamed
from ldpcgputegra_tpu_torch.ops.layered import LayeredSpec


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _llrs(code, B, snr_db, seed):
    sigma = np.sqrt(10 ** (-0.1 * (snr_db + 10 * np.log10(code.rate))) / 2)
    rng = np.random.default_rng(seed)
    return torch.from_numpy(np.clip(
        8.0 * (-1.0 + sigma * rng.standard_normal((B, code.N))), -31,
        31).astype(np.int8))


# ------------------------------------------------------------ hw_validate --

def test_pair_of_plain_decoders_passes_and_a_flipped_bit_fails():
    code = load_code("576x288")
    spec = hw_validate.SPEC
    a = make_decoder(code, spec, device="cpu")
    b = make_decoder(code, spec, device="cpu")
    inputs = [_llrs(code, 16, 2.0, s) for s in range(2)]
    assert hw_validate.check_pair("576x288", "a", a, "b", b, inputs) == 2

    def flipped(x):
        bits, iters = b(x)
        bits = bits.clone()
        bits[3, 100] ^= 1
        return bits, iters

    with pytest.raises(SystemExit) as exc:
        hw_validate.check_pair("576x288", "a", a, "flipped", flipped, inputs)
    assert "a and flipped differ on input 0: 1 bits" in str(exc.value.code)


@pytest.mark.parametrize("quick", [False, True])
def test_every_pair_resolves_to_the_kernels_it_names(quick):
    # quick: what chip_smoke.py's phase 25 asks for
    which = {"streamed", "gather", "tail"} | (set() if quick else {"qc"})
    rows = hw_validate.pairs(which, quick)
    spec = hw_validate.SPEC
    for key, name, B, a, b in rows:
        code = load_code(name)
        view = effective_code(code)
        if (a, b) == ("cuda", "cuda-streamed"):
            # K1's own codes, K2 forced on them
            assert backend_for(code, spec, "cuda") == "cuda", name
            assert backend_for(code, spec, "cuda", "cuda-streamed") == b
            assert streamed.kernel_unsupported_reason(view, spec) is None
            assert streamed.variants(view), name
        elif key == "streamed":
            # QC views and synthqc: K1 refuses them, K2 against the plain
            assert (a, b) == ("cuda-streamed", "torch")
            assert backend_for(code, spec, "cuda") == a, name
            assert layered.kernel_unsupported_reason(view, spec) is not None
        else:
            assert b == "torch"
            assert backend_for(code, spec, "cuda") == a, name
            assert a == {"qc": "cuda", "gather": "cuda-gather"}.get(key, a)
            assert a.startswith("cuda"), (name, a)
    if quick:
        assert [(k, n, B) for k, n, B, *_ in rows] == [
            ("streamed", "2304x1152", 8192), ("streamed", "1944x972", 1024),
            ("tail", "155x93", 4096), ("gather", "4000x2000", 4096)]
    else:
        assert len(rows) == 3 + 3 + 3 + 15 + 4


# ----------------------------------------------------------- et_skip_diag --

@pytest.mark.parametrize("name", ["576x288", "4000x2000", "16200x7560"])
@pytest.mark.parametrize("algo,mc", [("2NMS", "post"), ("OMS", "pre")])
def test_clean_inputs_converge_in_one_iteration(name, algo, mc):
    code = load_code(name)
    spec = LayeredSpec(algo=algo, iters=10, minclamp=mc, early_term=True)
    dec = make_decoder(code, spec, device="cpu")
    for x in et_skip_diag.clean_inputs(code, 3, 2, "cpu"):
        assert x.dtype == torch.int8 and x.shape == (3, code.N)
        assert int(x.max()) <= -26 and int(x.min()) >= -30
        bits, iters = dec(x)
        assert not bits.any() and int(iters) == 1


def test_et_variants_pick_and_smallest_tile():
    want = {"576x288": ("tile 32", "tile 4"),
            "2304x1152": ("tile 16", "tile 4"),
            "64800x32400": ("smem/1/k1", "smem/1/k1"),
            "4000x2000": ("16/k2", "4/k2")}
    for name, B in et_skip_diag.CONFIGS:
        vs = et_skip_diag.et_variants(load_code(name), et_skip_diag.BASE, B,
                                      132)
        assert [(v[0], v[1]) for v in vs] == [("et_pick", want[name][0]),
                                              ("et_small", want[name][1])]
        with vs[1][2]():  # the forcing context enters and leaves
            pass


def test_write_section_replaces_in_place(tmp_path):
    path = str(tmp_path / "sub" / "ET.md")
    et_skip_diag.write_section(path, "One", "first\n")
    et_skip_diag.write_section(path, "Two", "second")
    et_skip_diag.write_section(path, "One", "first again")
    with open(path) as f:
        text = f.read()
    assert text == ("# Early termination on the card\n\n## One\n\nfirst again"
                    "\n\n## Two\n\nsecond\n")


def test_kernel_et_points():
    assert len(kernel_et.CONFIGS) == 17
    added = kernel_et.CONFIGS[13:]
    assert {(n, B, a) for n, B, _, a in added} == {
        ("64800x32400", 512, "OMS"), ("4000x2000", 4096, "OMS")}
    for name, _, _, algo in kernel_et.CONFIGS:
        assert backend_for(load_code(name), LayeredSpec(algo=algo),
                           "cuda") in et_skip_diag.KERNEL


# ---------------------------------------------------------- profile_16200 --

def test_perm_free_twin_runs_the_same_edge_updates():
    view = effective_code(load_code(profile_16200.NAME))
    assert view.col_perm is not None
    twin = profile_16200.perm_free_twin(view)
    assert twin.col_perm is None and twin.N == view.N
    spec = LayeredSpec(algo="OMS", iters=2)
    full = streamed.make_streamed_decoder(view, spec)
    bare = streamed.make_streamed_decoder(twin, spec)
    perm = torch.as_tensor(view.col_perm, dtype=torch.int64)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(view.N)
    llr = _llrs(view, 2, 2.5, seed=3)
    fb, fi = full(llr)
    tb, ti = bare(llr[:, perm].contiguous())
    assert torch.equal(tb[:, inv], fb) and int(ti) == int(fi) == 2


# ----------------------------------------------------- convergence stats --

def test_conv_only_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(et_study, "CONV_CONFIGS", [("576x288", 64, [3.0])])
    out = tmp_path / "ET_convergence.md"
    assert et_study.main(["--conv-only", "--device", "cpu", "--out",
                          str(out)]) == 0
    text = out.read_text()
    assert "| 576x288 | 2NMS | 3.0 | 64 |" in text
    assert "| 576x288 | OMS | 3.0 | 64 |" in text
    rows = [ln for ln in text.splitlines() if ln.startswith("| 576x288")]
    for ln in rows:
        p = [float(v) for v in ln.strip("|").split("|")[4:]]
        assert p == sorted(p) and 0 <= p[0] and p[-1] <= 1


def test_et_study_timing_needs_the_card():
    with pytest.raises(SystemExit) as exc:
        et_study.main(["--device", "cpu"])
    assert exc.value.code == 2


# --------------------------------------------------------- vectors_check --

def test_vectors_check_passes_on_the_committed_files():
    before = sorted(os.listdir(vectors_check.VECTORS))
    stamps = [os.stat(os.path.join(vectors_check.VECTORS, f)).st_mtime_ns
              for f in before]
    assert vectors_check.main(["--device", "cpu"]) == 0
    assert sorted(os.listdir(vectors_check.VECTORS)) == before
    assert [os.stat(os.path.join(vectors_check.VECTORS, f)).st_mtime_ns
            for f in before] == stamps


@pytest.mark.parametrize("case,key", [
    ("576x288_MS_5_post.npz", "bits"),
    ("576x288_NMS_5_post.npz", "iters_used"),
])
def test_vectors_check_names_a_tampered_case(tmp_path, case, key):
    for fn in os.listdir(vectors_check.VECTORS):
        shutil.copy(os.path.join(vectors_check.VECTORS, fn), tmp_path)
    with np.load(tmp_path / case) as d:
        arrays = dict(d)
    arrays[key] = arrays[key].copy()
    arrays[key].flat[5] ^= 1
    np.savez_compressed(tmp_path / case, **arrays)
    with pytest.raises(SystemExit) as exc:
        vectors_check.check(str(tmp_path), "cpu")
    assert f"{case}: {key} differs" in str(exc.value.code)


# -------------------------------------------------- encoder_matrix_check --

def test_encoder_matrix_check_passes_on_the_committed_npz():
    stamp = os.stat(encoder_matrix_check.NPZ).st_mtime_ns
    assert encoder_matrix_check.main(["--device", "cpu"]) == 0
    assert os.stat(encoder_matrix_check.NPZ).st_mtime_ns == stamp


@pytest.mark.parametrize("key", ["edges", "classes"])
def test_encoder_matrix_check_fails_on_a_tampered_npz(tmp_path, key):
    with np.load(encoder_matrix_check.NPZ) as d:
        arrays = dict(d)
    arrays[key] = arrays[key].copy()
    arrays[key].flat[1] += 1
    path = tmp_path / "16200x10800.npz"
    np.savez_compressed(path, **arrays)
    with pytest.raises(SystemExit) as exc:
        encoder_matrix_check.check(encoder_matrix_check.TABLE, str(path),
                                   "cpu")
    assert f"{key} of the derived matrix differs" in str(exc.value.code)


# ------------------------------------------------------ without a card --

@pytest.mark.parametrize("tool,argv", [
    (hw_validate, ["--quick"]), (et_skip_diag, ["--quick"]),
    (kernel_et, ["--quick"]), (profile_16200, ["--quick"]),
    (et_study, ["--conv-only"]), (vectors_check, []),
    (encoder_matrix_check, []),
])
def test_each_tool_refuses_without_a_card(tool, argv, tmp_path, monkeypatch,
                                          capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "out" / "OUT.md"
    if tool not in (vectors_check, encoder_matrix_check):
        argv = argv + ["--out", str(out)]
    assert tool.main(argv) == 1
    assert not (tmp_path / "out").exists() and not os.listdir(tmp_path)
    assert "no CUDA device" in capsys.readouterr().err

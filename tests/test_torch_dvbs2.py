"""The DVB-S2 path of the port on the CPU: the Z=360 QC views of the
staircase codes against the JAX package's, field by field; ``effective_code``;
the plain decoder on a view against the golden oracle run on the view's
own (permuted) schedule, bits exact; and the ``auto`` routing of every
registry code on a CUDA device (decided without a card).
"""

import numpy as np
import pytest
import torch

from ldpcgputegra_tpu.codes.code import DegreeClass as JDegreeClass
from ldpcgputegra_tpu.codes.code import LdpcCode as JLdpcCode
from ldpcgputegra_tpu.codes.dvbs2 import to_qc_form as j_to_qc_form
from ldpcgputegra_tpu.codes.registry import load_code as j_load_code
from ldpcgputegra_tpu.golden import GoldenParams, decode_oracle
from ldpcgputegra_tpu_torch.codes.code import committed_edges
from ldpcgputegra_tpu_torch.codes.convert import PINNED, edge_tables
from ldpcgputegra_tpu_torch.codes.dvbs2 import to_qc_form
from ldpcgputegra_tpu_torch.codes.registry import list_codes, load_code
from ldpcgputegra_tpu_torch.decoder import (
    backend_for,
    effective_code,
    make_decoder,
)
from ldpcgputegra_tpu_torch.kernels import gather as G
from ldpcgputegra_tpu_torch.kernels import layered as K
from ldpcgputegra_tpu_torch.kernels import streamed as S
from ldpcgputegra_tpu_torch.kernels._lib import SMEM_MAX
from ldpcgputegra_tpu_torch.ops.layered import LayeredSpec, make_layered_decoder


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the cores, and the
    many small tensor ops here run far slower on a pool of threads that
    competes with them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CUDA = torch.device("cuda")
STAIRCASE = ["16200x10800", "16200x7560", "64800x21600", "64800x32400",
             "64800x32400-dvbs2", "64800x6480-dvbs2", "64800x7200-dvbs2"]
SYNTHQC = "synthqc-256x128x6-z1024"


def _opt_equal(a, b):
    if a is None or b is None:
        assert a is None and b is None
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("name", STAIRCASE)
def test_qc_view_matches_jax(name):
    """Every field of the view: the layers (idx, edge_offset and the QC
    row's cols, shifts, mask_edge, mask_rows, commit_rows), classes,
    class_idx and col_perm."""
    view = to_qc_form(load_code(name))
    ref = j_to_qc_form(j_load_code(name))
    assert (view.name, view.N, view.K, view.Z) == (ref.name, ref.N, ref.K,
                                                   ref.Z)
    assert [(c.deg, c.count) for c in view.classes] == [
        (c.deg, c.count) for c in ref.classes]
    assert len(view.class_idx) == len(ref.class_idx)
    for a, b in zip(view.class_idx, ref.class_idx):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(view.col_perm, ref.col_perm)
    assert len(view.layers) == len(ref.layers)
    for a, b in zip(view.layers, ref.layers):
        np.testing.assert_array_equal(a.idx, b.idx)
        assert a.edge_offset == b.edge_offset
        np.testing.assert_array_equal(a.qc.cols, b.qc.cols)
        np.testing.assert_array_equal(a.qc.shifts, b.qc.shifts)
        assert a.qc.mask_edge == b.qc.mask_edge
        _opt_equal(a.qc.mask_rows, b.qc.mask_rows)
        _opt_equal(a.qc.commit_rows, b.qc.commit_rows)


def test_effective_code_passes_other_codes_and_caches_views():
    for name in ("1944x972", "4000x2000", SYNTHQC):
        code = load_code(name)
        assert effective_code(code) is code
    code = load_code("16200x7560")
    view = effective_code(code)
    assert view.Z == 360 and view.col_perm is not None
    assert view.name == "16200x7560-qc"
    assert effective_code(code) is view
    assert effective_code(view) is view


def test_streamed_tables_describe_the_committed_edges():
    """Per layer: only the committed checks, degree-major, the deficient
    edge as PINNED; every real edge of the view exactly once."""
    view = effective_code(load_code("16200x10800"))
    t = {k: v.numpy() for k, v in edge_tables(
        view, LayeredSpec(), "cpu").items()}
    assert t["vn"].dtype == np.int32
    np.testing.assert_array_equal(t["perm"], view.col_perm)
    assert (t["vn"] == PINNED).sum() == 1
    assert t["row_ptr"][-1] == view.M  # the real edges and the pinned one
    for l, lay in enumerate(view.layers):
        idx, pinned = committed_edges(lay)
        g, d = idx.shape
        assert (t["n_checks"][l], t["deg"][l]) == (g, d)
        e0 = t["row_ptr"][l]
        vn = t["vn"][e0:e0 + g * d].reshape(d, g)
        expect = idx.T.copy()
        if pinned is not None:
            expect[pinned.T] = PINNED
        np.testing.assert_array_equal(vn, expect)
        real = vn[vn != PINNED]
        assert np.unique(real).size == real.size  # conflict-free
    real = t["vn"][t["vn"] != PINNED]
    assert real.size == load_code("16200x10800").M == view.M - 1
    # each VN of the view has its base column's degree
    base_deg = np.bincount(load_code("16200x10800").edges, minlength=view.N)
    np.testing.assert_array_equal(np.bincount(real, minlength=view.N),
                                  base_deg[view.col_perm])


@pytest.mark.parametrize("name,schedule", [("4000x2000", "auto"),
                                           ("576x288", "colored"),
                                           ("1944x972", "auto")])
def test_edge_tables_narrow_and_wide_agree(name, schedule):
    """One builder for both kernels: on a code with no view, the gather
    kernel's uint16 ids and the streamed kernel's int32 ids name the same
    VNs in the same slots; narrow ids refuse a pinned edge."""
    code, spec = load_code(name), LayeredSpec(schedule=schedule)
    narrow = edge_tables(code, spec, "cpu", wide=False)
    wide = edge_tables(code, spec, "cpu")
    assert narrow["vn"].dtype == torch.int16 and wide["vn"].dtype == torch.int32
    for key in ("row_ptr", "n_checks", "deg", "perm"):
        assert torch.equal(narrow[key], wide[key])
    np.testing.assert_array_equal(narrow["vn"].numpy().view(np.uint16),
                                  wide["vn"].numpy())
    assert wide["perm"].numel() == 0
    with pytest.raises(ValueError, match="pinned"):
        edge_tables(effective_code(load_code("16200x7560")), LayeredSpec(),
                    "cpu", wide=False)


def _golden_view(qc):
    """A ragged code whose reference order IS the QC schedule — including
    sub-pass commit order — with the deficient edge truly absent (the JAX
    package's ``tests/test_dvbs2_qc.py`` helper)."""
    classes = []
    class_idx = []
    for lay in qc.layers:
        idx = lay.idx
        if lay.qc.commit_rows is not None:
            idx = idx[lay.qc.commit_rows]
        me = lay.qc.mask_edge
        has_row0 = (
            lay.qc.commit_rows is None or 0 in lay.qc.commit_rows.tolist()
        )
        if me is None or not has_row0:
            classes.append(JDegreeClass(idx.shape[1], idx.shape[0]))
            class_idx.append(idx)
        else:
            # this entry commits check 0, whose deficient edge is absent
            first = np.delete(idx[0], me)[None, :]
            classes.append(JDegreeClass(first.shape[1], 1))
            class_idx.append(first.astype(np.int32))
            classes.append(JDegreeClass(idx.shape[1], idx.shape[0] - 1))
            class_idx.append(idx[1:])
    return JLdpcCode(
        name=qc.name + "-golden",
        N=qc.N,
        K=qc.K,
        classes=tuple(classes),
        class_idx=tuple(class_idx),
    )


@pytest.mark.parametrize("name", ["16200x7560", "16200x10800"])
def test_plain_matches_golden_on_the_permuted_schedule(name):
    """B=4, OMS, 3 iterations, bits exact.  16200x10800's view has 34
    sub-pass layers; both have the deficient circulant and col_perm."""
    code = load_code(name)
    rng = np.random.default_rng(4)
    llr = np.clip(8.0 * rng.normal(-1.0, 0.7, size=(4, code.N)),
                  -31, 31).astype(np.int8)
    spec = LayeredSpec(algo="OMS", iters=3)
    bits, iters = make_decoder(code, spec, device="cpu")(torch.from_numpy(llr))
    view = to_qc_form(j_load_code(name))
    perm = view.col_perm
    inv = np.empty(code.N, np.int64)
    inv[perm] = np.arange(code.N)
    refs, _ = decode_oracle(_golden_view(view), llr[:, perm],
                            GoldenParams(algo="OMS", iters=3))
    np.testing.assert_array_equal(bits.numpy(), refs[:, inv])
    assert int(iters) == 3
    # the factory decodes the view: the same bits as the view's decoder
    vb, _ = make_layered_decoder(effective_code(code), spec)(
        torch.from_numpy(llr))
    assert torch.equal(vb, bits)


@pytest.mark.parametrize("name", ["16200x7560", "16200x10800"])
def test_et_stops_after_one_iteration_on_strong_llrs(name):
    code = load_code(name)
    strong = torch.full((3, code.N), -31, dtype=torch.int8)
    bits, iters = make_decoder(code, LayeredSpec(iters=6, early_term=True),
                               device="cpu")(strong)
    assert int(iters) == 1 and int(bits.sum()) == 0


def test_auto_routes_every_registry_code_to_a_kernel():
    """On a CUDA device every registry code and synthqc resolve; the 7
    staircase codes (their QC views) and synthqc take the streamed kernel.
    On the CPU ``auto`` stays torch."""
    spec = LayeredSpec()
    names = list_codes() + [SYNTHQC]
    routes = {n: backend_for(load_code(n), spec, CUDA) for n in names}
    assert {n for n, r in routes.items() if r == "cuda-streamed"} == set(
        STAIRCASE + [SYNTHQC])
    assert set(routes.values()) == {"cuda", "cuda-gather", "cuda-streamed"}
    for name in STAIRCASE + [SYNTHQC]:
        assert backend_for(load_code(name), spec, "cpu") == "torch"


def test_each_kernel_refuses_what_it_does_not_take():
    """``--backend cuda`` and ``--backend cuda-gather`` on a QC view raise
    their own reasons; the colored schedule of a staircase code raises with
    its reason; the streamed kernel walks any layers (a non-QC code, a QC
    code's colored schedule) up to degree 32."""
    view = effective_code(load_code("16200x7560"))
    with pytest.raises(NotImplementedError, match="QC view"):
        K.make_cuda_decoder(view, LayeredSpec())
    with pytest.raises(NotImplementedError, match="QC view"):
        G.make_gather_decoder(view, LayeredSpec())
    S.make_streamed_decoder(view, LayeredSpec())
    with pytest.raises(NotImplementedError, match="QC view"):
        make_decoder(load_code("16200x7560"), LayeredSpec(), backend="cuda",
                     device="cpu")
    with pytest.raises(NotImplementedError, match="spurious"):
        backend_for(load_code("16200x7560"), LayeredSpec(schedule="colored"),
                    CUDA)
    assert S.kernel_unsupported_reason(load_code("4000x2000"),
                                       LayeredSpec()) is None
    assert S.kernel_unsupported_reason(
        load_code("576x288"), LayeredSpec(schedule="colored")) is None
    assert "above 32" in S.kernel_unsupported_reason(
        load_code("synthqc-64x8x40-z8"), LayeredSpec())
    # synthqc is beyond both shared-memory kernels
    synth = load_code(SYNTHQC)
    assert "does not fit shared memory" in K.kernel_unsupported_reason(
        synth, LayeredSpec())
    assert "does not fit shared memory" in G.kernel_unsupported_reason(
        synth, LayeredSpec())


_SMEM, _DEV = "smem", "device"


@pytest.mark.parametrize("name,B,sms,variant", [
    ("64800x32400", 512, 132, (_SMEM, 1, 1)),
    ("64800x32400", 2048, 132, (_SMEM, 1, 1)),
    ("16200x7560", 1024, 132, (_SMEM, 2, 2)),
    ("64800x6480-dvbs2", 256, 132, (_SMEM, 1, 4)),
    ("64800x6480-dvbs2", 1024, 132, (_SMEM, 1, 4)),
    (SYNTHQC, 256, 132, (_DEV, 1, 1)),
    ("16200x7560", 9000, 132, (_SMEM, 2, 2)),
    ("64800x32400", 512, 114, (_SMEM, 1, 1)),
    ("16200x7560", 1024, 114, (_SMEM, 2, 2)),
    ("64800x6480-dvbs2", 256, 114, (_SMEM, 1, 4)),
])
def test_streamed_tile_fills_the_card_once(name, B, sms, variant):
    """The variant (APP placement, tile, lanes a check) of the least
    modelled cost, waves of CTAs on the card's own SMs (132 on an H100 SXM,
    114 on an H100 PCIe) x rounds of checks, each round charged for where
    its APP lives and for the edges a lane walks; the APP in shared memory
    wherever a tile of it fits."""
    code = effective_code(load_code(name))
    shapes = S.layer_shapes(code)
    v = S.pick_tile(code, B, sms)
    assert v == S.Variant(*variant)

    def cost(u):
        per_sm = S.ctas_per_sm(code, u)
        waves = -(-(-(-B // u.tile)) // (sms * per_sm))
        lanes = S.NTHREADS // (u.tile * u.k)
        return waves * sum(-(-g // lanes) * (S.ROUND_COST[u.placement]
                                             + S.EDGE_COST * -(-d // u.k))
                           for g, d in shapes)

    assert all(cost(v) <= cost(u) for u in S.variants(code))
    assert S.smem_bytes(code, v) <= SMEM_MAX
    if sms == S.SMS_H100:
        assert S.pick_tile(code, B) == v  # the default without a card


def test_cli_info_resolves_the_streamed_backend(capsys):
    from ldpcgputegra_tpu_torch.sim import cli

    cli.main(["--code", "64800x32400", "--info", "--device", "cuda",
              "--batch", "512"])
    out = capsys.readouterr().out
    assert "backend      : cuda-streamed" in out
    assert "105 (qc 105, sub-pass 23) of the QC view" in out
    assert ("1 codewords per CTA at batch 512 on 132 SMs, 1 lanes a check, "
            "APP in shared memory (64820 B shared memory a CTA)") in out
    cli.main(["--code", "64800x32400", "--info", "--device", "cpu"])
    assert "backend      : torch" in capsys.readouterr().out

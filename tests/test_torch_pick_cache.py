"""The kernel wrappers' lookup of their variant pick
(``kernels/_lib.py::cached_pick``): computed once a key ``(pick_tile, B,
SMs)`` and looked up after that; a module ``pick_tile`` replaced as
``bench/tiles.py`` forces a variant is a key of its own, and the pick made
before it comes back once it is restored; the span ``ldpc.decode.pick``
counts 1 where the pick was computed and 0 where it was looked up.  No
card needed: the wrappers pick only on the card, so this drives the
lookup with the modules' own picks and with stand-ins."""

import pytest
import torch

from ldpcgputegra_tpu_torch.bench import tiles
from ldpcgputegra_tpu_torch.codes.convert import layer_shapes
from ldpcgputegra_tpu_torch.codes.registry import load_code
from ldpcgputegra_tpu_torch.kernels import _lib
from ldpcgputegra_tpu_torch.kernels import gather as G
from ldpcgputegra_tpu_torch.kernels import layered as K
from ldpcgputegra_tpu_torch.kernels import streamed as S
from ldpcgputegra_tpu_torch.utils.profiling import span, spans


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def _picks(before: int) -> list:
    return [r for r in spans()[before:] if r.name == "ldpc.decode.pick"]


class _Counting:
    """A stand-in ``pick_tile`` that records the batches it was asked for
    and answers ``answer(B)``."""

    def __init__(self, answer):
        self.answer, self.seen = answer, []

    def __call__(self, code, B, sms, *args):
        self.seen.append((B, sms) + args)
        return self.answer(B)


@pytest.mark.parametrize("answer", [lambda B: B // 64, lambda B: 0,
                                    lambda B: None,
                                    lambda B: S.Variant("smem", 1, 1)],
                         ids=["tile", "zero", "none", "variant"])
def test_computes_once_per_key_and_looks_up_after(answer):
    """Batches (B1, B2, B1, B2) on one card compute two picks; a second
    card is a key of its own.  An answer of 0 or None is kept as well."""
    pick = _Counting(answer)
    picks = {}
    got = [_lib.cached_pick(picks, pick, None, B, 132, "auto")
           for B in (512, 128, 512, 128)]
    assert got == [answer(512), answer(128)] * 2
    assert pick.seen == [(512, 132, "auto"), (128, 132, "auto")]
    assert _lib.cached_pick(picks, pick, None, 512, 114, "auto") == answer(512)
    assert pick.seen[2:] == [(512, 114, "auto")]
    assert len(picks) == 3


def test_a_replaced_pick_tile_is_a_new_key():
    """A replaced ``pick_tile`` is computed anew under its own key;
    restoring the first brings its pick back without computing it."""
    natural = _Counting(lambda B: 8)
    forced = _Counting(lambda B: 32)
    picks = {}
    assert _lib.cached_pick(picks, natural, None, 1024, 132) == 8
    assert _lib.cached_pick(picks, forced, None, 1024, 132) == 32
    assert _lib.cached_pick(picks, forced, None, 1024, 132) == 32
    assert _lib.cached_pick(picks, natural, None, 1024, 132) == 8
    assert natural.seen == [(1024, 132)] and forced.seen == [(1024, 132)]


@pytest.mark.parametrize("miss_first", [True, False])
def test_span_counts_one_computed_zero_looked_up(miss_first):
    """Under a profiler the lookup records ``ldpc.decode.pick`` inside the
    caller's span: count 1 where the pick was computed, 0 where it was
    looked up.  With no profiler it records nothing."""
    pick = _Counting(lambda B: 4)
    picks = {}
    if not miss_first:
        before = len(spans())
        _lib.cached_pick(picks, pick, None, 64, 132)
        assert len(spans()) == before  # no profiler, no record
    before = len(spans())
    with _profile():
        with span("decode", count=64) as call:
            _lib.cached_pick(picks, pick, None, 64, 132)
        _lib.cached_pick(picks, pick, None, 64, 132)
        _lib.cached_pick(picks, pick, None, 32, 132)
    got = _picks(before)
    first = 1 if miss_first else 0
    assert [r.count for r in got] == [first, 0, 1]
    assert got[0].parent is call and got[1].parent is None
    assert call.start <= got[0].start <= got[0].end <= call.end
    assert len(pick.seen) == 2


def _case(kernel: str):
    """(module, code, the pick's arguments after (code, B, sms), forcing,
    a variant other than the natural pick at B=1024 on 132 SMs)."""
    if kernel == "layered":
        code = load_code("1944x972")
        return K, code, (), tiles.forced_layered, 32
    if kernel == "streamed":
        code = load_code("576x288")
        return (S, code, ("auto", layer_shapes(code, "auto")),
                tiles.forced_streamed, S.Variant("device", 32, 1))
    code = load_code("816x408")
    return (G, code, ("auto", layer_shapes(code, "auto")),
            tiles.forced_gather, G.Variant(32, 4))


@pytest.mark.parametrize("kernel", ["layered", "streamed", "gather"])
def test_lookup_gives_the_modules_pick(kernel):
    """Through the lookup each module's ``pick_tile`` gives what it gives
    called directly, at batches whose picks differ, once a key."""
    mod, code, args, _, _ = _case(kernel)
    picks = {}
    batches = (128, 1024, 8192, 128, 1024, 8192)
    before = len(spans())
    with _profile():
        got = [_lib.cached_pick(picks, mod.pick_tile, code, B, 132, *args)
               for B in batches]
    assert got == [mod.pick_tile(code, B, 132, *args) for B in batches]
    assert len(set(got)) > 1, "the batches must pick differently"
    assert [r.count for r in _picks(before)] == [1, 1, 1, 0, 0, 0]


@pytest.mark.parametrize("kernel", ["layered", "streamed", "gather"])
def test_forced_variant_after_a_cached_pick(kernel):
    """As a wrapper reads its module's ``pick_tile`` at each call: a
    variant forced by ``bench/tiles.py`` after a natural pick is looked up
    under the forcing's key, and the natural pick comes back, looked up,
    once the forcing has ended."""
    mod, code, args, force, other = _case(kernel)
    picks = {}

    def call():
        return _lib.cached_pick(picks, mod.pick_tile, code, 1024, 132, *args)

    natural = call()
    assert natural != other
    before = len(spans())
    with _profile():
        with force(other):
            assert call() == other
            assert call() == other
        assert call() == natural
        with force(other):
            assert call() == other  # a new forcing, a new key
    assert [r.count for r in _picks(before)] == [1, 0, 0, 1]

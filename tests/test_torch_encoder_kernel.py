"""The accumulate encoders' kernel (``kernels/encoder.py``,
``csrc/encoder.cu``) on the CPU, without a card and without JAX: the
wrapper's plain version against the definition (parity bit j, the XOR of
the low bits of rows 0..j's info bytes) on tables of any degree, the
wrapper's and ``parity_table``'s checks, the table and staircase encoders
taking the wrapper with their parity table, ``sim/scan.py`` counting its
launches, and the C entry's arguments against the wrapper's.  The kernel
itself is held to the plain version and to the JAX encoders on the card
(``tests/test_torch_cuda_encoder.py``).
"""

import re

import numpy as np
import pytest
import torch

from ldpcgputegra_tpu_torch.channel import encoder as E
from ldpcgputegra_tpu_torch.codes.registry import load_code
from ldpcgputegra_tpu_torch.kernels import _lib
from ldpcgputegra_tpu_torch.kernels import encoder as KE


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _table(k, m, seed):
    """Pairs (row, info bit) of ``m`` rows of degree 0-40 over ``k`` info
    bits, in no order, the first row and a middle one empty."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 41, m)
    deg[0] = deg[m // 2] = 0
    rows = rng.permutation(np.repeat(np.arange(m), deg))
    return rows, rng.integers(0, k, rows.size)


@pytest.mark.parametrize("k,m,batch", [(1001, 333, 5), (37, 5, 3),
                                       (40000, 50, 2), (8, 1, 1)])
def test_plain_version_is_the_definition(k, m, batch):
    """The codeword: the info bytes, then parity bit j, the XOR of the low
    bits of every info byte of rows 0..j (bytes other than 0 and 1 too)."""
    rows, cols = _table(k, m, k)
    row_ptr, table = KE.parity_table(rows, cols, m, k)
    assert row_ptr.dtype == np.int32 and row_ptr[-1] == rows.size
    assert table.dtype == (np.int16 if k < 32768 else np.int32)
    u = np.random.default_rng(m).integers(-128, 128, (batch, k),
                                          dtype=np.int8)
    s = np.zeros((batch, m), np.int64)
    for r, c in zip(rows, cols):
        s[:, r] ^= u[:, c] & 1
    want = np.concatenate([u, np.bitwise_xor.accumulate(s, axis=1)], 1)
    got = KE.accumulate_encode(torch.from_numpy(u), torch.from_numpy(row_ptr),
                               torch.from_numpy(table), k + m)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrapper_checks_its_inputs():
    """The wrapper raises on info bits of another type than int8, of
    another shape than [B, K < n], not contiguous or on a device with no
    kernel, and on a table of another type, length or device."""
    row_ptr, cols = (torch.from_numpy(a) for a in KE.parity_table(
        *_table(48, 16, 1), 16, 48))
    u = torch.zeros((4, 48), dtype=torch.int8)
    KE.accumulate_encode(u, row_ptr, cols, 64)
    for bad in (u.to(torch.uint8), u.to(torch.int32), u.bool(), u.numpy()):
        with pytest.raises(TypeError):
            KE.accumulate_encode(bad, row_ptr, cols, 64)
    for bad in (u[0], u.view(4, 6, 8), u[:, :47]):
        with pytest.raises(ValueError):
            KE.accumulate_encode(bad, row_ptr, cols, 64)
    with pytest.raises(ValueError, match="contiguous"):
        KE.accumulate_encode(torch.zeros((48, 4), dtype=torch.int8).t(),
                             row_ptr, cols, 64)
    with pytest.raises(ValueError, match="no kernel"):
        KE.accumulate_encode(torch.empty((4, 48), dtype=torch.int8,
                                         device="meta"),
                             row_ptr.to("meta"), cols.to("meta"), 64)
    for bad_ptr, bad_cols in ((row_ptr.long(), cols), (row_ptr, cols.long()),
                              (row_ptr, cols.float()),
                              (row_ptr.to("meta"), cols),
                              (row_ptr, cols.view(1, -1)),
                              (row_ptr, cols.numpy())):
        with pytest.raises(TypeError):
            KE.accumulate_encode(u, bad_ptr, bad_cols, 64)
    with pytest.raises(ValueError, match="offsets"):
        KE.accumulate_encode(u, row_ptr, cols, 65)


def test_parity_table_refuses_pairs_outside_the_code():
    rows, cols = np.array([0, 1, 2]), np.array([0, 5, 9])
    KE.parity_table(rows, cols, 3, 10)
    for r, c, m, k in ((rows, cols, 2, 10), (rows, cols, 3, 9),
                       (rows - 1, cols, 3, 10), (rows, cols[:2], 3, 10)):
        with pytest.raises(ValueError):
            KE.parity_table(r, c, m, k)


@pytest.mark.parametrize("name,kind", [("16200x10800", "table"),
                                       ("16200x7560", "staircase")])
def test_encoders_take_the_wrapper(monkeypatch, name, kind):
    """The table and staircase encoders pass the wrapper the info bits as
    contiguous int8 and their parity table on the bits' device."""
    seen = []

    def fake(u, row_ptr, cols, n):
        seen.append((u, row_ptr, cols, n))
        return torch.zeros((u.shape[0], n), dtype=torch.int8)

    monkeypatch.setattr(E, "accumulate_encode", fake)
    enc = E.make_encoder(load_code(name), kind)
    bits = torch.zeros((enc.k, 3), dtype=torch.bool).t()
    enc.encode(bits)
    ((u, row_ptr, cols, n),) = seen
    assert u.dtype == torch.int8 and u.is_contiguous() and n == enc.n
    assert torch.equal(row_ptr, torch.from_numpy(enc._row_ptr))
    assert torch.equal(cols, torch.from_numpy(enc._cols))


def test_scan_counts_the_encoder_launches():
    """``sim/scan.py`` takes the kernel's counter back after a capture and
    adds its launches at each replay, as it does the other kernels'."""
    from ldpcgputegra_tpu_torch.sim import scan

    assert any(c is KE.launches for c in scan._launch_counters())


def test_c_entry_matches_the_wrapper():
    """The C entry takes as many arguments as the wrapper declares, the
    stream last; the kernel's name holds no ``_minsum`` (the benchmark's
    readers count those as decode time); its shared-memory limit is
    Hopper's."""
    with open(KE.SOURCE) as f:
        src = f.read()
    m = re.search(r"int accumulate_encode_launch\((.*?)\)\s*\{", src, re.S)
    params = [p.strip().split()[-1].lstrip("*") for p in m.group(1).split(",")]
    assert len(params) == len(KE._FUNCTIONS["accumulate_encode_launch"][0])
    assert params[-1] == "stream", params
    assert re.findall(r"^(\w+_kernel)\(", src, re.M) == [
        "accumulate_encode_kernel"]
    assert "_minsum" not in src
    assert not re.search(r'#include "', src)
    smem = int(re.search(r"ENCODE_SMEM_MAX = (\d+);", src).group(1))
    assert smem == _lib.SMEM_MAX

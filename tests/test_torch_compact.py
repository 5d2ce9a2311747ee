"""K2's two halves (``compact_count``, ``compact_scatter``) against the JAX
package's compaction, and the one host read of a segment end.

On CPU tensors both halves run their plain PyTorch versions, so these tests
hold the arithmetic and the offsets layout the CUDA kernels share, at tile
edges, densities 0, 0.5 and 1, more columns than one launch takes and
views with a storage offset; ``chip_smoke.py`` holds the kernels themselves
against the plain versions, bit for bit, on the card.
"""

from __future__ import annotations

import contextlib
import datetime as dtm
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import polars_tpu_torch as plt
from polars_tpu.kernels.pallas_compact import compact_columns_xla
from polars_tpu_torch.kernels.compact import CHUNK_ROWS, TILE_ROWS, chunks, compact_count, compact_scatter

_WIDTHS = {1: np.int8, 2: np.int16, 4: np.int32, 8: np.int64}
_DTYPES = (torch.bool, torch.int8, torch.int16, torch.int32, torch.float32, torch.int64, torch.float64)


def _payloads(rng, n: int, dtypes, offset: int = 0) -> tuple[list, list]:
    """One column per dtype of random bit patterns (NaN payloads included),
    as tensors that start ``offset`` elements into their storage, and each
    column's bits widened to int64 for the JAX reference."""
    cols, bits = [], []
    for d in dtypes:
        if d == torch.bool:
            raw = (rng.random(n + offset) < 0.5).astype(np.int8)
            t = torch.from_numpy(raw.astype(bool))
        else:
            w = torch.empty(0, dtype=d).element_size()
            raw = rng.integers(-(2 ** (8 * w - 1)), 2 ** (8 * w - 1), n + offset, dtype=_WIDTHS[w])
            t = torch.from_numpy(raw).view(d)
        cols.append(t[offset:])
        bits.append(raw[offset:].astype(np.int64))
    return cols, bits


def _mask(rng, n: int, density: float, offset: int = 0) -> torch.Tensor:
    return torch.from_numpy(rng.random(n + offset) < density)[offset:]


def _bits(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bool:
        return t.numpy().astype(np.int64)
    return t.view({1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()]).numpy().astype(np.int64)


_XLA_ROWS = 3 * TILE_ROWS + 77  # every case's rows, padded with dropped rows: one XLA compile per column count


def _hold(cols: list, bits: list, mask: torch.Tensor) -> None:
    """compact_count and compact_scatter against compact_columns_xla (all
    columns as one int64 stack of their bits, padded to ``_XLA_ROWS`` rows
    that the mask drops) and the chunk offsets against numpy, bit for bit."""
    n = mask.shape[0]
    m = mask.numpy()
    offs = compact_count(mask)
    want_offs = np.concatenate([[0], np.cumsum([m[c * CHUNK_ROWS:(c + 1) * CHUNK_ROWS].sum() for c in range(chunks(n))])])
    np.testing.assert_array_equal(offs.numpy(), want_offs)
    count = int(offs[-1])
    outs = compact_scatter(cols, mask, offs, count)
    stack = np.zeros((len(bits), _XLA_ROWS), np.int64)
    stack[:, :n] = np.stack(bits) if bits else 0
    keep = np.zeros(_XLA_ROWS, bool)
    keep[:n] = m
    want, wcnt = compact_columns_xla(jnp.asarray(stack), jnp.asarray(keep))
    assert count == int(wcnt) == int(m.sum())
    want = np.asarray(want)[:, :count]
    assert len(outs) == len(cols)
    for c, (got, col) in enumerate(zip(outs, cols)):
        assert got.dtype == col.dtype and got.shape == (count,)
        np.testing.assert_array_equal(_bits(got), want[c])


@pytest.mark.parametrize("density", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("n", [0, 1, 511, 512, 4095, 4096, 4097, TILE_ROWS - 1, TILE_ROWS, TILE_ROWS + 1, _XLA_ROWS])
def test_compact_halves_match_xla(n, density):
    rng = np.random.default_rng(n * 10 + int(density * 4))
    cols, bits = _payloads(rng, n, _DTYPES)
    _hold(cols, bits, _mask(rng, n, density))


def test_compact_halves_more_columns_than_one_launch():
    """40 columns: the kernel moves them 32 to a launch."""
    rng = np.random.default_rng(40)
    n = TILE_ROWS + 5
    cols, bits = _payloads(rng, n, [_DTYPES[i % len(_DTYPES)] for i in range(40)])
    _hold(cols, bits, _mask(rng, n, 0.5))


@pytest.mark.parametrize("offset", [1, 7, 15])
def test_compact_halves_take_views_with_a_storage_offset(offset):
    """Mask and columns start ``offset`` elements into their storage (1-byte
    payloads and the mask at that many bytes): the kernel takes its byte path
    there, so only the result may be compared."""
    rng = np.random.default_rng(offset)
    n = 2 * CHUNK_ROWS + 77
    cols, bits = _payloads(rng, n, _DTYPES, offset)
    mask = _mask(rng, n, 0.5, offset)
    assert mask.storage_offset() == offset and all(c.storage_offset() == offset for c in cols)
    _hold(cols, bits, mask)


def test_compact_halves_match_pallas_kernel_in_interpret_mode():
    """The split interface against the TPU kernel itself (interpret mode, the
    pattern of tests/test_kernels.py), over two of its blocks and two
    columns."""
    import jax.experimental.pallas as jpl

    from polars_tpu.kernels import pallas_compact as PC

    rng = np.random.default_rng(23)
    k, n = 2, PC.BLOCK * 2
    vals = rng.normal(size=(k, n))
    mask = rng.random(n) < 0.3
    orig = jpl.pallas_call
    jpl.pallas_call = functools.partial(orig, interpret=True)
    try:
        packed, cnt = PC.compact_columns_pallas(jnp.asarray(vals), jnp.asarray(mask))
    finally:
        jpl.pallas_call = orig
    mask_t = torch.from_numpy(mask)
    offs = compact_count(mask_t)
    outs = compact_scatter([torch.from_numpy(vals[c].copy()) for c in range(k)], mask_t, offs, int(offs[-1]))
    assert int(offs[-1]) == int(cnt)
    # the TPU kernel moves f64 as hi/lo f32 halves (48 of 53 mantissa bits):
    # test_compact_matches_pallas_kernel_in_interpret_mode's tolerance
    np.testing.assert_allclose(torch.stack(outs).numpy(), np.asarray(packed)[:, : int(cnt)], rtol=1e-12)


# ---------------------------------------------------------------------------
# a segment end reads the device once
# ---------------------------------------------------------------------------


def _q3_tables(dup_customer: bool, dup_order: bool) -> dict:
    """Q3's columns at a handful of rows. A duplicated BUILDING customer
    breaks the first join's 1:m, a duplicated order the second's."""
    d = dtm.date(1995, 1, 1)
    ship = dtm.date(1995, 6, 1)
    cust = {"c_custkey": [1, 2, 3], "c_mktsegment": ["BUILDING", "BUILDING", "AUTOMOBILE"]}
    orders = {"o_orderkey": [10, 11, 12, 13], "o_custkey": [1, 2, 1, 3], "o_orderdate": [d] * 4,
              "o_shippriority": [0, 0, 0, 0]}
    if dup_customer:
        cust = {"c_custkey": cust["c_custkey"] + [2], "c_mktsegment": cust["c_mktsegment"] + ["BUILDING"]}
    if dup_order:
        orders = {k: v + [v[1]] for k, v in orders.items()}
    line = {"l_orderkey": [10, 10, 11, 12, 13], "l_shipdate": [ship] * 5,
            "l_extendedprice": [100.0, 200.0, 300.0, 400.0, 500.0], "l_discount": [0.1, 0.0, 0.2, 0.0, 0.5]}
    return {"customer": plt.DataFrame(cust, device="cpu"), "orders": plt.DataFrame(orders, device="cpu"),
            "lineitem": plt.DataFrame(line, device="cpu")}


@contextlib.contextmanager
def _count_host_reads(monkeypatch):
    """Counts every tensor-to-Python conversion (where a CUDA tensor would
    synchronise) and every call of the segment's read function."""
    from polars_tpu_torch.engine import executors as X

    seen = {"tensor": 0, "read_count": 0}
    for name in ("__int__", "__bool__", "__float__", "__index__", "item", "tolist"):
        orig = getattr(torch.Tensor, name)

        def counted(self, *a, _orig=orig, **kw):
            seen["tensor"] += 1
            return _orig(self, *a, **kw)

        monkeypatch.setattr(torch.Tensor, name, counted)
    read = X._read_count

    def counted_read(count, flags):
        seen["read_count"] += 1
        return read(count, flags)

    monkeypatch.setattr(X, "_read_count", counted_read)
    yield seen
    monkeypatch.undo()


@pytest.mark.parametrize("raised", [0, 1, 2])
def test_two_join_segment_reads_the_device_once(raised, monkeypatch):
    """Q3's shape (two validated 1:m joins, a group-by, top 10) is one
    segment: its flags ride K2's device total, which is read once, whether
    no flag, one flag or two flags are raised."""
    from polars_tpu_torch.testing import pdsh

    t = _q3_tables(dup_customer=raised == 2, dup_order=raised >= 1)
    lf = pdsh.q3(t["customer"], t["orders"], t["lineitem"])
    with _count_host_reads(monkeypatch) as seen:
        if raised:
            with pytest.raises(plt.ComputeError, match="validation"):
                lf.collect()
        else:
            out = lf.collect()
    assert seen == {"tensor": 1, "read_count": 1}
    if not raised:
        assert out.to_dict(as_series=False)["l_orderkey"] == [12, 10, 11]

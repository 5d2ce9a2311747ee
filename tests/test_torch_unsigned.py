"""Unsigned integers through both packages on the same data.

PyTorch has no arithmetic for uint16/32/64, so the port keeps UInt16 and
UInt32 in the next wider signed tensor and UInt64 as its bit pattern in
int64. These tests hold every place a value is produced or leaves the device
to ``polars_tpu``'s results: exact values, schema and numpy dtype. Each
family runs one plan per package (few JAX compiles) and checks one output
column per case.
"""

from __future__ import annotations

import numpy as np
import pytest

import polars_tpu as plj
import polars_tpu_torch as plt
from polars_tpu_torch.interop import frame_from_numpy

U64_EDGE = [1, 2**63 + 5, 7, 2**64 - 1, 2**63, 2**63 - 1, 0, 2**64 - 2]


@pytest.fixture(autouse=True)
def _cpu_default_device():
    prev = plt.set_default_device("cpu")
    yield
    plt.set_default_device(prev)


def _carry(df_j):
    """The port's frame over the same physical arrays as a polars_tpu frame."""
    specs = {}
    for c in df_j._columns:
        n = c.buffer.length
        spec = {"values": np.asarray(c.buffer.values)[:n], "dtype": type(c.dtype).__name__,
                "validity": None if c.buffer.validity is None else np.asarray(c.buffer.validity)[:n]}
        if c.table is not None:
            spec["dictionary"] = c.table.values
            spec["sorted"] = c.table.sorted_order
        specs[c.name] = spec
    return frame_from_numpy(specs, device="cpu")


def _data() -> dict:
    rng = np.random.default_rng(29)
    n = 48
    return {
        "k": np.asarray(["a", "b", "c"], object)[rng.integers(0, 3, n)],
        "u8": rng.integers(0, 256, n).astype(np.uint8),
        # near the top of the range: sums, products and doubles overflow
        "u16": rng.integers(60000, 65536, n).astype(np.uint16),
        "u32": rng.integers(2**32 - 2**20, 2**32, n).astype(np.uint32),
        "u64": np.asarray(U64_EDGE * (n // len(U64_EDGE)), np.uint64),
        "u64b": rng.integers(0, 2**64, n, dtype=np.uint64),
        "i64": rng.integers(-5, 5, n),
    }


@pytest.fixture(scope="module")
def frames():
    df_j = plj.DataFrame(_data())
    return df_j, _carry(df_j)


def _both(frames, build):
    """``build(pl, df)`` collected through polars_tpu and through the port."""
    df_j, df_t = frames
    return build(plj, df_j).collect(), build(plt, df_t).collect()


def _assert_column_equal(got, want, name):
    assert repr(got.schema[name]) == repr(want.schema[name])
    g, w = got[name].to_numpy(), want[name].to_numpy()
    assert g.dtype == w.dtype, (g.dtype, w.dtype)
    if w.dtype.kind == "f":
        # one rounding each of the same exact value: f64 in both packages
        np.testing.assert_array_equal(g, w)
    else:
        assert g.tolist() == w.tolist()
    assert got[name].to_list() == want[name].to_list()


ARITH = {
    "u16_add": lambda pl: pl.col("u16") + pl.col("u16"),
    "u16_underflow": lambda pl: pl.col("u16") - pl.col("u16") - 1,
    "u16_mul": lambda pl: pl.col("u16") * 3,
    "u16_mul_u8": lambda pl: pl.col("u16") * pl.col("u8"),
    "u8_sub_u16": lambda pl: pl.col("u8") - pl.col("u16"),
    "u32_add": lambda pl: pl.col("u32") + pl.col("u32"),
    "u32_mul": lambda pl: pl.col("u32") * 3,
    "u32_underflow": lambda pl: pl.col("u32") - pl.col("u32") - 1,
    "u32_floordiv_u16": lambda pl: pl.col("u32") // pl.col("u16"),
    "u32_mod_u16": lambda pl: pl.col("u32") % pl.col("u16"),
    "u32_add_i64": lambda pl: pl.col("u32") + pl.col("i64"),
    "u64_add_u32": lambda pl: pl.col("u64") + pl.col("u32"),
    "u64_add_lit": lambda pl: pl.col("u64") + 1,
    "u64_sub_u8": lambda pl: pl.col("u64") - pl.col("u8"),
    "u64_mul": lambda pl: pl.col("u64b") * 3,
    "u64_floordiv": lambda pl: pl.col("u64") // 3,
    "u64_mod": lambda pl: pl.col("u64") % 3,
    "u64_floordiv_u64": lambda pl: pl.col("u64b") // pl.col("u64"),
    "u64_mod_u64": lambda pl: pl.col("u64b") % pl.col("u64"),
    "u64_truediv_u8": lambda pl: pl.col("u64") / pl.col("u8"),
    "u64_mul_float": lambda pl: pl.col("u64b") * 2.0,
    "u64_add_i64": lambda pl: pl.col("u64") + pl.col("i64"),
}


@pytest.fixture(scope="module")
def arith(frames):
    return _both(frames, lambda pl, df: df.lazy().select(*[f(pl).alias(n) for n, f in ARITH.items()]))


@pytest.mark.parametrize("name", list(ARITH))
def test_unsigned_arithmetic_matches_polars_tpu(arith, name):
    want, got = arith
    _assert_column_equal(got, want, name)


COMPARE = {
    "gt_small": lambda pl: pl.col("u64") > 100,
    "ge_small": lambda pl: pl.col("u64") >= 7,
    "lt_below_top_bit": lambda pl: pl.col("u64") < 2**63 - 1,
    "le_below_top_bit": lambda pl: pl.col("u64") <= 2**63 - 1,
    "eq_small": lambda pl: pl.col("u64") == 7,
    "ne_col": lambda pl: pl.col("u64") != pl.col("u64b"),
    "gt_col": lambda pl: pl.col("u64") > pl.col("u64b"),
    "gt_u32": lambda pl: pl.col("u64") > pl.col("u32"),
    "gt_i64": lambda pl: pl.col("u64") > pl.col("i64"),
    "u32_gt_literal": lambda pl: pl.col("u32") > 4294000000,
}


@pytest.fixture(scope="module")
def compares(frames):
    return _both(frames, lambda pl, df: df.lazy().select(*[f(pl).alias(n) for n, f in COMPARE.items()]))


@pytest.mark.parametrize("name", list(COMPARE))
def test_uint64_compares_match_polars_tpu(compares, name):
    want, got = compares
    _assert_column_equal(got, want, name)
    if name != "ne_col":
        assert 0 < sum(want[name].to_list()) < want.height  # the case separates rows


@pytest.mark.parametrize("bound", [100, 2**63 - 1])
def test_uint64_filter_keeps_the_rows_above(frames, bound):
    want, got = _both(frames, lambda pl, df: df.lazy().filter(pl.col("u64") > bound).select("u64", "u32"))
    assert want.height == sum(v > bound for v in _data()["u64"].tolist())
    for name in ("u64", "u32"):
        _assert_column_equal(got, want, name)


@pytest.mark.parametrize("op", ["gt", "ge", "lt", "le", "eq", "ne"])
@pytest.mark.parametrize("literal", [2**63, 2**63 + 5, 2**64 - 1])
def test_uint64_compares_with_literals_above_the_sign_bit(frames, op, literal):
    """polars_tpu cannot build a literal of 2^63 or more (its JAX constant
    overflows), so here the port is held to Polars semantics through numpy:
    the literal is a UInt64 and the compare is unsigned."""
    import operator

    _, df_t = frames
    fn = getattr(operator, op)
    got = df_t.lazy().select(fn(plt.col("u64"), literal).alias("x")).collect()
    assert repr(got.schema["x"]) == "Boolean"
    assert got["x"].to_list() == fn(_data()["u64"], np.uint64(literal)).tolist()
    kept = df_t.lazy().filter(fn(plt.col("u64"), literal)).select("u64").collect()
    assert kept["u64"].to_list() == [v for v in _data()["u64"].tolist() if fn(v, literal)]


AGGS = {
    "sum_u8": lambda pl: pl.col("u8").sum(),
    "sum_u16": lambda pl: pl.col("u16").sum(),
    "sum_u32": lambda pl: pl.col("u32").sum(),
    "sum_u64": lambda pl: pl.col("u64").sum(),
    "sum_u64b": lambda pl: pl.col("u64b").sum(),
    "sum_u32_expr": lambda pl: (pl.col("u32") * 2).sum(),
    "min_u64": lambda pl: pl.col("u64b").min(),
    "max_u64": lambda pl: pl.col("u64b").max(),
    "min_u64_edge": lambda pl: pl.col("u64").min(),
    "max_u64_edge": lambda pl: pl.col("u64").max(),
    "mean_u64": lambda pl: pl.col("u64b").mean(),
    "mean_u32": lambda pl: pl.col("u32").mean(),
    "max_u32": lambda pl: pl.col("u32").max(),
    "min_u16": lambda pl: pl.col("u16").min(),
    "len": lambda pl: pl.len(),
}


@pytest.fixture(scope="module")
def grouped(frames):
    return _both(
        frames,
        lambda pl, df: df.lazy().group_by("k").agg(*[f(pl).alias(n) for n, f in AGGS.items()]).sort("k"),
    )


@pytest.mark.parametrize("name", list(AGGS))
def test_unsigned_group_aggregations_match_polars_tpu(grouped, name):
    want, got = grouped
    assert got["k"].to_list() == want["k"].to_list() == ["a", "b", "c"]
    if name.startswith("mean"):
        # f64 sums of the same values in another order
        assert repr(got.schema[name]) == repr(want.schema[name])
        np.testing.assert_allclose(got[name].to_numpy(), want[name].to_numpy(), rtol=1e-12)
    else:
        _assert_column_equal(got, want, name)


def test_unsigned_group_sums_wrap(grouped):
    """The data makes the UInt32 and UInt64 sums overflow, so the case above
    holds the wrap and not only small sums."""
    want, _ = grouped
    data = _data()
    for name, col, bits in (("sum_u32", "u32", 32), ("sum_u64b", "u64b", 64)):
        exact = {k: 0 for k in "abc"}
        for k, v in zip(data["k"], data[col].tolist()):
            exact[k] += v
        assert any(v >= 2**bits for v in exact.values())
        assert want[name].to_list() == [exact[k] % 2**bits for k in "abc"]


@pytest.mark.parametrize("column", ["u64", "u64b", "u32", "u16"])
@pytest.mark.parametrize("descending", [False, True])
def test_unsigned_sort_matches_polars_tpu(frames, column, descending):
    want, got = _both(frames, lambda pl, df: df.lazy().sort(column, descending=descending).select(column, "u8"))
    _assert_column_equal(got, want, column)
    assert want[column].to_list() == sorted(_data()[column].tolist(), reverse=descending)


@pytest.mark.parametrize("column", ["u8", "u16", "u32", "u64"])
def test_unsigned_columns_leave_the_device_in_their_numpy_dtype(frames, column):
    df_j, df_t = frames
    src = _data()[column]
    for out in (df_t[column].to_numpy(), df_j[column].to_numpy()):
        assert out.dtype == src.dtype
        np.testing.assert_array_equal(out, src)
    assert df_t[column].to_list() == df_j[column].to_list() == src.tolist()
    assert df_t.to_dict(as_series=False)[column] == df_j.to_dict(as_series=False)[column]
    assert df_t.to_dict()[column].to_numpy().dtype == src.dtype


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.uint32, np.uint64])
def test_unsigned_numpy_ingest_reads_back_unchanged(dtype):
    top = np.iinfo(dtype).max
    src = np.asarray([0, 1, top // 2, top // 2 + 1, top - 1, top], dtype)
    df = plt.DataFrame({"x": src})
    want = plj.DataFrame({"x": src})
    assert repr(df.schema["x"]) == repr(want.schema["x"])
    assert df["x"].to_numpy().dtype == want["x"].to_numpy().dtype == np.dtype(dtype)
    assert df["x"].to_list() == want["x"].to_list() == src.tolist()
    assert df.to_dict(as_series=False) == want.to_dict(as_series=False)


def test_unsigned_helpers_round_and_divide_like_numpy():
    """The building blocks on their own, against numpy's uint64: the float
    read rounds once (to nearest even), and // and % are unsigned."""
    import torch

    from polars_tpu_torch import datatypes as dt
    from polars_tpu_torch.engine.cast import float_values, order_word, wrap_unsigned
    from polars_tpu_torch.kernels.fastmath import floordiv_u64, mod_u64

    rng = np.random.default_rng(31)
    a = np.concatenate([rng.integers(0, 2**64, 500, dtype=np.uint64), np.asarray(U64_EDGE, np.uint64),
                        np.asarray([2**63 + 1024, 2**63 + 1025, 2**64 - 1025, 2**53 + 1], np.uint64)])
    b = np.concatenate([rng.integers(1, 2**64, 250, dtype=np.uint64), rng.integers(1, 1000, 250, dtype=np.uint64),
                        np.asarray([2**64 - 1, 2**63, 1, 3, 2**63 + 5, 7, 2**63 - 1, 2**62], np.uint64),
                        np.asarray([1, 2, 3, 2**63], np.uint64)])
    ta, tb = torch.from_numpy(a.view(np.int64)), torch.from_numpy(b.view(np.int64))
    np.testing.assert_array_equal(floordiv_u64(ta, tb).numpy().view(np.uint64), a // b)
    np.testing.assert_array_equal(mod_u64(ta, tb).numpy().view(np.uint64), a % b)
    np.testing.assert_array_equal(float_values(ta, dt.UInt64(), torch.float64).numpy(), a.astype(np.float64))
    np.testing.assert_array_equal(float_values(ta, dt.UInt64(), torch.float32).numpy(), a.astype(np.float32))
    order = torch.argsort(order_word(ta, dt.UInt64()), stable=True).numpy()
    np.testing.assert_array_equal(a[order], np.sort(a, kind="stable"))
    wide = torch.tensor([-1, 65536, 65535, 2**32, 2**32 + 7, -(2**32) - 2])
    assert wrap_unsigned(wide.to(torch.int32), dt.UInt16()).tolist() == [65535, 0, 65535, 0, 7, 65534]
    assert wrap_unsigned(wide, dt.UInt32()).tolist() == [2**32 - 1, 65536, 65535, 0, 7, 2**32 - 2]
    assert wrap_unsigned(wide, dt.Int64()) is wide

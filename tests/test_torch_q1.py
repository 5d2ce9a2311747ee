"""PDS-H Q1 through both packages on the same data, plus the port's import
isolation and device rule.

The lineitem frame is built once by ``polars_tpu`` and carried into the port
with ``frame_from_numpy`` (same physical arrays, same dictionary codes), so
both engines group and sort identical keys.
"""

from __future__ import annotations

import datetime as dtm
import subprocess
import sys

import numpy as np
import pytest
import torch

import polars_tpu as plj
import polars_tpu_torch as plt
from polars_tpu.testing import pdsh as pdsh_jax
from polars_tpu_torch.interop import frame_from_numpy
from polars_tpu_torch.testing import pdsh as pdsh_torch

Q1_COLS = [
    "l_shipdate", "l_returnflag", "l_linestatus", "l_quantity",
    "l_extendedprice", "l_discount", "l_tax",
]


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


@pytest.fixture(scope="module")
def frames():
    raw = pdsh_jax.generate_pdsh(0.01, tables=("lineitem",))["lineitem"]
    df_j = plj.DataFrame({c: raw[c] for c in Q1_COLS})
    return df_j, _carry(df_j)


@pytest.fixture(scope="module")
def mixed():
    """A small frame with nulls in every kind of column the slice handles."""
    rng = np.random.default_rng(17)
    n = 200
    f = rng.normal(size=n)
    f[rng.random(n) < 0.1] = np.nan  # null on ingest
    g = rng.integers(-2, 3, n).astype(np.float64)  # zeros: inf and NaN quotients
    s = np.asarray(["b", "a", "c", None], object)[rng.integers(0, 4, n)]
    s2 = np.asarray(["x", "yy", "z", None], object)[rng.integers(0, 4, n)]
    bools = [None if r < 0.1 else bool(r < 0.55) for r in rng.random(n)]
    ints = [None if r < 0.05 else int(v) for r, v in zip(rng.random(n), rng.integers(-50, 50, n))]
    data = {
        "i": ints, "j": rng.integers(-3, 4, n), "i32": rng.integers(-9, 9, n).astype(np.int32),
        "f": f, "g": g, "s": s, "s2": s2, "b": bools,
        "d": (np.datetime64("1998-08-01") + rng.integers(0, 60, n)).astype("datetime64[D]"),
    }
    df_j = plj.DataFrame(data)
    return df_j, _carry(df_j)


def _assert_frames_match(got, want, *, rtol=1e-12):
    assert _schema(got) == _schema(want)
    g, w = got.to_dict(as_series=False), want.to_dict(as_series=False)
    for name, wcol in w.items():
        if isinstance(want.schema[name], plj.datatypes.FloatType):
            gv = np.asarray([np.nan if v is None else v for v in g[name]], np.float64)
            wv = np.asarray([np.nan if v is None else v for v in wcol], np.float64)
            assert [v is None for v in g[name]] == [v is None for v in wcol], name
            np.testing.assert_allclose(gv, wv, rtol=rtol, equal_nan=True, err_msg=name)
        else:
            assert g[name] == wcol, name


def _schema(df) -> list:
    return [(name, repr(d)) for name, d in df.schema.items()]


def test_q1_matches_polars_tpu(frames):
    df_j, df_t = frames
    assert df_t.height == df_j.height == 60_000
    want = pdsh_jax.q1(df_j).collect()
    got = pdsh_torch.q1(df_t).collect()
    assert _schema(got) == _schema(want)
    w, g = want.to_dict(as_series=False), got.to_dict(as_series=False)
    for key in ("l_returnflag", "l_linestatus", "count_order"):
        assert g[key] == w[key]
    for key in ("sum_qty", "sum_base_price", "sum_disc_price", "sum_charge", "avg_qty", "avg_price", "avg_disc"):
        # the two engines sum in different orders
        np.testing.assert_allclose(np.asarray(g[key]), np.asarray(w[key]), rtol=1e-10)


def test_q1_kernel_calls(frames, monkeypatch):
    """Q1 calls K1 twice (the occupancy count over the 12 key slots, then one
    batch of its 5 distinct f64 columns; len and the means reuse the counts)
    and K2 once, over the 12 group slots."""
    from polars_tpu_torch.engine import executors as X
    from polars_tpu_torch.engine import groupby as G
    from polars_tpu_torch.kernels.compact import compact
    from polars_tpu_torch.kernels.groupagg import groupagg_sums

    calls = []

    def k1(gids, cols, mask, cap):
        calls.append(("K1", cap, [None if c is None else c.dtype for c in cols]))
        return groupagg_sums(gids, cols, mask, cap)

    def k2(cols, mask):
        calls.append(("K2", mask.shape[0], len(cols)))
        return compact(cols, mask)

    monkeypatch.setattr(X, "groupagg_sums", k1)
    monkeypatch.setattr(G, "groupagg_sums", k1)
    monkeypatch.setattr(X, "compact", k2)
    pdsh_torch.q1(frames[1]).collect()
    assert calls == [("K1", 12, [None]), ("K1", 12, [torch.float64] * 5), ("K2", 12, 13)]


def test_q1_filter_matches_polars_tpu(frames):
    df_j, df_t = frames
    want = df_j.lazy().filter(plj.col("l_shipdate") <= dtm.date(1998, 9, 2)).collect()
    got = df_t.lazy().filter(plt.col("l_shipdate") <= dtm.date(1998, 9, 2)).collect()
    assert _schema(got) == _schema(want)
    assert got.height == want.height < df_t.height
    for c in Q1_COLS:
        np.testing.assert_array_equal(
            got._get(c).buffer.values.numpy(), np.asarray(want._get(c).buffer.values)[: want.height]
        )
        assert got[c].to_list() == want[c].to_list()


def test_q1_on_frames_built_by_the_port(frames):
    """The port's own ingest (string encoding, dates) gives the same codes."""
    df_j, df_t = frames
    raw = pdsh_torch.generate_pdsh(0.01, tables=("lineitem",))["lineitem"]
    df = plt.DataFrame({c: raw[c] for c in Q1_COLS})
    for c in Q1_COLS:
        assert torch.equal(df._get(c).buffer.values, df_t._get(c).buffer.values)
    a = pdsh_torch.q1(df).collect().to_dict(as_series=False)
    b = pdsh_torch.q1(df_t).collect().to_dict(as_series=False)
    assert a == b


def test_group_by_aggregations_match_polars_tpu(mixed):
    """The aggregations Q1 does not reach: integer sums and means (i64 batch),
    counts with nulls, float and string min/max, bool and null keys."""
    df_j, df_t = mixed

    def plan(pl, df):
        return (
            df.lazy()
            .filter(pl.col("i32") > -7)
            .group_by("s", "b")
            .agg(
                isum=pl.col("i").sum(), imean=pl.col("i").mean(), i32sum=pl.col("i32").sum(),
                fcount=pl.col("f").count(), fsum=pl.col("f").sum(), fmean=pl.col("f").mean(),
                fmin=pl.col("f").min(), fmax=pl.col("f").max(), imax=pl.col("i").max(),
                smin=pl.col("s2").min(), smax=pl.col("s2").max(), bsum=pl.col("b").sum(),
                dmax=pl.col("d").max(), n=pl.len(), nn=pl.col("i").len(),
                ratio=pl.col("f").sum() / pl.len(),
            )
            .sort("s", "b", nulls_last=True)
        )

    _assert_frames_match(plan(plt, df_t).collect(), plan(plj, df_j).collect())


def test_arithmetic_and_logic_match_polars_tpu(mixed):
    """Polars division semantics, type promotion and Kleene logic."""
    df_j, df_t = mixed

    def plan(pl, df):
        return df.lazy().with_columns(
            q=pl.col("i") // pl.col("j"), r=pl.col("i") % pl.col("j"), div=pl.col("i") / pl.col("j"),
            fq=pl.col("f") // pl.col("g"), fr=pl.col("f") % pl.col("g"), fdiv=pl.col("f") / pl.col("g"),
            k=((pl.col("i") > 3) & (pl.col("f") < 0.5)) | pl.col("b"),
            inc=pl.col("i32") + 1, scaled=pl.col("i32") * 2.5, mixed=pl.col("i32") - pl.col("i"),
            early=pl.col("d") <= dtm.date(1998, 8, 20),
        ).select("q", "r", "div", "fq", "fr", "fdiv", "k", "inc", "scaled", "mixed", "early")

    _assert_frames_match(plan(plt, df_t).collect(), plan(plj, df_j).collect())


def test_sort_order_matches_polars_tpu(mixed):
    """Nulls first/last, descending, NaN greatest, and multi-key ties."""
    df_j, df_t = mixed

    def plan(pl, df):
        return (
            df.lazy()
            .with_columns(h=pl.col("f") / pl.col("g"))
            .sort("s", "h", "i", descending=[False, True, False], nulls_last=[True, False, True])
            .select("s", "h", "i", "f")
        )

    _assert_frames_match(plan(plt, df_t).collect(), plan(plj, df_j).collect())


def test_import_is_isolated_from_jax():
    code = (
        "import sys, polars_tpu_torch; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'polars_tpu' or m.startswith('polars_tpu.')]; "
        "assert not bad, bad"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_no_quiet_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    plt.set_default_device("cuda")
    with pytest.raises(plt.ComputeError, match="no CUDA device"):
        plt.DataFrame({"a": [1, 2, 3]})
    assert plt.DataFrame({"a": [1, 2, 3]}, device="cpu").height == 3

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
    from polars_tpu_torch.kernels.compact import compact_scatter
    from polars_tpu_torch.kernels.groupagg import groupagg_sums

    calls = []

    def k1(gids, cols, mask, cap):
        calls.append(("K1", cap, [None if c is None else c.dtype for c in cols]))
        return groupagg_sums(gids, cols, mask, cap)

    def k2(cols, mask, offs, count):
        calls.append(("K2", mask.shape[0], len(cols)))
        return compact_scatter(cols, mask, offs, count)

    monkeypatch.setattr(X, "groupagg_sums", k1)
    monkeypatch.setattr(G, "groupagg_sums", k1)
    monkeypatch.setattr(X, "compact_scatter", k2)
    pdsh_torch.q1(frames[1]).collect()
    assert calls == [("K1", 12, [None]), ("K1", 12, [torch.float64] * 5), ("K2", 12, 13)]


def _scan_sources(tmp) -> dict:
    """SF 0.002 lineitem as files: two Parquet files of several row groups,
    a hive layout by ``l_returnflag`` and one CSV file; each source is the
    argument of its scan function."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    raw = pdsh_torch.generate_pdsh(0.002, tables=("lineitem",))["lineitem"]
    df = plt.DataFrame(raw)
    half = df.height // 2
    df.slice(0, half).write_parquet(tmp / "line_0.parquet", row_group_size=1000)
    df.slice(half).write_parquet(tmp / "line_1.parquet", row_group_size=1000)
    table = df.to_arrow()
    for flag in ("A", "N", "R"):
        part = tmp / "hive" / f"l_returnflag={flag}"
        part.mkdir(parents=True)
        rows = table.filter(pa.compute.equal(table["l_returnflag"], flag)).drop_columns(["l_returnflag"])
        pq.write_table(rows, part / "part-0.parquet", row_group_size=1000)
    df.write_csv(tmp / "line.csv")
    return {"parquet": ("scan_parquet", [str(tmp / "line_0.parquet"), str(tmp / "line_1.parquet")]),
            "hive": ("scan_parquet", str(tmp / "hive")), "csv": ("scan_csv", str(tmp / "line.csv"))}


def _scan_plans(pl, pdsh, scan) -> dict:
    return {"q1": pdsh.q1(scan), "q6": pdsh.q6(scan),
            "head": scan.select("l_orderkey", "l_extendedprice", "l_shipmode", "l_returnflag").head(7),
            "len": scan.select(pl.len())}


def _check_scan_differential(tmp) -> None:
    """Q1, Q6, a projection with a head and ``pl.len()`` through
    ``scan_parquet`` and ``scan_csv`` of each package over the same files:
    equal frames (floats to rtol 1e-9), the same row groups read, and the
    pushed predicate and projection inside the port's scan."""
    from polars_tpu.io import scan_exec as scan_j
    from polars_tpu_torch.io import scan_exec as scan_t

    for kind, (fn, src) in _scan_sources(tmp).items():
        plans_j = _scan_plans(plj, pdsh_jax, getattr(plj, fn)(src))
        plans_t = _scan_plans(plt, pdsh_torch, getattr(plt, fn)(src))
        for name, lf_t in plans_t.items():
            scan_j.reset_scan_metrics()
            scan_t.reset_scan_metrics()
            want, got = plans_j[name].collect(), lf_t.collect()
            _assert_frames_match(got, want, rtol=1e-9)
            got_m, want_m = scan_t.scan_metrics(), scan_j.scan_metrics()
            if name == "head":  # a row limit over several files reads ahead a number of them that timing decides
                del got_m["rows_read"], want_m["rows_read"]
            assert got_m == want_m, (kind, name)
        if fn == "scan_parquet":
            _check_scan_batches(plans_t["len"]._node.input)
        scan_line = next(ln for ln in plans_t["q1"].explain().splitlines() if "Scan" in ln)
        assert "σ" in scan_line and "l_shipdate" in scan_line and "π 7/" in scan_line, (kind, scan_line)
    # the pushed Q1 date range skips row groups of the files sorted by date
    scan_t.reset_scan_metrics()
    plt.scan_parquet(str(tmp / "line_0.parquet")).sort("l_shipdate").collect().write_parquet(
        tmp / "sorted.parquet", row_group_size=500)
    pdsh_torch.q6(plt.scan_parquet(str(tmp / "sorted.parquet"))).collect()
    m = scan_t.scan_metrics()
    assert 0 < m["row_groups_kept"] < m["row_groups_total"], m


def _check_scan_batches(scan) -> None:
    """``iter_scan_batches`` (the streaming engine's reader) gives, batch
    after batch, the frame that ``execute_scan`` reads from the same scan
    node: pruned by a pushed predicate, and numbered by a row index that
    runs on across batches and files under an ``n_rows`` cut."""
    import dataclasses

    from polars_tpu_torch.io import scan_exec as scan_t

    pred = ((plt.col("l_shipdate") <= dtm.date(1995, 6, 1)) & (plt.col("l_returnflag") != "N"))._node
    for extra in ({}, {"row_index": ("i", 5), "n_rows": 8000}):
        node = dataclasses.replace(scan, projection=("l_orderkey", "l_shipdate", "l_returnflag"), predicate=pred,
                                   **extra)
        want = scan_t.execute_scan(node)
        batches = list(scan_t.iter_scan_batches(node, 2500))
        assert len(batches) > 2 and max(b.height for b in batches) <= 2500, extra
        assert plt.concat(batches).to_dict(as_series=False) == want.to_dict(as_series=False), extra


def _check_io_faults(tmp) -> None:
    """Where ``polars_tpu``'s scans are wrong (ROADMAP section 3), the port
    is held to Polars and to numpy, and the reference's answer is shown:
    page statistics of an unsigned column decoded as signed drop the pages
    above 2**63 (2**31); a row index numbers, and ``n_rows`` counts, the rows
    that pruning left; a CSV's text "null" is read as a null. A decimal
    wider than the port's int64 Decimal is read where each value fits and
    refused where one does not."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from polars_tpu_torch.io import scan_exec as scan_t

    n = 20_000
    for np_dtype, top in ((np.uint64, 2**63), (np.uint32, 2**31)):
        vals = np.arange(n, dtype=np_dtype)
        vals[n // 2:] += np_dtype(top)
        path = str(tmp / f"{np_dtype.__name__}.parquet")
        pq.write_table(pa.table({"x": vals}), path, write_page_index=True, data_page_size=1024, row_group_size=n)
        scan_t.reset_scan_metrics()
        got = plt.scan_parquet(path).filter((plt.col("x") >= top) & (plt.col("x") < top + n // 2 + 100)).collect()
        assert got["x"].to_list() == vals[n // 2:n // 2 + 100].tolist()
        assert scan_t.scan_metrics()["rows_page_pruned"] > 0
        assert plj.scan_parquet(path).filter(plj.col("x") >= top).collect().height == 0  # the reference's fault
    path = str(tmp / "rows.parquet")
    pq.write_table(pa.table({"x": np.arange(10_000)}), path, row_group_size=1000)
    for pl, want_i in ((plt, [9998, 9999]), (plj, [998, 999])):
        got = pl.scan_parquet(path, row_index_name="i").filter(pl.col("x") >= 9998).collect()
        assert got["i"].to_list() == want_i and got["x"].to_list() == [9998, 9999]
    for pl, want_rows in ((plt, 0), (plj, 10)):
        assert pl.scan_parquet(path, n_rows=10).filter(pl.col("x") >= 5000).collect().height == want_rows
    (tmp / "null.csv").write_text("s,v\nnull,1\nx,2\n")
    assert plt.read_csv(tmp / "null.csv")["s"].to_list() == ["null", "x"]
    assert plj.read_csv(tmp / "null.csv")["s"].to_list() == [None, "x"]
    # the port's Decimal is int64: a wider decimal is read where each value fits, refused where one does not
    D = __import__("decimal").Decimal
    fits = pa.table({"d": pa.array([D("1.25"), None, D("-92233720368547.75808")], pa.decimal128(38, 5))})
    pq.write_table(fits, tmp / "dec.parquet")
    for pl in (plt, plj):
        assert pl.scan_parquet(str(tmp / "dec.parquet")).collect()["d"].to_list() == fits["d"].to_pylist()
    for t in (pa.decimal32(9, 2), pa.decimal64(18, 2), pa.decimal256(40, 2)):
        small = pa.table({"d": pa.array([D("1.25"), None, D("-3.5")], t)})
        assert plt.from_arrow(small)["d"].to_list() == small["d"].to_pylist(), t
    pq.write_table(pa.table({"d": pa.array([D("1"), D("10.0")], pa.decimal128(38, 18))}), tmp / "wide.parquet")
    with pytest.raises(plt.ComputeError, match="does not fit in 64 bits"):
        plt.scan_parquet(str(tmp / "wide.parquet")).collect()


def _check_io_phase(tmp) -> None:
    """``chip_smoke.py``'s ``io`` phase at SF 0.002: supplier and nation read
    from ``sqlite3`` by each package (``read_database`` over a connection,
    ``read_database_uri`` from the file), joined with lineitem and summed
    per nation, equal to each other and to ``testing/phases.io_oracle``."""
    from polars_tpu_torch.testing import phases

    raw = pdsh_torch.generate_pdsh(0.002, tables=("lineitem", "supplier", "nation"))
    path = str(tmp / "pdsh.sqlite")
    conn = phases.io_database(raw["supplier"], raw["nation"], path)
    line = {c: raw["lineitem"][c] for c in phases.IO_LINE_COLUMNS}
    outs = []
    for pl in (plt, plj):
        supp = pl.read_database(phases.IO_SUPPLIER_QUERY, conn)
        nat = pl.read_database_uri(phases.IO_NATION_QUERY, f"sqlite://{path}")
        outs.append(phases.io_plan(pl, pl.DataFrame(line), supp, nat).collect())
    conn.close()
    got, ref = outs
    _assert_frames_match(got, ref, rtol=1e-9)
    want = phases.io_oracle(raw["lineitem"], raw["supplier"], raw["nation"])
    assert got["n_name"].to_list() == list(want["n_name"]) and got["lines"].to_list() == want["lines"].tolist()
    np.testing.assert_allclose(got["revenue"].to_numpy(), want["revenue"], rtol=1e-9)


def test_q1_filter_matches_polars_tpu(frames, tmp_path):
    _check_scan_differential(tmp_path)
    _check_io_faults(tmp_path)
    _check_io_phase(tmp_path)
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


def test_q1_on_frames_built_by_the_port(frames, tmp_path):
    """The port's own ingest (string encoding, dates) gives the same codes;
    and its readers and writers pass the JAX package's scan and IO test
    files (``IO_REFERENCE_FILES`` with the port as ``pl``), but for what
    ``WAITING`` names. ``test_hive_scan.py::test_prefetch_propagates_errors``
    expects any exception of a streaming collect, and passes because
    ``collect`` refuses ``engine=`` (item 6)."""
    from test_torch_eager import IO_REFERENCE_FILES, run_reference_files

    run_reference_files(IO_REFERENCE_FILES, tmp_path)
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


def test_import_is_isolated_from_jax(tmp_path):
    """The package imports neither JAX nor ``polars_tpu``, and runs where
    neither pyarrow nor pandas can be imported (the card's machine): it
    builds a frame and collects Q1 there, and a scan raises ``ImportError``
    naming pyarrow."""
    path = tmp_path / "x.parquet"
    plt.DataFrame({"a": [1, 2]}, device="cpu").write_parquet(path)
    code = f"""
import sys
sys.modules["pyarrow"] = sys.modules["pandas"] = None
import numpy as np
import polars_tpu_torch as pl
from polars_tpu_torch.testing import pdsh
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "polars_tpu")]
assert not bad, bad
raw = pdsh.generate_pdsh(0.001, tables=("lineitem",))["lineitem"]
out = pdsh.q1(pl.DataFrame(raw, device="cpu")).collect()
kept = int((raw["l_shipdate"] <= np.datetime64("1998-09-02")).sum())
assert out["count_order"].sum() == kept > 0, (out, kept)
pl.set_default_device("cpu")
try:
    pl.scan_parquet({str(path)!r}).collect()
except ImportError as e:
    assert "pyarrow" in str(e), e
else:
    raise AssertionError("a scan without pyarrow did not raise")
"""
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_no_quiet_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    plt.set_default_device("cuda")
    with pytest.raises(plt.ComputeError, match="no CUDA device"):
        plt.DataFrame({"a": [1, 2, 3]})
    assert plt.DataFrame({"a": [1, 2, 3]}, device="cpu").height == 3

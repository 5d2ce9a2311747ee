"""PDS-H Q3 and Q4 through both packages, and the pieces they run: the
sort-based group-by, slices and top-k sorts, string literals and compares.

The same data, made from a numpy seed, goes through ``polars_tpu`` (JAX on
the CPU) and ``polars_tpu_torch`` (``device="cpu"``). Keys, dates, strings
and counts must be equal; floats agree to rtol 1e-9 (the two engines sum in
different orders). ``test_sorted_group_ctx_puts_all_nulls_in_one_group``
also runs the group-bys over no rows that ``tests/test_torch_eager.py``
keeps (``_check_zero_row_group_bys``).
"""

from __future__ import annotations

import datetime as dtm
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import polars_tpu as plj
import polars_tpu_torch as plt
from polars_tpu.engine import groupby as GJ
from polars_tpu.engine.common import Val as ValJ
from polars_tpu.kernels import argsort as AJ
from polars_tpu.testing import pdsh as pdsh_jax
from polars_tpu_torch.engine import groupby as GT
from polars_tpu_torch.engine.common import Val as ValT
from polars_tpu_torch.kernels import argsort as AT
from polars_tpu_torch.testing import pdsh as pdsh_torch
from test_torch_eager import _check_zero_row_group_bys, _release_compiled_programs

Q3_COLS = {
    "customer": ["c_custkey", "c_mktsegment"],
    "orders": ["o_orderkey", "o_custkey", "o_orderdate", "o_shippriority"],
    "lineitem": ["l_orderkey", "l_shipdate", "l_extendedprice", "l_discount"],
}
Q4_COLS = {
    "orders": ["o_orderkey", "o_orderdate", "o_orderpriority"],
    "lineitem": ["l_orderkey", "l_commitdate", "l_receiptdate"],
}


@pytest.fixture(autouse=True)
def _cpu_default_device():
    prev = plt.set_default_device("cpu")
    yield
    plt.set_default_device(prev)


def _assert_frames_match(got, want, *, rtol=1e-9):
    assert [(n, repr(d)) for n, d in got.schema.items()] == [(n, repr(d)) for n, d in want.schema.items()]
    g, w = got.to_dict(as_series=False), want.to_dict(as_series=False)
    for name, wcol in w.items():
        if isinstance(want.schema[name], plj.datatypes.FloatType):
            assert [v is None for v in g[name]] == [v is None for v in wcol], name
            gv = np.asarray([np.nan if v is None else v for v in g[name]], np.float64)
            wv = np.asarray([np.nan if v is None else v for v in wcol], np.float64)
            np.testing.assert_allclose(gv, wv, rtol=rtol, equal_nan=True, err_msg=name)
        else:
            assert g[name] == wcol, name


def _tables(seed: int, cols: dict) -> tuple[dict, dict]:
    raw = pdsh_jax.generate_pdsh(0.003, seed=seed, tables=tuple(cols))
    want = {t: plj.DataFrame({c: raw[t][c] for c in cs}) for t, cs in cols.items()}
    got = {t: plt.DataFrame({c: raw[t][c] for c in cs}, device="cpu") for t, cs in cols.items()}
    return want, got


@pytest.mark.parametrize("seed", [42, 7])
def test_q3_matches_polars_tpu(seed):
    fj, ft = _tables(seed, Q3_COLS)
    want = pdsh_jax.q3(fj["customer"], fj["orders"], fj["lineitem"]).collect()
    got = pdsh_torch.q3(ft["customer"], ft["orders"], ft["lineitem"]).collect()
    assert want.height == 10
    _assert_frames_match(got, want)


@pytest.mark.parametrize("seed", [42, 7])
def test_q4_matches_polars_tpu(seed):
    fj, ft = _tables(seed, Q4_COLS)
    want = pdsh_jax.q4(fj["orders"], fj["lineitem"]).collect()
    got = pdsh_torch.q4(ft["orders"], ft["lineitem"]).collect()
    assert want.height == 5
    _assert_frames_match(got, want)


def test_q3_q4_kernel_calls(monkeypatch):
    """Q3 sums its revenue through K1 once, at capacity = the joined rows
    (the sorted group-by), and compacts the 10 rows of its 4 columns with K2
    once; Q4 counts 6 dense key slots with K1 and compacts them with K2."""
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
    _, ft = _tables(42, {**Q3_COLS, "orders": Q3_COLS["orders"] + ["o_orderpriority"],
                         "lineitem": Q3_COLS["lineitem"] + ["l_commitdate", "l_receiptdate"]})
    n = ft["lineitem"].height
    pdsh_torch.q3(ft["customer"], ft["orders"], ft["lineitem"]).collect()
    assert calls == [("K1", n, [torch.float64]), ("K2", n, 4)]
    calls.clear()
    pdsh_torch.q4(ft["orders"], ft["lineitem"]).collect()
    assert calls == [("K1", 6, [None]), ("K2", 6, 2)]


# ---------------------------------------------------------------------------
# sort-based group-by
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def keyed():
    """Keys of every kind the sorted group-by takes: ints, dates, floats with
    NaN and -0.0, nullable ints, strings, bools, and a row mask."""
    rng = np.random.default_rng(11)
    n = 240
    f = rng.choice(np.asarray([1.5, -2.0, 0.0, -0.0, np.nan, 3.25]), n)
    data = {
        "i": rng.integers(-4, 5, n),
        "d": (np.datetime64("1995-01-01") + rng.integers(0, 6, n)).astype("datetime64[D]"),
        "f": f,
        "n": [None if r < 0.15 else int(v) for r, v in zip(rng.random(n), rng.integers(0, 4, n))],
        "s": np.asarray(["x", "y", "z"], object)[rng.integers(0, 3, n)],
        "b": rng.random(n) < 0.5,
        "v": rng.normal(size=n),
        "w": rng.integers(0, 100, n),
    }
    return plj.DataFrame(data), plt.DataFrame(data, device="cpu")


@pytest.mark.parametrize("maintain_order", [False, True])
@pytest.mark.parametrize("keys", [("i",), ("d",), ("f",), ("n",), ("i", "d"), ("f", "n", "s"), ("s", "b", "i")])
def test_sorted_group_by_matches_polars_tpu(keyed, keys, maintain_order):
    df_j, df_t = keyed

    def plan(pl, df):
        out = (
            df.lazy()
            .filter(pl.col("w") > 10)
            .group_by(*keys, maintain_order=maintain_order)
            .agg(pl.col("v").sum().alias("vs"), pl.col("w").max().alias("wmax"), pl.len().alias("n_rows"),
                 pl.col("v").mean().alias("vm"))
        )
        return out if maintain_order else out.sort(*keys, nulls_last=True)

    want = plan(plj, df_j).collect()
    assert want.height > 1
    _assert_frames_match(plan(plt, df_t).collect(), want)


def test_dense_group_by_keeps_first_occurrence_order(keyed):
    """maintain_order=True on dictionary keys (the dense path) renumbers the
    groups by their first row, counts and decoded keys alike."""
    df_j, df_t = keyed

    def plan(pl, df):
        return df.lazy().filter(pl.col("w") > 50).group_by("s", "b", maintain_order=True).agg(
            pl.len().alias("n_rows"), pl.col("v").sum().alias("vs"))

    _assert_frames_match(plan(plt, df_t).collect(), plan(plj, df_j).collect())


def _key_vals(n, seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(-3, 4, n)
    f = rng.choice(np.asarray([0.5, -0.0, 0.0, np.nan, -1.0]), n)
    valid = rng.random(n) < 0.8
    rowmask = rng.random(n) < 0.7
    return a, f, valid, rowmask


def test_sorted_group_ctx_matches_jax():
    """Group ids, count and validity of the rows the mask keeps; rows outside
    the mask may carry any id. The null rows hold one value here: the JAX
    package reads the storage under a null into the key word (see the next
    test)."""
    a, f, valid, rowmask = _key_vals(500, 2)
    f = np.where(valid, f, 0.5)

    def run_jax(a, f, valid, rowmask):
        keys = [ValJ(a, None, plj.Int64()), ValJ(f, valid, plj.Float64())]
        g = GJ.sorted_group_ctx(keys, rowmask)
        r = GJ.reorder_by_first_occurrence(g, rowmask)
        return g.gids, g.num_groups, g.group_valid, r.gids

    gj, nj, vj, rj = jax.jit(run_jax)(jnp.asarray(a), jnp.asarray(f), jnp.asarray(valid), jnp.asarray(rowmask))
    keys = [ValT(torch.from_numpy(a), None, plt.Int64()),
            ValT(torch.from_numpy(f), torch.from_numpy(valid), plt.Float64())]
    m = torch.from_numpy(rowmask)
    g = GT.sorted_group_ctx(keys, m)
    r = GT.reorder_by_first_occurrence(g, m)
    assert int(g.num_groups) == int(nj)
    np.testing.assert_array_equal(g.group_valid.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(g.gids.numpy()[rowmask], np.asarray(gj)[rowmask])
    np.testing.assert_array_equal(r.gids.numpy()[rowmask], np.asarray(rj)[rowmask])


def test_sorted_group_ctx_puts_all_nulls_in_one_group():
    """Null keys form one group whatever their storage holds (Polars). The
    JAX package splits them by the value under the null (ROADMAP section 3),
    so this is held to the count of distinct valid keys plus one."""
    a, f, valid, rowmask = _key_vals(500, 3)
    keys = [ValT(torch.from_numpy(f), torch.from_numpy(valid), plt.Float64())]
    g = GT.sorted_group_ctx(keys, torch.from_numpy(rowmask))
    kept = rowmask & valid
    distinct = len(np.unique(np.where(f[kept] == 0, 0.0, f[kept]).astype(str)))
    assert int(g.num_groups) == distinct + 1
    null_ids = g.gids.numpy()[rowmask & ~valid]
    assert len(null_ids) > 1 and (null_ids == null_ids[0]).all()
    jax_groups = jax.jit(lambda f, v, m: GJ.sorted_group_ctx([ValJ(f, v, plj.Float64())], m).num_groups)(
        jnp.asarray(f), jnp.asarray(valid), jnp.asarray(rowmask))
    assert int(jax_groups) > int(g.num_groups)
    _release_compiled_programs()
    _check_zero_row_group_bys()


def test_boundaries_from_words_matches_jax():
    rng = np.random.default_rng(9)
    w1 = rng.integers(0, 3, 400)
    w2 = rng.integers(-2, 2, 400).astype(np.int32)
    perm_j = jax.jit(lambda a, b: AJ.stable_argsort_words([a, b]))(jnp.asarray(w1), jnp.asarray(w2))
    want = jax.jit(lambda a, b, p: AJ.boundaries_from_words([a, b], p))(jnp.asarray(w1), jnp.asarray(w2), perm_j)
    words = [torch.from_numpy(w1), torch.from_numpy(w2)]
    perm = AT.stable_argsort_words(words)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(perm_j))
    np.testing.assert_array_equal(AT.boundaries_from_words(words, perm).numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# slices, top-k sorts, string literals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "case", ["head", "limit", "slice_negative", "slice_open", "slice_past_end", "sort_head", "sort_desc_mixed"]
)
def test_slices_and_sorts_match_polars_tpu(keyed, case):
    df_j, df_t = keyed

    def plan(pl, df):
        lf = df.lazy().filter(pl.col("w") % 3 != 0)
        if case == "head":
            return lf.head(7)
        if case == "limit":
            return lf.limit(3)
        if case == "slice_negative":
            return lf.slice(-9, 4)
        if case == "slice_open":
            return lf.slice(150)
        if case == "slice_past_end":
            return lf.slice(-1000, 5)
        if case == "sort_head":
            return lf.sort("v", descending=True).head(10)
        return lf.sort(["f", "d", "i"], descending=[True, False, True], nulls_last=True).head(25)

    want = plan(plj, df_j).collect()
    _assert_frames_match(plan(plt, df_t).collect(), want)


@pytest.mark.parametrize("limit", [0, 5, 1000])
def test_sort_limit_matches_polars_tpu(keyed, limit):
    """A sort node with a ``limit`` (fused top-k) keeps its first rows."""
    from polars_tpu.plan import logical as LJ
    from polars_tpu_torch.plan import logical as LT

    df_j, df_t = keyed

    def plan(pl, L, df):
        lf = df.lazy().filter(pl.col("w") > 20)
        by = (pl.col("v")._node, pl.col("i")._node)
        return pl.LazyFrame._from_node(L.LSort(lf._node, by, (True, False), (False, False), False, limit))

    want = plan(plj, LJ, df_j).collect()
    _assert_frames_match(plan(plt, LT, df_t).collect(), want)


@pytest.mark.parametrize(
    "case", ["eq_literal", "eq_absent_literal", "ne_literal", "lt_literal", "ge_absent_literal",
             "literal_on_left", "eq_columns_two_dictionaries", "lt_columns_two_dictionaries"]
)
def test_string_compares_match_polars_tpu(case):
    rng = np.random.default_rng(13)
    n = 120
    data = {
        "a": np.asarray(["AUTOMOBILE", "BUILDING", "FURNITURE", None], object)[rng.integers(0, 4, n)],
        "b": np.asarray(["BUILDING", "HOUSEHOLD", "AUTOMOBILE", "ZEBRA", "CAT"], object)[rng.integers(0, 5, n)],
    }
    df_j, df_t = plj.DataFrame(data), plt.DataFrame(data, device="cpu")

    def plan(pl, df):
        e = {
            "eq_literal": pl.col("a") == "BUILDING",
            "eq_absent_literal": pl.col("a") == "NOT THERE",
            "ne_literal": pl.col("a") != "FURNITURE",
            "lt_literal": pl.col("a") < "BUILDING",
            "ge_absent_literal": pl.col("b") >= "DOG",
            "literal_on_left": pl.lit("C") < pl.col("b"),
            "eq_columns_two_dictionaries": pl.col("a") == pl.col("b"),
            "lt_columns_two_dictionaries": pl.col("a") < pl.col("b"),
        }[case]
        return df.lazy().with_columns(r=e).filter(pl.col("r") | pl.col("a").__eq__("AUTOMOBILE"))

    want = plan(plj, df_j).collect()
    got = plan(plt, df_t).collect()
    _assert_frames_match(got, want)


def test_q3_q4_run_without_jax():
    """The port's Q3 and Q4 run in a process that never imports JAX or
    polars_tpu."""
    code = (
        "import sys, polars_tpu_torch as pl; "
        "from polars_tpu_torch.testing import pdsh; "
        "raw = pdsh.generate_pdsh(0.003, tables=('customer', 'orders', 'lineitem')); "
        "f = {t: pl.DataFrame(v, device='cpu') for t, v in raw.items()}; "
        "assert pdsh.q3(f['customer'], f['orders'], f['lineitem']).collect().height == 10; "
        "assert pdsh.q4(f['orders'], f['lineitem']).collect().height == 5; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'polars_tpu' or m.startswith('polars_tpu.')]; "
        "assert not bad, bad"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=300)


def test_join_then_group_dates_kept(keyed):
    """A Date key gathered through a join groups and sorts as a date."""
    df_j, df_t = keyed

    def plan(pl, df, other):
        return (
            df.lazy().join(other.lazy(), on="i", how="inner", validate="m:1")
            .filter(pl.col("d") > dtm.date(1995, 1, 2))
            .group_by("d", "tag").agg(pl.col("v").sum().alias("vs"))
            .sort(["vs", "d"], descending=[True, False])
        )

    other = {"i": np.arange(-4, 5), "tag": np.asarray(list("abcabcabc"), object)}
    want = plan(plj, df_j, plj.DataFrame(other)).collect()
    _assert_frames_match(plan(plt, df_t, plt.DataFrame(other, device="cpu")).collect(), want)

"""The expressions PDS-H needs, each case against ``polars_tpu`` on the same
frame: ``is_in``, ``is_between``, when/then/otherwise, ``str.starts_with``,
``~``, Boolean casts, one-row selects of aggregations; ``str.contains``
(literal, regex, an invalid pattern), ``starts_with``/``ends_with`` with an
expression right-hand side, ``str.slice``, and the ``n_unique``, ``first``
and ``last`` aggregations.

The port runs on the CPU (``device="cpu"``). Keys, strings, booleans and
counts must be equal; floats agree to rtol 1e-9.
"""

from __future__ import annotations

import numpy as np
import pytest

import polars_tpu as plj
import polars_tpu_torch as plt


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


@pytest.fixture(scope="module")
def frame():
    """40 rows: a group key, ints, floats and strings with nulls, a bool."""
    rng = np.random.default_rng(5)
    n = 40
    nulls = rng.random(n) < 0.2
    data = {
        "k": np.asarray(["p", "q", "r"], object)[rng.integers(0, 3, n)],
        "i": [None if z else int(v) for z, v in zip(nulls, rng.integers(0, 6, n))],
        "f": np.where(rng.random(n) < 0.15, np.nan, rng.integers(0, 9, n) / 2.0),  # NaN = null
        "s": [None if z else str(v) for z, v in zip(rng.random(n) < 0.2,
                                                    np.asarray(["apple", "apricot", "bean", "b", ""])
                                                    [rng.integers(0, 5, n)])],
        "b": rng.random(n) < 0.5,
        "v": rng.normal(size=n),
    }
    return plj.DataFrame(data), plt.DataFrame(data, device="cpu")


def _check(frame, plan, *, min_rows=1):
    df_j, df_t = frame
    want = plan(plj, df_j).collect()
    assert want.height >= min_rows
    _assert_frames_match(plan(plt, df_t).collect(), want)


# -- is_in ------------------------------------------------------------------------

IS_IN_CASES = {
    "int": ("i", [1, 3, 99]),
    "int_with_null": ("i", [1, None]),
    "int_in_floats": ("i", [1.0, 2.5]),
    "float": ("f", [1.5, 2.0, 7.5]),
    "float_with_null": ("f", [0.5, None]),
    "float_in_ints": ("f", [1, 3]),
    "string": ("s", ["apple", "zz", "b"]),
    "string_with_null": ("s", ["bean", None]),
    "one_int": ("i", [3]),
    "one_string": ("s", ["apricot"]),
    "absent_strings": ("s", ["zz", "yy"]),
}
# polars_tpu pads a literal list to the frame's rows with zeros
# (compiler.py:79-84), and a list without nulls has no validity to mask the
# padding: 0 is "in" every numeric list of two or more values. The port is
# held to Polars semantics (the oracle below) there, and to polars_tpu
# everywhere else.
REFERENCE_PADS_THE_LIST = {"int", "int_in_floats", "float", "float_in_ints"}


def _is_in_oracle(values: list, listed: list, nulls_equal: bool) -> list:
    present = [x for x in listed if x is not None]
    if nulls_equal:
        return [(None in listed) if x is None else x in present for x in values]
    return [None if x is None else x in present for x in values]


@pytest.mark.parametrize("nulls_equal", [False, True])
@pytest.mark.parametrize("case", sorted(IS_IN_CASES))
def test_is_in(frame, case, nulls_equal):
    col, listed = IS_IN_CASES[case]

    def plan(pl, df):
        return df.lazy().select(pl.col(col), pl.col(col).is_in(listed, nulls_equal=nulls_equal).alias("hit"))

    got = plan(plt, frame[1]).collect()
    values, hits = got[col].to_list(), got["hit"].to_list()
    assert hits == _is_in_oracle(values, listed, nulls_equal)
    assert None in values and any(hits) == (case != "absent_strings")
    if case not in REFERENCE_PADS_THE_LIST:
        _check(frame, plan)


def test_is_in_filters_and_negates(frame):
    """Q12's shapes: is_in as a filter, and its negation cast and summed."""
    _check(frame, lambda pl, df: df.lazy().filter(pl.col("s").is_in(["apple", "bean", "b"]))
           .group_by("k").agg(hi=pl.col("s").is_in(["apple", "b"]).cast(pl.Int64).sum(),
                              lo=(~pl.col("s").is_in(["apple", "b"])).cast(pl.Int64).sum()).sort("k"), min_rows=3)


# -- is_between ---------------------------------------------------------------------


@pytest.mark.parametrize("closed", ["both", "left", "right", "none"])
@pytest.mark.parametrize("bounds", ["int_literals", "typed_int64", "floats", "int_column"])
def test_is_between(frame, closed, bounds):
    def plan(pl, df):
        if bounds == "int_literals":  # Q19: untyped ints against a Float64 column
            e = pl.col("f").is_between(1, 3, closed=closed)
        elif bounds == "typed_int64":  # Int64 bounds widen to Float64
            e = pl.col("f").is_between(pl.lit(1, dtype=pl.Int64), pl.lit(3, dtype=pl.Int64), closed=closed)
        elif bounds == "floats":  # Q6
            e = pl.col("f").is_between(1.5, 3.5, closed=closed)
        else:  # an Int64 column against float bounds, nulls in the column
            e = pl.col("i").is_between(1.0, 4.0, closed=closed)
        return df.lazy().select(pl.col("f"), pl.col("i"), e.alias("in_range"))

    _check(frame, plan)


# -- when / then / otherwise ------------------------------------------------------------

WHEN_CASES = {
    # a null predicate (f null) picks the otherwise branch
    "null_predicate": lambda pl: pl.when(pl.col("f") > 2).then(pl.col("v")).otherwise(pl.col("f")),
    "no_otherwise": lambda pl: pl.when(pl.col("b")).then(pl.col("i")),
    "null_then": lambda pl: pl.when(pl.col("b")).then(None).otherwise(pl.col("f")),
    "null_branch_values": lambda pl: pl.when(pl.col("v") > 0).then(pl.col("i")).otherwise(pl.col("f")),
    "literal_branches": lambda pl: pl.when(pl.col("i") >= 3).then(1).otherwise(0),
    "chained": lambda pl: pl.when(pl.col("i") == 1).then(pl.lit(10.5)).when(pl.col("f") > 3).then(pl.col("v"))
    .otherwise(-1.0),
    "strings": lambda pl: pl.when(pl.col("b")).then(pl.col("s")).otherwise(pl.lit("zz")),
    "string_column_branches": lambda pl: pl.when(pl.col("b")).then(pl.col("s")).otherwise(pl.col("k")),
}


@pytest.mark.parametrize("case", sorted(WHEN_CASES))
def test_when_then_otherwise(frame, case):
    _check(frame, lambda pl, df: df.lazy().select(pl.col("i"), WHEN_CASES[case](pl).alias("w")))


def test_when_then_output_name(frame):
    _check(frame, lambda pl, df: df.lazy().select(pl.when(pl.col("v") > 0).then(pl.col("f")).otherwise(0.0)))


@pytest.mark.parametrize("agg", ["sum", "mean", "max"])
def test_when_then_in_a_group_by(frame, agg):
    """Q14's shape, per group: a when/then/otherwise aggregated."""
    _check(frame, lambda pl, df: df.lazy().group_by("k").agg(
        getattr(pl.when(pl.col("s").str.starts_with("ap")).then(pl.col("v")).otherwise(0.0), agg)().alias("x"),
        pl.col("v").sum().alias("total")).sort("k"), min_rows=3)


# -- str.starts_with, ~ and casts ------------------------------------------------------------


@pytest.mark.parametrize("prefix", ["ap", "b", "", "zz"])
def test_starts_with(frame, prefix):
    _check(frame, lambda pl, df: df.lazy().select(pl.col("s"), pl.col("s").str.starts_with(prefix).alias("sw")))


@pytest.mark.parametrize("case", ["bool_column", "compare_with_nulls", "is_in"])
def test_invert(frame, case):
    e = {"bool_column": lambda pl: ~pl.col("b"), "compare_with_nulls": lambda pl: ~(pl.col("i") > 2),
         "is_in": lambda pl: ~pl.col("s").is_in(["b", "bean"])}[case]
    _check(frame, lambda pl, df: df.lazy().select(pl.col("i"), e(pl).alias("inv")))


@pytest.mark.parametrize("target", ["Int64", "Int32", "Float64"])
def test_bool_cast_summed_per_group(frame, target):
    _check(frame, lambda pl, df: df.lazy().group_by("k").agg(
        n_big=(pl.col("v") > 0).cast(getattr(pl, target)).sum(), n_b=pl.col("b").cast(getattr(pl, target)).sum(),
    ).sort("k"), min_rows=3)


def test_cast_keeps_nulls(frame):
    _check(frame, lambda pl, df: df.lazy().select((pl.col("i") > 2).cast(pl.Int64).alias("c"),
                                                  pl.col("i").cast(pl.Float64).alias("x")))


# -- one-row selects --------------------------------------------------------------------

ONE_ROW_CASES = {
    "float": lambda pl: [pl.col("v").sum().alias("s"), pl.col("v").mean().alias("m"),
                         pl.col("v").min().alias("lo"), pl.col("v").max().alias("hi"), pl.len()],
    "nullable": lambda pl: [pl.col("i").sum().alias("s"), pl.col("f").mean().alias("m"),
                            pl.col("i").min().alias("lo"), pl.col("f").max().alias("hi"),
                            pl.col("i").count().alias("n")],
    "ratio": lambda pl: [(100.0 * pl.when(pl.col("b")).then(pl.col("v")).otherwise(0.0).sum()
                          / pl.col("v").sum()).alias("share")],
    "int_and_bool_sums": lambda pl: [pl.col("i").sum().alias("s"), (pl.col("v") > 0).sum().alias("pos")],
    "aggregate_inside_a_sum": lambda pl: [((pl.col("v") - pl.col("v").mean()) * pl.col("v")).sum().alias("ss")],
}


@pytest.mark.parametrize("filtered", ["some_rows", "no_rows"])
@pytest.mark.parametrize("case", sorted(ONE_ROW_CASES))
def test_one_row_select(frame, case, filtered):
    """A select of only aggregations is one row, also when every row is
    filtered out: a sum of nothing is 0, a mean, min or max null, a ratio of
    empty sums NaN."""
    cut = 0.0 if filtered == "some_rows" else 1e9
    _check(frame, lambda pl, df: df.lazy().filter(pl.col("v") > -cut).select(ONE_ROW_CASES[case](pl)))


def test_aggregates_broadcast_in_with_columns(frame):
    _check(frame, lambda pl, df: df.lazy().with_columns(
        (pl.col("v") - pl.col("v").mean()).alias("centered"), pl.col("i").max().alias("imax")))


# -- str.contains, ends_with, slice ------------------------------------------------------


@pytest.fixture(scope="module")
def words():
    """Two string columns with nulls, where ``b`` is now and then a prefix or
    a suffix of ``a``."""
    a = ["apple", "apricot", None, "banana", "band", "", "cherry", "ba", "nan", "apple", "grape", "an"]
    b = ["ap", "cot", "x", None, "ban", "", "rry", "banana", "n", "le", None, "a"]
    return plj.DataFrame({"a": a, "b": b}), plt.DataFrame({"a": a, "b": b}, device="cpu")


def test_string_predicates_and_slices(words):
    """One select per package: literal and regex ``contains`` (the empty
    pattern, anchors, alternation), ``starts_with``/``ends_with`` with a
    literal, a column and a literal expression on the right, and ``slice``
    with positive and negative offsets, with and without a length."""
    def plan(pl, df):
        a = pl.col("a")
        return df.lazy().select(
            a.str.contains("an", literal=True).alias("lit"),
            a.str.contains("", literal=True).alias("lit_empty"),
            a.str.contains("a.*o").alias("rx"),
            a.str.contains("^b|y$").alias("rx_anchor"),
            a.str.contains("(an){2}").alias("rx_group"),
            a.str.ends_with("e").alias("ew"),
            a.str.ends_with("").alias("ew_empty"),
            a.str.starts_with(pl.col("b")).alias("sw_col"),
            a.str.ends_with(pl.col("b")).alias("ew_col"),
            a.str.ends_with(pl.lit("na")).alias("ew_lit"),
            a.str.slice(0, 2).alias("s02"),
            a.str.slice(1).alias("s1"),
            a.str.slice(-3).alias("s_m3"),
            a.str.slice(-3, 2).alias("s_m3_2"),
            a.str.slice(-2, 5).alias("s_m2_5"),
            a.str.slice(4, 3).alias("s4_3"),
            a.str.slice(0, 0).alias("s00"),
        )
    _check(words, plan)


def test_contains_invalid_pattern(words):
    """An invalid regex raises ``ComputeError`` by default (``strict``), and
    gives nulls with ``strict=False``."""
    for pl, df in zip((plj, plt), words):
        with pytest.raises(pl.ComputeError, match="invalid regex"):
            df.lazy().select(pl.col("a").str.contains("(a")).collect()
    _check(words, lambda pl, df: df.lazy().select(pl.col("a").str.contains("(a", strict=False).alias("c")))


def test_slice_result_groups_and_compares(words):
    """A sliced column is a string column of its own dictionary: it groups,
    sorts and compares with literals (as Q22's country codes do)."""
    _check(words, lambda pl, df: df.lazy()
           .with_columns(pl.col("a").str.slice(0, 2).alias("p"))
           .filter(pl.col("p").is_in(["ap", "ba", ""]) | (pl.col("p") > "c"))
           .group_by("p").agg(pl.len()).sort("p"), min_rows=3)


# -- n_unique, first, last -----------------------------------------------------------------

NUNIQUE_CASES = {
    # a dictionary key (the dense group-by), a nullable int key (the sorted
    # one) and no key (one group)
    "dense": lambda pl, lf, aggs: lf.group_by("k").agg(aggs).sort("k"),
    "sorted": lambda pl, lf, aggs: lf.group_by("i").agg(aggs).sort("i"),
    "one_group": lambda pl, lf, aggs: lf.select(aggs),
}


@pytest.mark.parametrize("case", sorted(NUNIQUE_CASES))
def test_n_unique_first_last(frame, case):
    """``n_unique`` counts a null as one value; ``first`` and ``last`` take a
    group's first and last row in frame order, nulls included; all three
    after a filter."""
    def plan(pl, df):
        aggs = [pl.col("i").n_unique().alias("nu_i"), pl.col("f").n_unique().alias("nu_f"),
                pl.col("s").n_unique().alias("nu_s"), pl.col("b").n_unique().alias("nu_b"),
                pl.col("i").first().alias("i0"), pl.col("s").first().alias("s0"), pl.col("f").last().alias("f1"),
                pl.col("s").last().alias("s1"), pl.col("v").first().alias("v0")]
        return NUNIQUE_CASES[case](pl, df.lazy().filter(pl.col("v") > -1.0), aggs)
    _check(frame, plan, min_rows={"dense": 3, "sorted": 4, "one_group": 1}[case])


def test_n_unique_counts_nulls_as_one_value():
    """Nulls are one value to ``n_unique`` whatever their storage holds: an
    integer division by zero leaves the dividend under each null.
    ``polars_tpu`` counts such nulls one by one (4 and 5 below; ROADMAP
    section 3), so the port is held to Polars' answer here."""
    df = plt.DataFrame({"g": [1, 1, 1, 1, 2], "x": [10, 20, 30, 40, 50], "z": [0, 0, 0, 1, 0]}, device="cpu")
    q = df.lazy().with_columns((plt.col("x") // plt.col("z")).alias("d"))
    assert q.collect()["d"].to_list() == [None, None, None, 40, None]
    got = q.group_by("g").agg(plt.col("d").n_unique().alias("nu")).sort("g").collect()
    assert got.to_dict(as_series=False) == {"g": [1, 2], "nu": [2, 1]}
    assert q.select(plt.col("d").n_unique()).collect()["d"].to_list() == [2]

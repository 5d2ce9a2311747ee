"""The frame operations the optimizer's passes rewrite, through the port and
``polars_tpu``: ``unique`` (every ``keep``, with and without ``subset`` and
``maintain_order``), ``rename`` (a mapping and a callable), ``drop``,
``with_row_index`` (with an offset), lazy ``concat`` (vertical, relaxed and
horizontal, string columns of different dictionaries) and ``cache``.

The same numpy-seeded frames go through both packages, on the CPU. Integers,
strings and counts must be equal, floats to rtol 1e-9. ``unique(keep="any")``
keeps an arbitrary row of each key, so there only the subset's rows are
compared, as a set, with their count. Where ``polars_tpu`` is wrong the port
is held to Polars' semantics, written out here: its predicate pushdown moves
a filter below ``unique(keep="any"/"none")`` whatever columns it reads
(ROADMAP section 3).

Each test loops over its cases inside (a failure names its case), so the
suite's item count grows by a few items only.
"""

from __future__ import annotations

import itertools

import numpy as np
import pytest

import polars_tpu as plj
import polars_tpu_torch as plt
from polars_tpu.plan.optimizer import optimize as optimize_jax
from polars_tpu_torch.plan import logical as L
from polars_tpu_torch.plan.optimizer import optimize


@pytest.fixture(autouse=True)
def _cpu_default_device():
    prev = plt.set_default_device("cpu")
    yield
    plt.set_default_device(prev)


def _each(cases, check) -> None:
    """``check(case)`` for every case; a failure names its case."""
    for case in cases:
        try:
            check(case)
        except AssertionError as e:
            raise AssertionError(f"case {case!r}: {e}") from e


def _assert_frames_match(got, want):
    """Equal schemas and values, in order (floats to rtol 1e-9)."""
    assert [(n, repr(d)) for n, d in got.schema.items()] == [(n, repr(d)) for n, d in want.schema.items()]
    g, w = got.to_dict(as_series=False), want.to_dict(as_series=False)
    for name, wcol in w.items():
        if repr(want.schema[name]).startswith("Float"):
            assert [v is None for v in g[name]] == [v is None for v in wcol], name
            gv = np.asarray([np.nan if v is None else v for v in g[name]], np.float64)
            wv = np.asarray([np.nan if v is None else v for v in wcol], np.float64)
            np.testing.assert_allclose(gv, wv, rtol=1e-9, equal_nan=True, err_msg=name)
        else:
            assert g[name] == wcol, name


def _rows(frame, cols) -> list:
    d = frame.to_dict(as_series=False)
    return list(zip(*(d[c] for c in cols)))


@pytest.fixture(scope="module")
def data():
    """Ints with repeats and nulls, floats with a NaN and -0.0, strings with
    nulls, and a second frame with strings of another dictionary."""
    rng = np.random.default_rng(23)
    n = 300
    k = rng.integers(0, 12, n)
    s = np.asarray(["ant", "bee", "cat", "dog", "eel"], object)[rng.integers(0, 5, n)]
    x = np.round(rng.normal(size=n), 2)
    x[::37] = np.nan
    x[5::41] = -0.0
    return {
        "k": [None if i % 29 == 0 else int(v) for i, v in enumerate(k)],
        "s": [None if i % 31 == 0 else v for i, v in enumerate(s)],
        "x": x,
        "v": rng.integers(-50, 50, n),
    }


def _frames(data):
    other = {"k": [7, 8, 9], "s": ["yak", "bee", "zebu"], "x": [0.5, 1.5, 2.5], "v": [1, 2, 3]}
    return ((plj.DataFrame(data), plj.DataFrame(other)),
            (plt.DataFrame(data, device="cpu"), plt.DataFrame(other, device="cpu")))


def test_unique_matches_the_reference(data):
    (dj, _), (dt_, _) = _frames(data)
    subsets = [None, ["k"], ["s"], ["k", "s"], ["x"], ["k", "x"]]

    def check(case):
        subset, keep, maintain = case
        got = dt_.lazy().unique(subset=subset, keep=keep, maintain_order=maintain)
        want = dj.lazy().unique(subset=subset, keep=keep, maintain_order=maintain).collect()
        for no_opt in (False, True):
            out = got.collect(no_optimization=no_opt)
            if keep == "any":
                cols = subset or list(data)
                assert out.height == want.height
                assert sorted(_rows(out, cols), key=repr) == sorted(_rows(want, cols), key=repr)
            else:
                _assert_frames_match(out, want)

    _each(list(itertools.product(subsets, ["any", "first", "last", "none"], [False, True])), check)
    _check_unique_keeps_polars_rules()


def _check_unique_keeps_polars_rules():
    """Against Python: a null is one value whatever lies under it, NaN one
    value, -0.0 equal to 0.0; rows filtered away before the unique count
    for nothing; the kept rows stay in their order."""
    x = plt.DataFrame({"x": [1.0, float("nan"), -0.0, 0.0, None, float("nan"), None, 2.0]}, device="cpu")
    out = x.lazy().unique(keep="first", maintain_order=True).collect()["x"].to_list()
    assert out[0] == 1.0 and np.isnan(out[1]) and out[2:] == [0.0, None, 2.0]
    assert x.lazy().unique(keep="none").collect()["x"].to_list() == [1.0, 2.0]
    k = plt.DataFrame({"k": [1, 2, 1, 3, 2, 1], "v": [1, 2, 3, 4, 5, 6]}, device="cpu")
    q = k.lazy().filter(plt.col("v") > 1).unique(subset=["k"], keep="last", maintain_order=True)
    assert q.collect().to_dict(as_series=False) == {"k": [3, 2, 1], "v": [4, 5, 6]}
    q = k.lazy().filter(plt.col("v") > 1).unique(subset=["k"], keep="none")
    assert q.collect().to_dict(as_series=False) == {"k": [3], "v": [4]}
    # nulls of a divide by zero keep their dividend under them
    z = plt.DataFrame({"a": [10, 20, 30, 40], "b": [0, 0, 0, 1]}, device="cpu")
    out = z.lazy().select(q=plt.col("a") // plt.col("b")).unique(keep="first", maintain_order=True).collect()
    assert out["q"].to_list() == [None, 40]


def test_unique_pushdown_follows_polars():
    """A filter moves below ``unique`` only where every column it reads is
    in the subset. ``polars_tpu`` moves it whatever it reads, for keep "any"
    and "none", and so answers differently optimized and unoptimized; the
    port gives Polars' answer both ways."""
    data = {"k": [1, 1, 2], "v": [1, 2, 3]}
    lt, lj = plt.DataFrame(data, device="cpu").lazy(), plj.DataFrame(data).lazy()
    # both rows of key 1 are duplicates, so keep="none" drops them before the filter
    qt = lt.unique(subset=["k"], keep="none").filter(plt.col("v") == 1)
    qj = lj.unique(subset=["k"], keep="none").filter(plj.col("v") == 1)
    for no_opt in (False, True):
        assert qt.collect(no_optimization=no_opt).to_dict(as_series=False) == {"k": [], "v": []}
    assert qj.collect(no_optimization=True).to_dict(as_series=False) == {"k": [], "v": []}
    assert qj.collect().to_dict(as_series=False) == {"k": [1], "v": [1]}  # the reference's fault
    # keep="any" keeps one row of key 1, the first here: v == 2 finds none
    qt = lt.unique(subset=["k"], keep="any", maintain_order=True).filter(plt.col("v") == 2)
    qj = lj.unique(subset=["k"], keep="any", maintain_order=True).filter(plj.col("v") == 2)
    for no_opt in (False, True):
        assert qt.collect(no_optimization=no_opt).to_dict(as_series=False) == {"k": [], "v": []}
    assert qj.collect().to_dict(as_series=False) == {"k": [1], "v": [2]}  # the reference's fault
    # the port's plans: a filter on the subset moves below, one on v stays above
    plan = optimize(lt.unique(subset=["k"], keep="none").filter((plt.col("v") == 1) & (plt.col("k") > 0))._node)
    assert isinstance(plan, L.LFilter) and isinstance(plan.input, L.LDistinct)
    assert isinstance(plan.input.input, L.LFilter)
    assert "'v'" in repr(plan.predicate) and "'k'" in repr(plan.input.input.predicate)
    plan_j = optimize_jax(lj.unique(subset=["k"], keep="none").filter(plj.col("v") == 1)._node)
    assert type(plan_j).__name__ == "LDistinct"  # the reference pushed the filter below
    # with no subset, every column counts: the filter moves below
    plan = optimize(lt.unique(keep="any").filter(plt.col("v") == 1)._node)
    assert isinstance(plan, L.LDistinct) and isinstance(plan.input, L.LFilter)


def test_rename_drop_with_row_index(data):
    (dj, _), (dt_, _) = _frames(data)

    def cases(pl, df):
        c = pl.col
        lf = df.lazy()
        return {
            "rename_mapping": lf.rename({"k": "key", "s": "name"}),
            "rename_callable": lf.rename(lambda n: n.upper() + "_"),
            "rename_swap": lf.rename({"k": "v", "v": "k"}),
            "rename_then_filter": lf.rename({"x": "y"}).filter(c("y") > 0).select("y", "k"),
            "drop": lf.drop("x", "s"),
            "drop_list": lf.drop(["x"]).filter(c("v") < 0),
            "row_index": lf.with_row_index(),
            "row_index_offset": lf.with_row_index("i", offset=100),
            "row_index_after_filter": lf.filter(c("v") > 10).with_row_index("i", offset=5),
            "row_index_filtered": lf.with_row_index("i").filter(c("v") > 10).select("i", "v"),
            "row_index_head": lf.with_row_index("i").head(7),
            "all_three": lf.with_row_index("row", offset=1).rename({"row": "r", "k": "key"}).drop("s")
            .filter(c("key") > 3).group_by("key").agg(c("r").max(), c("x").sum()).sort("key"),
        }

    cj, ct = cases(plj, dj), cases(plt, dt_)

    # two cases are held to the reference's plan as written (ROADMAP section
    # 3): a filter after with_row_index keeps the numbers of the rows that
    # pass, where the reference's optimizer moves it below the index and
    # renumbers them; and its projection pushdown prunes the column a strict
    # drop names, so that drop raises
    as_written = {"row_index_filtered", "all_three"}

    def check(name):
        want = cj[name].collect(no_optimization=name in as_written)
        for no_opt in (False, True):
            _assert_frames_match(ct[name].collect(no_optimization=no_opt), want)

    _each(list(ct), check)
    assert ct["row_index_filtered"].collect()["i"].to_list()[:3] == [0, 1, 3]
    assert cj["row_index_filtered"].collect()["i"].to_list()[:3] == [0, 1, 2]  # the reference's fault
    with pytest.raises(plj.ColumnNotFoundError):
        cj["all_three"].collect()  # the reference's fault
    assert repr(ct["row_index_offset"].collect().schema["i"]) == "UInt32"
    with pytest.raises(plt.ColumnNotFoundError):
        dt_.lazy().drop("nope").collect()
    with pytest.raises(plt.ColumnNotFoundError):
        dt_.lazy().rename({"nope": "n"}).collect()
    with pytest.raises(plt.DuplicateError):
        dt_.lazy().rename({"k": "v"}).collect()
    assert dt_.lazy().drop("nope", strict=False).collect().columns == list(data)


def test_lazy_concat(data):
    (dj, oj), (dt_, ot) = _frames(data)

    def cases(pl, df, other):
        c = pl.col
        lf, ol = df.lazy(), other.lazy()
        return {
            "vertical": pl.concat([lf, ol]),
            "vertical_three": pl.concat([lf.filter(c("v") > 40), ol, lf.filter(c("v") < -45)]),
            "vertical_strings_of_two_dictionaries": pl.concat([lf.select("s"), ol.select("s")])
            .group_by("s").agg(pl.len()).sort("s"),
            "vertical_relaxed": pl.concat([lf.select("k", "v"), ol.select("k", (c("x") * 2).alias("v"))],
                                          how="vertical_relaxed"),
            "vertical_then_unique": pl.concat([lf.select("s"), ol.select("s")]).unique(maintain_order=True,
                                                                                       keep="first"),
            "horizontal": pl.concat([lf.select("k", "s"), lf.select(c("x").alias("x2"), c("v").alias("v2"))],
                                    how="horizontal"),
            "horizontal_filtered": pl.concat([lf.filter(c("v") > 0).select("k"),
                                              lf.filter(c("v") > 0).select(c("s").alias("s2"))], how="horizontal"),
            "single": pl.concat([lf]),
            # the filter of one input reads a column nothing above needs
            "vertical_pruned": pl.concat([lf, lf.filter(c("v") > 40)]).group_by("k").agg(c("x").sum()).sort("k"),
            "vertical_pruned_first": pl.concat([lf.filter(c("v") > 40), lf]).group_by("k").agg(c("x").sum())
            .sort("k"),
        }

    cj, ct = cases(plj, dj, oj), cases(plt, dt_, ot)

    def check(name):
        # the reference's projection pushdown leaves the filtered input of
        # "vertical_pruned_first" a column the other lacks, and its concat
        # then fails (ROADMAP section 3): held to its plan as written
        want = cj[name].collect(no_optimization=name == "vertical_pruned_first")
        for no_opt in (False, True):
            _assert_frames_match(ct[name].collect(no_optimization=no_opt), want)

    _each(list(ct), check)
    with pytest.raises(KeyError):
        cj["vertical_pruned_first"].collect()  # the reference's fault
    _check_concat_against_polars(dt_, ot)


def _check_concat_against_polars(df, other):
    """Polars' rules where the reference has none to compare: columns of
    different names raise; a horizontal concat lines up each input's rows in
    order and pads a shorter input with nulls; strings merge dictionaries."""
    with pytest.raises(plt.SchemaError):
        plt.concat([df.lazy().select("k"), other.lazy().select("v")]).collect()
    a = plt.DataFrame({"a": [1, 2, 3, 4]}, device="cpu").lazy()
    b = plt.DataFrame({"b": ["p", "q", "r", "s"]}, device="cpu").lazy()
    out = plt.concat([a.filter(plt.col("a") % 2 == 0), b], how="horizontal").collect()
    assert out.to_dict(as_series=False) == {"a": [2, 4, None, None], "b": ["p", "q", "r", "s"]}
    out = plt.concat([b.filter(plt.col("b") > "q"), a.filter(plt.col("a") > 1)], how="horizontal").collect()
    assert out.to_dict(as_series=False) == {"b": ["r", "s", None], "a": [2, 3, 4]}
    s1 = plt.DataFrame({"s": ["x", "y"]}, device="cpu").lazy()
    s2 = plt.DataFrame({"s": ["y", "z", "w"]}, device="cpu").lazy()
    out = plt.concat([s1, s2]).sort("s").collect()
    assert out["s"].to_list() == ["w", "x", "y", "y", "z"]


def test_cache_and_the_frameops_phase_at_a_small_size():
    """``cache`` returns the frame itself (common-subplan elimination finds
    repeats); the chip's frameops queries (``testing/phases.py``) over a
    small lineitem give the reference's frames, optimized and as written,
    and the cached per-order group-by runs once when optimized."""
    from polars_tpu.testing import pdsh as pdsh_jax
    from polars_tpu_torch.engine import executors as X
    from polars_tpu_torch.testing import phases

    lt = plt.DataFrame({"a": [1]}, device="cpu").lazy()
    assert lt.cache() is lt
    raw = pdsh_jax.generate_pdsh(0.002, seed=3, tables=("lineitem",))["lineitem"]
    cols = {k: raw[k] for k in phases.FRAMEOPS_COLUMNS}
    pt, pj = phases.frameops_plans(plt, plt.DataFrame(cols, device="cpu")), phases.frameops_plans(plj, plj.DataFrame(cols))

    def check(name):
        want = pj[name].collect()
        for no_opt in (False, True):
            _assert_frames_match(pt[name].collect(no_optimization=no_opt), want)

    _each(list(pt), check)
    traced = []
    inner = X._trace_groupby

    def counting(tt, node, tc):
        traced.append(len(node.keys) and node.keys[0])
        return inner(tt, node, tc)

    try:
        X._trace_groupby = counting
        for no_opt, per_order in ((False, 1), (True, 2)):
            traced.clear()
            pt["cache"].collect(no_optimization=no_opt)
            assert sum(repr(k) == "EColumn(name='l_orderkey')" for k in traced) == per_order, traced
    finally:
        X._trace_groupby = inner

"""The frame operations the optimizer's passes rewrite, through the port and
``polars_tpu``: ``unique`` (every ``keep``, with and without ``subset`` and
``maintain_order``), ``rename`` (a mapping and a callable), ``drop``,
``with_row_index`` (with an offset), lazy ``concat`` (vertical, relaxed and
horizontal, string columns of different dictionaries) and ``cache``; and
the reshaping, the concat kinds, a user's functions, the generators and
the expressions of ROADMAP item 4b (``_check_reshape_differential``), with
the chip's ``reshape`` phase at a small size.

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
    _check_reshape_phase(raw)
    _check_reshape_differential()


def _check_reshape_phase(raw: dict) -> None:
    """The chip's ``reshape`` phase (``testing/phases.py``) over a small
    lineitem: both packages' frames and the phase's numpy oracle (keys,
    counts and strings exact, sums and means to rtol 1e-9)."""
    from test_torch_eager import _release_compiled_programs

    from polars_tpu_torch.testing import phases

    _release_compiled_programs()
    cols = {k: raw[k] for k in phases.RESHAPE_COLUMNS}
    want = phases.reshape_oracle(cols)
    pt = phases.reshape_plans(plt, plt.DataFrame(cols, device="cpu"))
    pj = phases.reshape_plans(plj, plj.DataFrame(cols))
    for name, floats, strings in (("pivot", list(want["pivot"])[1:], ()),
                                  ("unpivot", ("sum", "mean"), ("variable", "l_returnflag"))):
        got = pt[name]().collect()
        phases.check_reshape(got, want[name], f"reshape.{name}", floats=floats, strings=strings)
        _assert_frames_match(got, pj[name]().collect())


def _reshape_data(seed: int, n: int = 24) -> dict:
    """Keys with repeats and nulls, a String key, floats with nulls, dates."""
    import datetime as dtm

    rng = np.random.default_rng(seed)
    return {"ix": rng.integers(0, 5, n).tolist(), "on": [["a", "b", "c"][int(i)] for i in rng.integers(0, 3, n)],
            "v": [None if rng.random() < 0.15 else float(np.round(rng.normal() * 10, 3)) for _ in range(n)],
            "w": rng.integers(-50, 50, n).tolist(), "g": rng.integers(0, 3, n).tolist(),
            "d0": [dtm.date(2024, 1, 1) + dtm.timedelta(days=int(x)) for x in rng.integers(0, 20, n)],
            "span": rng.integers(0, 4, n).tolist()}


def _pivot_oracle(data: dict, values: list, agg) -> dict:
    """Polars' pivot in Python: a row per ``ix`` in order of first
    appearance, a column per (value, ``on`` value) in order of first
    appearance, each cell ``agg`` of its rows' non-null values (null for a
    cell without rows)."""
    rows = list(zip(data["ix"], data["on"], *[data[v] for v in values]))
    ixs, ons = list(dict.fromkeys(data["ix"])), list(dict.fromkeys(data["on"]))
    out = {"ix": ixs}
    for j, v in enumerate(values):
        for o in ons:
            cells = [[r[2 + j] for r in rows if r[0] == i and r[1] == o] for i in ixs]
            name = o if len(values) == 1 else f"{v}_{o}"
            out[name] = [agg([x for x in cell if x is not None]) if cell else None for cell in cells]
    return out


def _check_reshape_differential() -> None:
    """Reshaping, the concat kinds, a user's functions, the generators and
    the expressions of ROADMAP item 4b on seeded frames, through both
    packages where the reference compiles little and against Python
    oracles as well (integers, strings, dates and null masks exact,
    floats to rtol 1e-9). Where the reference differs from Polars the port
    is held to Polars (ROADMAP section 3): ``pivot`` without an aggregation
    over a cell of several rows raises (the reference takes the first); a
    lazy diagonal concat aligns its inputs (the reference fails); a head
    stays above a user's function of the whole column (the reference hands
    it the first rows only); ``is_sorted`` per group beside another
    aggregation reads each group in its order (the reference does not);
    ``value_counts(normalize=True)`` names its share "proportion" (the
    reference: "count"). Values drawn at random (``sample``,
    ``shuffle``) are held to their properties."""
    import datetime as dtm

    from test_torch_eager import _release_compiled_programs

    _release_compiled_programs()
    data = _reshape_data(11)
    ft, fj = plt.DataFrame(data, device="cpu"), plj.DataFrame(data)
    c, cj = plt.col, plj.col
    n = len(data["w"])

    def both(make, sort=None):
        """``make(pl, frame)`` through both packages, the same frame."""
        got, want = make(plt, ft), make(plj, fj)
        if sort is not None:
            got, want = got.sort(sort), want.sort(sort)
        _assert_frames_match(got, want)
        return got

    # pivot: several values, an aggregation per cell, sorted columns
    _assert_frames_match(ft.pivot("on", index="ix", values=["v", "w"], aggregate_function="sum"),
                         fj.pivot("on", index="ix", values=["v", "w"], aggregate_function="sum"))
    for agg, fn in (("max", max), ("len", len), ("mean", lambda xs: sum(xs) / len(xs) if xs else None)):
        got = ft.pivot("on", index="ix", values=["v"] if agg == "mean" else ["w"], aggregate_function=agg)
        want = _pivot_oracle(data, ["v"] if agg == "mean" else ["w"], fn)
        g = got.to_dict(as_series=False)
        assert list(g) == list(want), agg
        for k in want:
            np.testing.assert_allclose(np.asarray(g[k], float), np.asarray(want[k], float), rtol=1e-9, err_msg=k)
    srt = ft.pivot("on", values="w", index="ix", aggregate_function="first", sort_columns=True)
    assert srt.columns == ["ix", "a", "b", "c"]
    sums = both(lambda pl, f: f.select("on", "w").pivot("on", values="w", aggregate_function="sum", sort_columns=True))
    assert sums.rows() == [tuple(sum(x for x, o in zip(data["w"], data["on"]) if o == k) for k in "abc")]  # no index
    with pytest.raises(plt.ComputeError, match="multiple elements"):  # Polars; the reference takes the first
        ft.pivot("on", index="ix", values="w")

    # unpivot / melt (rows of the first on column, then the second), transpose
    unp = both(lambda pl, f: f.unpivot(["v", "w"], index=["ix", "on"]))  # the reference: a select per column
    assert unp.schema["value"] == plt.Float64()
    assert unp.rows() == [(i, o, "v", v) for i, o, v in zip(data["ix"], data["on"], data["v"])] + \
        [(i, o, "w", float(x)) for i, o, x in zip(data["ix"], data["on"], data["w"])]
    long = both(lambda pl, f: f.melt(id_vars="on", value_vars=["w", "g"])).rows()
    assert long == [(o, "w", w) for o, w in zip(data["on"], data["w"])] + \
        [(o, "g", g) for o, g in zip(data["on"], data["g"])]
    keep = ft.lazy().unpivot(["w", "g"], index="ix").filter(c("value") > 0).collect().rows()
    assert keep == [r for r in zip(data["ix"] * 2, ["w"] * n + ["g"] * n, data["w"] + data["g"]) if r[2] > 0]
    _assert_frames_match(ft.select("ix", "w", "g").transpose(include_header=True),
                         fj.select("ix", "w", "g").transpose(include_header=True))

    # the concat kinds, of frames and of lazy frames (built from the data: no reference compile)
    def frame(pl, cols, rows):
        return pl.DataFrame({k: [data[src][r] for r in rows] for k, src in cols.items()})

    head5, tail4 = range(5), range(n - 4, n)

    def halves(pl):
        return frame(pl, {"ix": "ix", "w": "w"}, head5), frame(pl, {"ix": "ix", "v": "v", "on": "on"}, tail4)

    def keyed(pl):  # the first row of each key, sorted by it
        firsts = [{data["ix"][r]: r for r in reversed(rows)} for rows in (head5, tail4)]
        return [frame(pl, cols, [f[k] for k in sorted(f)]) for cols, f in
                zip(({"ix": "ix", "w": "w"}, {"ix": "ix", "v": "v", "on": "on"}), firsts)]

    a, b = halves(plt)
    ra, rb = a.rows(named=True), b.rows(named=True)
    names = ["ix", "w", "v", "on"]
    diag = [{k: r.get(k) for k in names} for r in ra + rb]
    assert both(lambda pl, f: pl.concat(halves(pl), how="diagonal")).rows(named=True) == diag
    assert plt.concat([a.lazy(), b.lazy()], how="diagonal").collect().rows(named=True) == diag
    relaxed = both(lambda pl, f: pl.concat([halves(pl)[0], frame(pl, {"ix": "ix", "w": "v"}, tail4)],
                                           how="diagonal_relaxed"))
    assert relaxed.schema["w"] == plt.Float64() and relaxed["w"].to_list() == \
        [float(x) for x in data["w"][:5]] + data["v"][-4:]
    assert both(lambda pl, f: pl.concat([frame(pl, {"w": "w"}, range(4)), frame(pl, {"on": "on"}, tail4)],
                                        how="horizontal")).rows() == list(zip(data["w"][:4], data["on"][-4:]))
    both(lambda pl, f: pl.concat([frame(pl, {"w": "w"}, head5), frame(pl, {"w": "v"}, tail4)], how="vertical_relaxed"))
    la, lb = keyed(plt)
    aligned = both(lambda pl, f: pl.concat(keyed(pl), how="align"))
    wa, wb = dict(la.select("ix", "w").rows()), {r[0]: r[1:] for r in lb.rows()}
    assert aligned.rows() == [(k, wa.get(k), *wb.get(k, (None, None))) for k in sorted(set(wa) | set(wb))]
    assert la["ix"].to_list() == sorted(set(data["ix"][:5])) and lb["ix"].to_list() == sorted(set(data["ix"][-4:]))

    # a user's functions in a select and in a group-by
    udf = both(lambda pl, f: f.select(pl.col("w").map_batches(lambda s: s * 2).alias("w2"),
                                      pl.col("v").map_elements(lambda x: x + 1.0, return_dtype=pl.Float64).alias("v1"),
                                      pl.map_batches(["w", "g"], lambda ss: ss[0] + ss[1]).alias("wg")))
    assert udf.rows() == [(w * 2, None if v is None else v + 1.0, w + g) for w, v, g in
                          zip(data["w"], data["v"], data["g"])]
    dots = both(lambda pl, f: f.group_by("g").agg(pl.map_groups(["w", "ix"], lambda ss: float((ss[0] * ss[1]).sum()),
                                                                returns_scalar=True).alias("dot")).sort("g"))
    assert dots.rows() == [(g, float(sum(w * i for w, i, g2 in zip(data["w"], data["ix"], data["g"]) if g2 == g)))
                           for g in sorted(set(data["g"]))]
    first3 = both(lambda pl, f: f.lazy().map_batches(lambda d: d.select("w", "g").head(3),
                                                     schema={"w": pl.Int64, "g": pl.Int64}).collect())
    assert first3.rows() == list(zip(data["w"][:3], data["g"][:3]))
    with pytest.raises(plt.SchemaError):  # Polars' validate_output_schema: the input's schema when none is given
        ft.lazy().map_batches(lambda d: d.select("w", "g")).collect()
    mean = np.mean([x for x in data["v"] if x is not None])  # the head stays above a whole-column function
    centred = ft.lazy().select(c("v").map_batches(lambda s: s - s.mean())).head(3).collect()["v"].to_list()
    np.testing.assert_allclose(np.asarray(centred, float), np.asarray(
        [None if x is None else x - mean for x in data["v"][:3]], float), rtol=1e-9)
    assert "Slice" in ft.lazy().select(c("v").map_elements(lambda x: x)).head(3).explain().splitlines()[1]
    sums = both(lambda pl, f: f.select(pl.col("w").rolling_map(lambda s: s.sum(), 3)))  # the input's dtype
    assert sums.schema["w"] == plt.Int64() and sums["w"].to_list() == [None, None] + \
        [sum(data["w"][i - 2:i + 1]) for i in range(2, n)]

    # generators: ranges per row, a lazy date range from column bounds
    _assert_frames_match(ft.select(plt.int_ranges(c("g"), c("g") + c("span")).alias("ir"),
                                   plt.date_ranges(c("d0"), c("d0") + plt.duration(days=c("span"))).alias("dr"),
                                   plt.linear_spaces(c("g"), 5.0, 3).alias("ls")),
                         fj.select(plj.int_ranges(cj("g"), cj("g") + cj("span")).alias("ir"),
                                   plj.date_ranges(cj("d0"), cj("d0") + plj.duration(days=cj("span"))).alias("dr"),
                                   plj.linear_spaces(cj("g"), 5.0, 3).alias("ls")))
    steps = plt.DataFrame({"a": [3, 4], "s": [None, 2], "z": [1, 0], "k": [2, -1]}, device="cpu")
    assert steps.select(plt.int_ranges(0, "a", "s")).to_series().to_list() == [None, [0, 2]]  # a null step: null
    for bad in (plt.int_ranges(0, "a", "z"), c("a").repeat_by("k")):  # read with the total, before it is used
        with pytest.raises(plt.ComputeError, match="zero|negative"):
            steps.select(bad)
    lo, hi = min(data["d0"]), max(data["d0"])
    assert both(lambda pl, f: f.lazy().select(pl.date_range(pl.col("d0").min(), pl.col("d0").max(), "3d").alias("r"))
                .collect())["r"].to_list() == [lo + dtm.timedelta(days=3 * k) for k in range((hi - lo).days // 3 + 1)]
    assert both(lambda pl, f: pl.select(pl.datetime_range(dtm.datetime(2024, 1, 1), dtm.datetime(2024, 1, 2), "5h",
                                                          closed="left"))).to_series().to_list() == \
        [dtm.datetime(2024, 1, 1) + dtm.timedelta(hours=5 * k) for k in range(5)]

    # the expressions of item 4b, through both packages (a select per output length) and against Python
    s_t, w = plt.Series("w", data["w"], device="cpu"), data["w"]
    runs = [(len(list(grp)), k) for k, grp in itertools.groupby(w)]
    assert both(lambda pl, f: f.select(pl.col("w").rle())).to_series().to_list() == \
        [{"len": m, "value": k} for m, k in runs]
    assert s_t.rle().to_list() == [{"len": m, "value": k} for m, k in runs]
    assert both(lambda pl, f: f.select(pl.col("w").extend_constant(7, 3))).to_series().to_list() == w + [7, 7, 7]
    assert both(lambda pl, f: f.select(pl.col("w").reshape((-1, 4)))).to_series().to_list() == \
        [w[i:i + 4] for i in range(0, n, 4)]
    top = max(w.count(x) for x in w)
    assert both(lambda pl, f: f.select(pl.col("w").mode()), sort="w").to_series().to_list() == \
        sorted({x for x in w if w.count(x) == top})
    edges = [-50, -10, 0, 10, 50]
    assert both(lambda pl, f: f.select(pl.col("w").hist(bins=edges))).to_series().to_list() == \
        [sum(1 for x in w if (lo_ < x <= hi_) or (i == 0 and x == lo_)) for i, (lo_, hi_) in
         enumerate(zip(edges, edges[1:]))]
    assert both(lambda pl, f: f.select(pl.arg_where(pl.col("w") > 10))).to_series().to_list() == \
        [i for i, x in enumerate(w) if x > 10]
    assert both(lambda pl, f: f.select(pl.col("w").is_sorted(), pl.col("w").sort().is_sorted().alias("s"))).row(0) \
        == (w == sorted(w), True)
    counts = both(lambda pl, f: f.select(pl.col("ix").value_counts()).unnest("ix"), sort="ix")
    assert dict(counts.rows()) == {i: data["ix"].count(i) for i in set(data["ix"])}
    rows = both(lambda pl, f: f.select(pl.col("on").repeat_by("span"), pl.cum_fold(0, lambda x, y: x + y, ["w", "g"]),
                                       pl.cum_sum_horizontal("w", "ix"),
                                       pl.rolling_cov("w", "ix", window_size=4), pl.from_epoch("w", "d").alias("e")))
    assert rows["on"].to_list() == [[o] * k for o, k in zip(data["on"], data["span"])]
    assert rows.select("cum_fold", "cum_sum").rows() == [({"w": x, "g": x + g}, {"w": x, "ix": x + i}) for x, g, i in
                                                         zip(w, data["g"], data["ix"])]
    both(lambda pl, f: f.select(pl.rolling_corr("w", "ix", window_size=4).alias("rc"), pl.row_index().alias("ri"),
                                pl.cum_reduce(lambda x, y: x + y, ["w", "g"]).alias("cr"),
                                pl.concat_arr("w", "g").alias("ca"), pl.col("w").repeat_by(2).alias("w2"),
                                pl.struct("w", "g").name.prefix_fields("p_").alias("sp")))
    both(lambda pl, f: f.select("w", pl.col("w").extend_constant(1, 2).sum().alias("s"),
                                pl.col("w").sample(5, seed=1).len().alias("n")))
    both(lambda pl, f: pl.select(pl.time_range(interval="5h").alias("t"), pl.repeat(3, 5).alias("r")))
    shares = ft.select(c("on").value_counts(sort=True, normalize=True)).unnest("on")  # the reference: "count"
    assert shares.rows() == sorted(((o, data["on"].count(o) / n) for o in set(data["on"])), key=lambda r: -r[1])
    assert shares.columns == ["on", "proportion"]
    both(lambda pl, f: f.group_by("g").agg(pl.col("ix").mode().alias("m")), sort="g")
    # the reference's is_sorted per group beside another aggregation is wrong (ROADMAP section 3)
    got = ft.group_by("g").agg(c("ix").mode().alias("m"), c("w").is_sorted().alias("s")).sort("g")
    for g, m, srt_ in got.rows():
        xs = [i for i, g2 in zip(data["ix"], data["g"]) if g2 == g]
        assert m == sorted({x for x in xs if xs.count(x) == max(xs.count(y) for y in xs)}), g
        ws = [x for x, g2 in zip(w, data["g"]) if g2 == g]
        assert srt_ == (ws == sorted(ws)), g
    sample = s_t.sample(10, seed=3)
    assert len(sample) == 10 and sample.to_list() == s_t.sample(10, seed=3).to_list()
    idx = list(range(n))
    assert sorted(plt.Series("i", idx, device="cpu").sample(10, seed=4).to_list()) == \
        plt.Series("i", idx, device="cpu").sample(10, seed=4).to_list()  # without replacement: distinct, in order
    assert len(set(plt.Series("i", idx, device="cpu").sample(10, seed=4).to_list())) == 10
    assert sorted(s_t.shuffle(seed=5).to_list()) == sorted(w)

    # frame helpers
    assert both(lambda pl, f: f.select("w").unstack(step=5)).rows()[0] == tuple(w[i] for i in range(0, n, 5))
    dummies = both(lambda pl, f: f.select("on").to_dummies())
    assert dummies.columns == ["on_a", "on_b", "on_c"]
    assert dummies.rows() == [tuple(int(o == x) for x in "abc") for o in data["on"]]
    upd = both(lambda pl, f: f.select("ix", "w").update(pl.DataFrame({"ix": [0, 3], "w": [100, None]}), on="ix"))
    assert upd["w"].to_list() == [100 if i == 0 else x for i, x in zip(data["ix"], w)]
    merged = both(lambda pl, f: f.select("w").sort("w").merge_sorted(f.select("w").sort("w").head(3), "w"))
    assert merged["w"].to_list() == sorted(w + sorted(w)[:3])

"""The port's plan optimizer against ``polars_tpu``'s.

The same queries, over the same numpy-seeded frames, are built in both
packages and optimized by each (``plan.optimizer.optimize``; the reference
optimizes without compiling anything). The two plans are compared through a
canonical walk written here, not through ``repr`` text, whose dataclass
fields differ between the packages: node by node, the same node kinds in the
same places, with the same expressions (column names, literals, dtypes by
name, a literal Series by its values), projections, pushed predicates, join
``how``s, sort limits, and cache positions (each ``LCache`` numbered by its
first appearance, so two caches of one subplan share a number).

The cases: the 22 PDS-H queries of ``testing/pdsh.py`` at SF 0.003 with
every pass on and with each ``QueryOptFlags`` toggle off in turn; the
in-memory cases of ``tests/test_optimizer.py``, the aggregate case of
``tests/test_cse_expr.py``, and ``tests/test_optflags_batches.py``'s
``test_optflags_gate_each_pass`` over an in-memory frame in place of its
Parquet file. Frames: each PDS-H query optimized and as written
(``no_optimization=True``) in the port; ``tests/test_torch_pdsh.py`` holds
the optimized port against the reference. Keys, strings and counts must be
equal; floats agree to rtol 1e-9.

Each test loops over its cases inside (a failure names its case), so the
suite's item count grows by a few items only.
"""

from __future__ import annotations

import dataclasses
import subprocess
import sys

import numpy as np
import pytest

import polars_tpu as plj
import polars_tpu_torch as plt
from polars_tpu.plan.optimizer import optimize as optimize_jax
from polars_tpu.testing import pdsh as pdsh_jax
from polars_tpu_torch.plan import exprs as E
from polars_tpu_torch.plan import logical as L
from polars_tpu_torch.plan.optimizer import optimize
from polars_tpu_torch.testing import pdsh as pdsh_torch

QUERIES = [f"q{i}" for i in range(1, 23)]
PARAMS = {"q20": {"color": "part"}, "q9": {"color": "color3"}, "q13": {"word1": "comment", "word2": "7"},
          "q2": {"region_name": "ASIA"}, "q8": {"nation_name": "JORDAN"}, "q21": {"nation_name": "JORDAN"}}
FLAGS = ["predicate_pushdown", "projection_pushdown", "simplify_expression", "slice_pushdown", "comm_subplan_elim",
         "comm_subexpr_elim", "collapse_joins", "check_order_observe", "fast_projection", "type_check"]


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


# -- the canonical walk -------------------------------------------------------------


def _canon_value(v):
    if dataclasses.is_dataclass(v) and hasattr(v, "children"):
        return _canon_expr(v)
    if isinstance(v, tuple):
        return tuple(_canon_value(x) for x in v)
    if v is None or isinstance(v, (bool, int, float, str)):
        return (type(v).__name__, v)
    return repr(v)  # a dtype, by name


def _canon_expr(e) -> tuple:
    name = type(e).__name__
    if name == "ESeriesLit":
        return (name, tuple(e.column.to_pylist()))
    return (name, *((f.name, _canon_value(getattr(e, f.name))) for f in dataclasses.fields(e)))


def canon(node, caches: dict | None = None) -> tuple:
    """A plan as nested tuples: each node's kind, its fields but its inputs
    (expressions walked, a scan by its columns and projection, a cache by
    the number of its first appearance), then its inputs'."""
    caches = {} if caches is None else caches
    name = type(node).__name__
    if name == "LCache":
        return (name, caches.setdefault(node.ident, len(caches)), canon(node.input, caches))
    if name == "LDataFrameScan":
        return (name, tuple(node.df.columns), node.projection)
    # every field but the inputs; the reference's LSelect.should_broadcast
    # (always True here) and LUnion.rechunk have no counterpart in the port
    own = tuple((f.name, _canon_value(getattr(node, f.name))) for f in dataclasses.fields(node)
                if f.name not in ("input", "input_left", "input_right", "inputs_", "rechunk", "should_broadcast"))
    return (name, own, tuple(canon(i, caches) for i in node.inputs()))


def _first_difference(a, b, path="plan"):
    if a == b:
        return None
    if isinstance(a, tuple) and isinstance(b, tuple) and len(a) == len(b):
        for i, (x, y) in enumerate(zip(a, b)):
            if x != y:
                return _first_difference(x, y, f"{path}/{i}")
    return f"{path}: reference {str(a)[:400]} != port {str(b)[:400]}"


def assert_same_plan(node_jax, node_torch, flags_jax=None, flags_torch=None) -> None:
    diff = _first_difference(canon(optimize_jax(node_jax, flags_jax)), canon(optimize(node_torch, flags_torch)))
    assert diff is None, diff


def _assert_frames_match(got, want, *, rtol=1e-9, ordered=True):
    """Equal schemas and values (floats to ``rtol``); rows as a sorted set
    where the order is not defined (``unique(keep="any")`` without
    ``maintain_order``)."""
    assert [(n, repr(d)) for n, d in got.schema.items()] == [(n, repr(d)) for n, d in want.schema.items()]
    g, w = got.to_dict(as_series=False), want.to_dict(as_series=False)
    if not ordered:
        g, w = ({k: list(v) for k, v in zip(f, zip(*sorted(zip(*f.values()), key=repr)))} if f[next(iter(f))] else f
                for f in (g, w))
    for name, wcol in w.items():
        if repr(want.schema[name]).startswith("Float"):
            assert [v is None for v in g[name]] == [v is None for v in wcol], name
            gv = np.asarray([np.nan if v is None else v for v in g[name]], np.float64)
            wv = np.asarray([np.nan if v is None else v for v in wcol], np.float64)
            np.testing.assert_allclose(gv, wv, rtol=rtol, equal_nan=True, err_msg=name)
        else:
            assert g[name] == wcol, name


# -- PDS-H ----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pdsh_frames():
    """Every table at SF 0.003 (seed 7), in both packages, and Q22's orders
    cut to their first tenth (as ``tests/test_torch_pdsh.py`` has them)."""
    raw = pdsh_jax.generate_pdsh(0.003, seed=7)
    raw["orders_tenth"] = {c: v[: len(v) // 10] for c, v in raw["orders"].items()}
    return ({t: plj.DataFrame(c) for t, c in raw.items()},
            {t: plt.DataFrame(c, device="cpu") for t, c in raw.items()})


def _queries(q: str, frames) -> tuple:
    """Query ``q`` as a LazyFrame of each package over the same frames."""
    fj, ft = frames
    tables = [("orders_tenth" if (q, t) == ("q22", "orders") else t) for t in pdsh_torch.QUERY_COLUMNS[q]]
    return (getattr(pdsh_jax, q)(*[fj[t] for t in tables], **PARAMS.get(q, {})),
            pdsh_torch.query(q, dict(zip(pdsh_torch.QUERY_COLUMNS[q], [ft[t] for t in tables])), **PARAMS.get(q, {})))


def test_pdsh_plans_match_the_reference(pdsh_frames):
    def check(q):
        lj, lt = _queries(q, pdsh_frames)
        assert_same_plan(lj._node, lt._node)

    _each(QUERIES, check)


def test_pdsh_plans_match_with_each_pass_off(pdsh_frames):
    def check(case):
        q, flag = case
        lj, lt = _queries(q, pdsh_frames)
        if flag == "none":
            assert_same_plan(lj._node, lt._node, plj.QueryOptFlags.none(), plt.QueryOptFlags.none())
        else:
            assert_same_plan(lj._node, lt._node, plj.QueryOptFlags(**{flag: False}),
                             plt.QueryOptFlags(**{flag: False}))

    _each([(q, f) for q in QUERIES for f in (*FLAGS, "none")], check)


def test_pdsh_frames_optimized_and_as_written(pdsh_frames):
    """Each query gives equal frames through its optimized plan and its plan
    as written; Q15 runs its `revenue` group-by once optimized (one K1 call
    fewer), through a cache."""
    from polars_tpu_torch.engine import executors as X
    from polars_tpu_torch.engine import groupby as G
    from polars_tpu_torch.kernels.groupagg import groupagg_sums

    def check(q):
        lt = _queries(q, pdsh_frames)[1]
        _assert_frames_match(lt.collect(), lt.collect(no_optimization=True))

    _each(QUERIES, check)
    calls = []

    def k1(gids, cols, mask, cap):
        calls.append(cap)
        return groupagg_sums(gids, cols, mask, cap)

    lt = _queries("q15", pdsh_frames)[1]
    n_line = pdsh_frames[1]["lineitem"].height
    try:
        X.groupagg_sums = G.groupagg_sums = k1
        for no_opt, revenue_calls in ((True, 2), (False, 1)):
            calls.clear()
            lt.collect(no_optimization=no_opt)
            assert calls.count(n_line) == revenue_calls, (no_opt, calls)
    finally:
        X.groupagg_sums = G.groupagg_sums = groupagg_sums
    assert sum(isinstance(n, L.LCache) for n in _nodes(optimize(lt._node))) == 2


def _nodes(plan) -> list:
    out = [plan]
    for i in plan.inputs():
        out.extend(_nodes(i))
    return out


# -- the cases of tests/test_optimizer.py, tests/test_cse_expr.py and tests/test_optflags_batches.py ------


def _case_frames(pl, cols):
    n = 200
    return {
        "ab": pl.DataFrame({"k": [1, 2], "v": [1, 2]}), "kw": pl.DataFrame({"k": [1, 2], "w": [10, 20]}),
        "a3": pl.DataFrame({"a": [3, 1, 2]}), "a5": pl.DataFrame({"a": [5, 3, 1, 4, 2]}),
        "a1": pl.DataFrame({"a": [1]}), "a12": pl.DataFrame({"a": [1, 2]}),
        "kvs": pl.DataFrame({"k": cols["k"], "v": cols["v"], "s": cols["s"]}),
        "kv5": pl.DataFrame({"k": [1, 2, 3, 1, 2], "v": [1.0, 2.0, 3.0, 4.0, 5.0]}),
        "kv3": pl.DataFrame({"k": [3, 1, 2], "v": [1.0, 2.0, 3.0]}),
        "kv4": pl.DataFrame({"k": [3, 1, 2, 5], "v": [1.0, 2.0, 3.0, 0.5]}),
        "lkx": pl.DataFrame({"k": [1, 2, 3, 1], "x": [10, 20, 30, 40]}),
        "rky": pl.DataFrame({"k": [1, 2, 2], "y": [100, 200, 300]}),
        "lav": pl.DataFrame({"a": [1, 2], "v": [5, 6]}), "raw": pl.DataFrame({"a": [1, 2], "w": [5, 9]}),
        "ksv": pl.DataFrame({"k": ["b", "a", "a"], "v": [3.0, 1.0, 2.0]}),
        "kxt": pl.DataFrame({"k": cols["k"][:n], "x": cols["v"][:n], "t": cols["t"][:n]}),
        "ab100": pl.DataFrame({"a": np.arange(100), "b": np.arange(100) * 1.0}),
        "kl": pl.DataFrame({"k": [1, 2, 3, 4], "l": [[1, 5], None, [], [7, 2, 9]]}),
    }


def _cases(pl, f) -> dict:
    """The in-memory queries of the reference's optimizer tests, built with
    package ``pl`` over its frames ``f``."""
    c = pl.col
    rev = f["kv5"].lazy().group_by("k").agg(c("v").sum().alias("total"))
    ksv = f["ksv"].lazy()
    return {
        "predicate_pushdown_through_join": f["ab"].lazy().join(f["kw"].lazy(), on="k")
        .filter(c("v") > 1).filter(c("w") < 100),
        "predicate_not_pushed_past_slice": f["a3"].lazy().head(2).filter(c("a") > 1),
        "slice_fuses_into_topk": f["a5"].lazy().sort("a").head(2),
        "simplify_constant_folding": f["a1"].lazy().select(c("a") + (pl.lit(2) + pl.lit(3))),
        "boolean_simplify": f["a12"].lazy().filter((c("a") > 1) & pl.lit(True)),
        "explain_runs": f["a1"].lazy().filter(c("a") > 0).select("a"),
        "optimizations_preserve_results": f["kvs"].lazy().filter(c("v") > 0).with_columns(w=c("v") * 2)
        .group_by("k", "s").agg(s2=c("w").sum()).sort("k", "s"),
        "common_subplan_cached": rev.join(rev.select(c("total").max().alias("total")), on="total", how="inner"),
        "sort_collapse": f["kv3"].lazy().sort("v").sort("k"),
        "sort_collapse_keeps_topk": f["kv4"].lazy().sort("v", descending=True).head(2).sort("k"),
        "sort_collapse_keeps_maintain_order": f["kv4"].lazy().sort("v").sort(c("k") // 2, maintain_order=True),
        "collapse_joins_rewrites_filtered_cross": f["lkx"].lazy().join(f["rky"].lazy(), how="cross")
        .filter((c("k") == c("k_right")) & (c("y") > 100)),
        "collapse_joins_keeps_inequality_residual": f["lav"].lazy().join(f["raw"].lazy(), how="cross")
        .filter((c("a") == c("a_right")) & (c("v") < c("w"))),
        "order_observe_agnostic_group_by": ksv.sort("v").group_by("k").agg(c("v").sum()),
        "order_observe_first_keeps_sort": ksv.sort("v").group_by("k").agg(c("v").first()),
        "order_observe_unique_any": ksv.sort("v").unique(subset=["k"]),
        "order_observe_unique_first": ksv.sort("v").unique(subset=["k"], keep="first"),
        "order_observe_through_select": ksv.sort("v").select("k", (c("v") * 2).alias("v")).group_by("k")
        .agg(c("v").sum()),
        "count_star": f["ab100"].lazy().select(pl.len()),
        "count_star_alias": f["ab100"].lazy().select(pl.len().alias("n")),
        "count_star_behind_a_filter": f["ab100"].lazy().filter(c("a") < 70).select(pl.len()),
        # tests/test_cse_expr.py, its aggregate case, and the same blocked by
        # a filter between the definition and the use
        "cse_bare_agg_broadcast": f["kxt"].lazy().with_columns(tot=c("x").sum()).sort("t")
        .with_columns(frac=c("x").sum() / 100.0),
        "cse_agg_blocked_by_filter": f["kxt"].lazy().with_columns(tot=c("x").sum()).filter(c("x") > 0)
        .with_columns(d=c("x").sum()),
        # tests/test_optflags_batches.py, over an in-memory frame
        "optflags_filter_select": f["ab100"].lazy().filter(c("a") > 50).select("b"),
        "optflags_select": f["ab100"].lazy().select("b"),
        "optflags_top_k": f["ab100"].lazy().sort("b", descending=True).head(7),
        "optflags_folds_the_predicate": f["ab100"].lazy().filter(c("a") > (pl.lit(2) + pl.lit(3))),
        # no predicate moves below an explode, on an exploded column or not
        "explode_keeps_its_predicates": f["kl"].lazy().explode("l").filter(c("l") > 1).filter(c("k") > 1)
        .select("l", "k"),
    }


@pytest.fixture(scope="module")
def cases():
    rng = np.random.default_rng(11)
    n = 2000
    cols = {"k": rng.integers(0, 50, n), "v": rng.normal(size=n),
            "s": np.asarray(["a", "b", "c"], object)[rng.integers(0, 3, n)], "t": rng.integers(0, 1000, n)}
    prev = plt.set_default_device("cpu")  # a module fixture runs before the autouse one
    try:
        ft = _case_frames(plt, cols)
    finally:
        plt.set_default_device(prev)
    return _cases(plj, _case_frames(plj, cols)), _cases(plt, ft)


def test_optimizer_cases_match_the_reference(cases):
    """Each case: the same optimized plan in both packages, every flag on
    and with each toggle off in turn, and the same frame (optimized, and
    as written in the port)."""
    cj, ct = cases

    def check(case):
        name, flag = case
        if flag is None:
            assert_same_plan(cj[name]._node, ct[name]._node)
            ordered = name != "order_observe_unique_any"  # keep="any": any row of each key, in any order
            _assert_frames_match(ct[name].collect(), cj[name].collect(), ordered=ordered)
            _assert_frames_match(ct[name].collect(no_optimization=True), cj[name].collect(), ordered=ordered)
        else:
            assert_same_plan(cj[name]._node, ct[name]._node, plj.QueryOptFlags(**{flag: False}),
                             plt.QueryOptFlags(**{flag: False}))

    _each([(n, f) for n in ct for f in (None, *FLAGS)], check)


def test_optimizer_cases_rewrite_as_the_reference_tests_say(cases):
    """The plan-shape assertions of the reference's tests, on the port's
    plans."""
    ct = cases[1]

    def find(name, cls):
        return [n for n in _nodes(optimize(ct[name]._node)) if isinstance(n, cls)]

    join = find("predicate_pushdown_through_join", L.LJoin)[0]
    assert isinstance(join.input_left, L.LFilter) and isinstance(join.input_right, L.LFilter)
    assert isinstance(optimize(ct["predicate_not_pushed_past_slice"]._node), L.LFilter)
    assert ct["predicate_not_pushed_past_slice"].collect()["a"].to_list() == [3]
    assert find("slice_fuses_into_topk", L.LSort)[0].limit == 2 and not find("slice_fuses_into_topk", L.LSlice)
    assert ct["slice_fuses_into_topk"].collect()["a"].to_list() == [1, 2]
    lits = [n for n in E.walk(find("simplify_constant_folding", L.LSelect)[0].expressions[0])
            if isinstance(n, E.ELiteral)]
    assert len(lits) == 1 and lits[0].value == 5
    assert not any(isinstance(n, E.ELiteral) and n.value is True
                   for f in find("boolean_simplify", L.LFilter) for n in E.walk(f.predicate))
    assert "DataFrameScan" in ct["explain_runs"].explain()
    caches = find("common_subplan_cached", L.LCache)
    assert len(caches) == 2 and caches[0] == caches[1]
    assert ct["common_subplan_cached"].collect().to_dict(as_series=False) == {"k": [2], "total": [7.0]}
    assert len(find("sort_collapse", L.LSort)) == 1
    assert ct["sort_collapse_keeps_topk"].collect()["k"].to_list() == [1, 2]
    assert len(find("sort_collapse_keeps_maintain_order", L.LSort)) == 2
    for name in ("collapse_joins_rewrites_filtered_cross", "collapse_joins_keeps_inequality_residual"):
        assert "cross" not in ct[name].explain() and "inner" in ct[name].explain()
        assert "cross" in ct[name].explain(optimizations=plt.QueryOptFlags(collapse_joins=False))
    got = ct["collapse_joins_rewrites_filtered_cross"]
    rows = sorted(zip(*got.collect().to_dict(as_series=False).values()))
    off = got.collect(optimizations=plt.QueryOptFlags(collapse_joins=False))
    assert rows == sorted(zip(*off.to_dict(as_series=False).values())) == [(2, 20, 2, 200), (2, 20, 2, 300)]
    assert list(zip(*ct["collapse_joins_keeps_inequality_residual"].collect().to_dict(as_series=False).values())) \
        == [(2, 6, 2, 9)]
    for name, has_sort in (("order_observe_agnostic_group_by", False), ("order_observe_first_keeps_sort", True),
                           ("order_observe_unique_any", False), ("order_observe_unique_first", True),
                           ("order_observe_through_select", False)):
        assert ("Sort" in ct[name].explain()) == has_sort, name
    assert sorted(ct["order_observe_first_keeps_sort"].collect().to_dict(as_series=False)["v"]) == [1.0, 3.0]
    assert ct["count_star"].explain() == "DataFrameScan [1 cols, 1 rows]"
    assert ct["count_star"].collect().to_dict(as_series=False) == {"len": [100]}
    assert repr(ct["count_star"].collect().schema["len"]) == "UInt32"
    assert ct["count_star_alias"].collect().to_dict(as_series=False) == {"n": [100]}
    assert ct["count_star_behind_a_filter"].collect().to_dict(as_series=False) == {"len": [70]}
    aggs = sum(isinstance(s, E.EAgg) for n in _nodes(optimize(ct["cse_bare_agg_broadcast"]._node))
               for e in n.exprs() for s in E.walk(e))
    assert aggs == 1
    out = ct["cse_bare_agg_broadcast"].collect()
    assert np.allclose(out["frac"].to_numpy(), out["tot"].to_numpy() / 100.0)
    assert sum(isinstance(s, E.EAgg) for n in _nodes(optimize(ct["cse_agg_blocked_by_filter"]._node))
               for e in n.exprs() for s in E.walk(e)) == 2
    _check_literals_of_equal_value_keep_their_types()
    _check_identities_keep_dtypes()
    _check_positional_blocks_pushdown()


def _check_positional_blocks_pushdown():
    """A head, a filter and the removal of a sort stop at a position
    function or a window (``shift(-1)``, ``rank()``, ``rank().over(g)``,
    ``cum_sum()``, the rolling, EWM and cumulative windows): optimized
    equals as written equals Polars' values. The
    reference's slice pushdown (``slice_pushdown.py:25-33``,
    ``_length_changing``) moves the head below them, so its optimized plan
    ranks and shifts the first two rows alone (ROADMAP section 3)."""
    data = {"a": [5, 1, 4, 2, 3], "g": [1, 1, 2, 2, 1]}

    def positional(pl):
        c = pl.col
        return pl.DataFrame(data).lazy().with_columns(r=c("a").rank(), lead=c("a").shift(-1),
                                                      rg=c("a").rank().over("g"), cs=c("a").cum_sum())

    lt = positional(plt)
    want = {"head": {"r": [5.0, 1.0], "lead": [1, 4], "rg": [3.0, 1.0], "cs": [5, 6]},
            "filter": {"r": [5.0, 4.0, 3.0], "lead": [1, 2, None], "rg": [3.0, 2.0, 2.0], "cs": [5, 10, 15]}}
    plans = {"head": lt.head(2), "filter": lt.filter(plt.col("a") > 2)}
    for name, plan in plans.items():
        for label, out in (("optimized", plan.collect()), ("as written", plan.collect(no_optimization=True))):
            got = out.select("r", "lead", "rg", "cs").to_dict(as_series=False)
            assert got == want[name], (name, label, got)
    assert isinstance(optimize(plans["head"]._node), L.LSlice)
    assert isinstance(optimize(plans["filter"]._node), L.LFilter)
    # the reference's optimized head: ranks and the lead of the first two rows alone
    ref = positional(plj).head(2).collect().to_dict(as_series=False)
    assert (ref["r"], ref["lead"], ref["rg"]) == ([2.0, 1.0], [1, None], [2.0, 1.0])
    # the rolling, exponentially weighted and cumulative windows read other
    # rows too: a head or filter stays above them
    w = plt.DataFrame({"a": [5.0, 1.0, 4.0, 2.0, 3.0], "t": [1, 2, 3, 4, 5]}).lazy().with_columns(
        rs=plt.col("a").rolling_sum(3, min_samples=1, center=True), em=plt.col("a").ewm_mean(alpha=0.5),
        rb=plt.col("a").rolling_mean_by("t", "2i"), ce=plt.col("a").cumulative_eval(plt.element().sum()))
    for plan, rows in ((w.head(2), {"rs": [6.0, 10.0], "ce": [5.0, 6.0]}),
                       (w.filter(plt.col("a") > 2), {"rs": [6.0, 7.0, 5.0], "ce": [5.0, 10.0, 15.0]})):
        for out in (plan.collect(), plan.collect(no_optimization=True)):
            assert out.select("rs", "ce").to_dict(as_series=False) == rows
        assert plan.collect().equals(plan.collect(no_optimization=True))
        assert type(optimize(plan._node)) is type(plan._node)
    # a sort under cum_sum is observed: the group-by's maxima need it
    q = plt.DataFrame(data).lazy().sort("a").with_columns(cs=plt.col("a").cum_sum()).group_by("g").agg(
        plt.col("cs").max()).sort("g")
    assert sum(isinstance(n, L.LSort) for n in _nodes(optimize(q._node))) == 2
    for out in (q.collect(), q.collect(no_optimization=True)):
        assert out.to_dict(as_series=False) == {"g": [1, 2], "cs": [15, 10]}


def _check_identities_keep_dtypes():
    """An identity operand goes only where the column keeps its dtype and
    values, as in Polars: ``a * 1.0``, ``a + 0.0`` and ``a / 1`` of an Int64
    ``a`` are Float64, and ``a & 1`` is the low bit of ``a``, so these stay
    as written; ``a + 0`` and ``b & True`` drop their literal. The
    reference rewrites all six (it matches the literal by ``==``, and
    ``1 == 1.0 == True`` in Python), so its frame differs (ROADMAP
    section 3). The port's engine has no integer ``&`` yet, so that one is
    held in the plan only."""
    def build(pl, device, *, low_bit=False):
        c = pl.col
        kw = {"device": device} if device else {}
        exprs = [(c("a") * 1.0).alias("m"), (c("a") + 0.0).alias("p"), (c("a") / 1).alias("d"),
                 (c("a") + 0).alias("z"), (c("b") & True).alias("t")]
        return pl.DataFrame({"a": [1, 2, 6]}, **kw).lazy().with_columns(b=c("a") > 1).select(
            *exprs, *([(c("a") & 1).alias("n")] if low_bit else []))

    want = {"m": [1.0, 2.0, 6.0], "p": [1.0, 2.0, 6.0], "d": [1.0, 2.0, 6.0], "z": [1, 2, 6],
            "t": [False, True, True]}
    want_dtypes = [("m", "Float64"), ("p", "Float64"), ("d", "Float64"), ("z", "Int64"), ("t", "Boolean")]
    lt = build(plt, "cpu")
    for no_opt in (False, True):
        out = lt.collect(no_optimization=no_opt)
        assert [(n, repr(d)) for n, d in out.schema.items()] == want_dtypes, no_opt
        assert out.to_dict(as_series=False) == want, no_opt
    kept = [e.input for e in optimize(build(plt, "cpu", low_bit=True)._node).expressions]
    assert [isinstance(e, E.EBinary) for e in kept] == [True, True, True, False, False, True]
    ref = build(plj, None).collect().schema  # the reference's fault: Int64 where Polars gives Float64
    assert [repr(ref[n]) for n in ("m", "p", "d")] == ["Int64"] * 3


def _check_literals_of_equal_value_keep_their_types():
    """``lit(1)``, ``lit(1.0)`` and ``lit(True)`` compare equal in Python,
    and the compiler's memo keys on equality: each keeps its own dtype
    (``boolean_simplify`` as written needs it). Held to Python, not to
    ``polars_tpu``, whose memo gives the float column integer values
    (ROADMAP section 3)."""
    c = plt.col
    lf = plt.DataFrame({"a": [1, 2]}, device="cpu").lazy().select(
        c("a") + 1, (c("a") + 1.0).alias("f"), ((c("a") > 1) & plt.lit(True)).alias("b"))
    for no_opt in (False, True):
        out = lf.collect(no_optimization=no_opt)
        assert [(n, repr(d)) for n, d in out.schema.items()] == [("a", "Int64"), ("f", "Float64"), ("b", "Boolean")]
        got = out.to_dict(as_series=False)
        assert got == {"a": [2, 3], "f": [2.0, 3.0], "b": [False, True]}
        assert [type(v) for v in got["f"]] == [float, float]


def test_optflags_gate_each_pass(cases):
    """``tests/test_optflags_batches.py``'s checks over an in-memory frame:
    each toggle shows in ``explain``, and ``QueryOptFlags.none()`` gives
    the same frame."""
    ct = cases[1]
    q = ct["optflags_filter_select"]
    on = q.explain()
    assert "Filter" in on and "π ['a', 'b']" in on  # the predicate's column stays live
    assert "π" not in q.explain(optimizations=plt.QueryOptFlags(projection_pushdown=False))
    assert "Filter" in q.explain(optimizations=plt.QueryOptFlags(predicate_pushdown=False))
    assert "π ['b']" in ct["optflags_select"].explain()
    top = ct["optflags_top_k"]
    assert "limit=7" in top.explain() and "Slice" not in top.explain()
    assert "Slice" in top.explain(optimizations=plt.QueryOptFlags(slice_pushdown=False))
    f = ct["optflags_folds_the_predicate"]
    assert "value=5" in f.explain()
    assert "op='+'" in f.explain(optimizations=plt.QueryOptFlags(simplify_expression=False))
    assert q.explain(optimized=False) == q.explain(optimizations=plt.QueryOptFlags.none(), optimized=False)
    assert "π" not in q.explain(optimizations=plt.QueryOptFlags.none())
    assert q.collect()["b"].to_list() == q.collect(optimizations=plt.QueryOptFlags.none())["b"].to_list()
    flags = plt.QueryOptFlags.none()
    assert not any(getattr(flags, k) for k in FLAGS if k != "type_check") and flags.type_check


def test_type_check_raises_before_anything_runs():
    lf = plt.DataFrame({"a": [1]}, device="cpu").lazy().select(plt.col("nope"))
    for run in (lf.collect, lf.explain):
        with pytest.raises(plt.ColumnNotFoundError):
            run()


def test_cached_subplan_runs_once_per_collect():
    """A subplan used twice (the reference's Q15-shaped case) runs once per
    collect: one group-by segment, one K1 call for its sum; the memo ends
    with the collect, so a second collect runs it again."""
    from polars_tpu_torch.engine import executors as X
    from polars_tpu_torch.engine import run as R

    df = plt.DataFrame({"k": [1, 2, 3, 1, 2], "v": [1.0, 2.0, 3.0, 4.0, 5.0]}, device="cpu")
    rev = df.lazy().group_by("k").agg(plt.col("v").sum().alias("total"))
    q = rev.join(rev.select(plt.col("total").max().alias("total")), on="total", how="inner")
    traced = []
    inner = X._trace_groupby

    def counting(tt, node, tc):
        traced.append(node)
        return inner(tt, node, tc)

    try:
        X._trace_groupby = counting
        for no_opt, runs in ((False, 1), (False, 1), (True, 2)):
            traced.clear()
            assert q.collect(no_optimization=no_opt).to_dict(as_series=False) == {"k": [2], "total": [7.0]}
            assert len(traced) == runs, (no_opt, traced)
    finally:
        X._trace_groupby = inner
    assert not R._PLAN_CACHES


def test_the_port_imports_neither_jax_nor_the_reference():
    code = ("import sys, polars_tpu_torch, polars_tpu_torch.plan.optimizer, polars_tpu_torch.plan.fmt; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'polars_tpu.')) or m == 'polars_tpu']; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)

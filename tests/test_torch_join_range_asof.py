"""Range joins (``join_where``) and asof joins (``join_asof``) of the port
against ``polars_tpu``.

The same frames, made from a numpy seed, go through ``polars_tpu`` (JAX on
the CPU) and ``polars_tpu_torch`` (``device="cpu"``): the join_where, range
and asof cases of ``tests/test_join.py``; every asof strategy over int,
float, Date and Datetime keys, with a tolerance given as a number, a
duration string and a ``timedelta``, over unsorted right sides with
duplicate keys; ``by`` over a string key and over two columns. Frames must
be equal, schemas and row order included; floats agree to rtol 1e-9.

Where ``polars_tpu`` is wrong (ROADMAP section 3) the port is held to a
Python oracle of Polars' semantics instead: a right row with a null asof
key matches as if the key were its stored 0 (``engine/join.py``
``asof_join_frames`` masks right rows by row count only), and with ``by`` a
left row whose group the right side lacks takes the next group's match.

Each test loops over its cases inside (a failure names its case), so the
suite's item count grows by a few items only.
"""

from __future__ import annotations

import datetime as dtm
import itertools

import numpy as np
import pytest

import polars_tpu as plj
import polars_tpu_torch as plt


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


def _assert_frames_match(got, want, *, ordered: bool = True):
    assert [(n, repr(d)) for n, d in got.schema.items()] == [(n, repr(d)) for n, d in want.schema.items()]
    g, w = got.to_dict(as_series=False), want.to_dict(as_series=False)
    if not ordered:
        g, w = ({k: sorted(v, key=repr) for k, v in f.items()} for f in (g, w))
    for name, wcol in w.items():
        if isinstance(want.schema[name], plj.datatypes.FloatType):
            assert [v is None for v in g[name]] == [v is None for v in wcol], name
            gv = np.asarray([np.nan if v is None else v for v in g[name]], np.float64)
            wv = np.asarray([np.nan if v is None else v for v in wcol], np.float64)
            np.testing.assert_allclose(gv, wv, rtol=1e-9, equal_nan=True, err_msg=name)
        else:
            assert g[name] == wcol, name


def _both(data: dict):
    return plj.DataFrame(data), plt.DataFrame(data, device="cpu")


# -- join_where -----------------------------------------------------------------------------------


JOIN_WHERE = {
    "gt": ({"x": [1, 2, 3]}, {"y": [2, 3, 4]}, lambda pl: [pl.col("x") > pl.col("y")]),
    "equi_split": ({"id": [100, 101, 102], "dur": [120, 140, 160], "ecores": [2, 8, 4]},
                   {"t_id": [404, 498, 676, 742], "time": [90, 130, 150, 170], "wcores": [4, 2, 1, 4]},
                   lambda pl: [pl.col("ecores") == pl.col("wcores"), pl.col("dur") < pl.col("time")]),
    "pure_inequality": ({"id": [100, 101, 102], "dur": [120, 140, 160], "ecores": [2, 8, 4]},
                        {"t_id": [404, 498, 676, 742], "time": [90, 130, 150, 170], "wcores": [4, 2, 1, 4]},
                        lambda pl: [pl.col("dur") < pl.col("time")]),
    "flipped": ({"x": [5, 1, 3]}, {"y": [2, 4]}, lambda pl: [pl.col("y") < pl.col("x")]),
    "strings": ({"s": ["b", "d", "a"], "i": [0, 1, 2]}, {"t": ["c", "a"], "j": [0, 1]},
                lambda pl: [pl.col("s") > pl.col("t")]),
    "rest_filters": ({"x": [1, 2, 3], "u": [10, 20, 30]}, {"y": [0, 0, 5], "w": [15, 25, 35]},
                     lambda pl: [pl.col("x") > pl.col("y"), pl.col("u") < pl.col("w")]),
    "empty": ({"x": [1]}, {"y": [5]}, lambda pl: [pl.col("x") > pl.col("y")]),
    "suffix_and_dates": ({"k": [1, 2, 3, None], "d": [dtm.date(2020, 1, d) for d in (3, 1, 2, 4)]},
                         {"k": [2, 2, 1], "d": [dtm.date(2020, 1, d) for d in (2, 3, 1)]},
                         lambda pl: [pl.col("d") >= pl.col("d_right"), pl.col("k") != pl.col("k_right")]),
    "same_name_cross": ({"k": [1, 2, 3]}, {"k": [2, 3]}, lambda pl: [pl.col("k") < pl.col("k")]),
    "datetimes": ({"t": [dtm.datetime(2024, 1, 1, h) for h in (3, 1, 7)]},
                  {"s": [dtm.datetime(2024, 1, 1, h, 30) for h in (0, 2, 6, 2)], "v": [1.5, 2.5, 3.5, 4.5]},
                  lambda pl: [pl.col("t") >= pl.col("s")]),
}


def test_join_where():
    """The join_where cases of ``tests/test_join.py`` and more, eager and
    lazy: an equality and an inequality (an inner join, then a filter), one
    or more inequalities (the range join), right-op-left operands, strings
    across dictionaries, a suffixed right column read by a later predicate,
    and no orderable predicate (a cross join and a filter). Then
    ``test_join_where_equi_split`` and
    ``test_range_join_flipped_strings_and_rest`` of ``tests/test_join.py``."""

    def case(name):
        ldata, rdata, preds = JOIN_WHERE[name]
        (lj, lt), (rj, rt) = _both(ldata), _both(rdata)
        want = lj.join_where(rj, *preds(plj))
        got = lt.join_where(rt, *preds(plt))
        _assert_frames_match(got, want)
        lazy = lt.lazy().join_where(rt.lazy(), *preds(plt)).collect()
        _assert_frames_match(lazy, want)
        assert lt.lazy().join_where(rt.lazy(), *preds(plt)).collect_schema() == got.schema

    _each(JOIN_WHERE, case)
    _check_join_where_equi_split()
    _check_range_join_flipped_strings_and_rest()


def _check_join_where_equi_split():
    east, west = JOIN_WHERE["equi_split"][:2]
    (ej, et), (wj, wt) = _both(east), _both(west)
    out = et.join_where(wt, plt.col("ecores") == plt.col("wcores"), plt.col("dur") < plt.col("time"))
    assert sorted(zip(out["id"].to_list(), out["t_id"].to_list())) == [(100, 498), (102, 742)]
    assert et.join_where(wt, plt.col("dur") < plt.col("time")).height == 6
    _assert_frames_match(et.join_where(wt, plt.col("dur") < plt.col("time")),
                         ej.join_where(wj, plj.col("dur") < plj.col("time")))


_OPS = {"<": lambda a, b: a < b, "<=": lambda a, b: a <= b, ">": lambda a, b: a > b, ">=": lambda a, b: a >= b}


def test_range_join_differential():
    """A pure inequality over floats with nulls, NaN and duplicates, under
    each op: the reference's frame, and the brute-force pairs of
    ``tests/test_join.py``. Then keys of two temporal dtypes."""
    rng = np.random.default_rng(11)
    n_l, n_r = 37, 53
    lx = rng.integers(0, 12, n_l).astype(float)
    rx = rng.integers(0, 12, n_r).astype(float)
    lx[rng.random(n_l) < 0.15] = np.nan
    ry = [float("nan") if i % 9 == 0 else float(v) for i, v in enumerate(rx)]
    ldata = {"x": [None if np.isnan(v) else v for v in lx], "li": list(range(n_l))}
    rdata = {"y": ry, "ri": list(range(n_r))}
    (lj, lt), (rj, rt) = _both(ldata), _both(rdata)

    def check(op):
        got = lt.join_where(rt, _OPS[op](plt.col("x"), plt.col("y")))
        _assert_frames_match(got, lj.join_where(rj, _OPS[op](plj.col("x"), plj.col("y"))))
        exp = sorted((i, j) for i, j in itertools.product(range(n_l), range(n_r))
                     if not np.isnan(lx[i]) and not np.isnan(ry[j]) and _OPS[op](lx[i], ry[j]))
        assert sorted(zip(got["li"].to_list(), got["ri"].to_list())) == exp

    _each(_OPS, check)
    _check_range_join_across_temporal_dtypes()


def _check_range_join_across_temporal_dtypes():
    """A Date against a Datetime, and Datetimes of two units, stay on the
    range path (both keys in their supertype's ticks) and give the
    reference's rows, which it finds by a cross join and a filter, so in
    another order."""
    from polars_tpu_torch.engine.join import _range_values

    left = {"d": [dtm.date(2024, 1, d) for d in (3, 1, 2)],
            "t": np.asarray(["2024-01-01T10:00", "2024-01-02T00:00", "NaT"], "datetime64[ms]")}
    right = {"s": [dtm.datetime(2024, 1, 1, h) for h in (0, 12, 23)] + [None],
             "u": np.asarray(["2024-01-01T09:59:59.999001", "2024-01-01", "2024-01-02", "2024-01-03"],
                             "datetime64[us]")}
    (lj, lt), (rj, rt) = _both(left), _both(right)

    def check(case):
        a, b, op = case
        assert _range_values(lt._get(a), rt._get(b)) is not None and _range_values(rt._get(b), lt._get(a)) is not None
        got = lt.join_where(rt, _OPS[op](plt.col(a), plt.col(b)))
        want = lj.join_where(rj, _OPS[op](plj.col(a), plj.col(b)))
        _assert_frames_match(got, want, ordered=False)
        assert got.height > 0

    _each([("d", "s", "<"), ("t", "u", ">="), ("d", "u", "<=")], check)  # every op: the differential above


def _check_range_join_flipped_strings_and_rest():
    """``tests/test_join.py``'s case, and strings over unordered
    dictionaries (a join's merged dictionary keeps its insertion order)."""
    for case in ("flipped", "strings", "rest_filters", "empty"):
        ldata, rdata, preds = JOIN_WHERE[case]
        (lj, lt), (rj, rt) = _both(ldata), _both(rdata)
        _assert_frames_match(lt.join_where(rt, *preds(plt)), lj.join_where(rj, *preds(plj)))
    a = plt.DataFrame({"k": [1, 2, 3], "s": ["q", "b", "x"]})
    b = plt.DataFrame({"k": [3, 1, 2], "u": ["m", "z", "a"]})
    joined = a.lazy().join(b.lazy(), on="k").collect()  # one row per key, two dictionaries
    c = plt.DataFrame({"t": ["c", "p", "y"], "j": [0, 1, 2]})
    out = joined.join_where(c, plt.col("s") > plt.col("t"))
    pairs = sorted(zip(out["s"].to_list(), out["t"].to_list()))
    assert pairs == sorted((s, t) for s in ("q", "b", "x") for t in ("c", "p", "y") if s > t)


# -- join_asof --------------------------------------------------------------------------------------


def _check_asof_backward_and_forward():
    """``tests/test_join.py``'s ``test_asof_backward`` and
    ``test_asof_forward``."""
    qdata = {"t": [1, 3, 5, 7], "price": [10.0, 11.0, 12.0, 13.0]}
    tdata = {"t": [2, 5, 8]}
    (qj, qt), (tj, tt) = _both(qdata), _both(tdata)
    for strategy, want in (("backward", [10.0, 12.0, 13.0]), ("forward", [11.0, 12.0, None])):
        got = tt.join_asof(qt, on="t", strategy=strategy)
        assert got["price"].to_list() == want
        _assert_frames_match(got, tj.join_asof(qj, on="t", strategy=strategy))


def test_asof_join_by():
    """``tests/test_join.py``'s ``test_asof_backward``, ``test_asof_forward``
    and ``test_asof_join_by``; ``by`` over a string and over two columns
    under each strategy; a group the right side lacks."""
    _check_asof_backward_and_forward()
    trades = {"sym": ["A", "A", "B", "B", "A"], "t": [3, 7, 2, 9, 1], "qty": [10, 20, 30, 40, 50]}
    quotes = {"sym": ["A", "A", "B", "B"], "t": [2, 6, 1, 8], "px": [1.0, 2.0, 3.0, 4.0]}
    (tj, tt), (qj, qt) = _both(trades), _both(quotes)
    for kw, want in (({}, [1.0, 2.0, 3.0, 4.0, None]), ({"strategy": "forward"}, [2.0, None, 4.0, None, 1.0]),
                     ({"tolerance": 1}, [1.0, 2.0, 3.0, 4.0, None])):
        got = tt.lazy().join_asof(qt.lazy(), on="t", by="sym", **kw).collect()
        assert got["px"].to_list() == want
        _assert_frames_match(got, tj.lazy().join_asof(qj.lazy(), on="t", by="sym", **kw).collect())
    _each(itertools.product([["sym"], ["sym", "venue"]], ["backward", "forward", "nearest"]),
          lambda c: _check_asof_by(*c))
    _check_asof_by_group_the_right_side_lacks()


_EPOCH_US = np.datetime64("2024-03-01T09:30:00", "us").astype(np.int64)


def _asof_sides(kind: str) -> tuple[dict, dict]:
    """Trades (with null keys) and quotes (unsorted, duplicate keys) with an
    ``on`` key of one kind."""
    rng = np.random.default_rng(7)
    tk, qk = rng.integers(0, 60, 31), rng.integers(5, 55, 40)
    qk[::7] = qk[1::7][: len(qk[::7])]  # duplicate keys
    tnull = np.arange(31) % 10 == 3

    def keys(k, null):
        if kind == "int":
            vals = k.astype(np.int64)
        elif kind == "float":
            vals = k * 0.5 - 3.25
        elif kind == "date":
            vals = (k * 3 - 40).astype("datetime64[D]")
        else:
            unit = kind.split("_")[1]
            vals = (_EPOCH_US + k * 37_000_000).astype("datetime64[us]").astype(f"datetime64[{unit}]")
        if null is None:
            return vals
        return [None if n else v for v, n in zip(vals.tolist(), null)] if kind in ("int", "float") else np.where(
            null, np.asarray("NaT", vals.dtype), vals)

    trades = {"id": np.arange(31), "t": keys(tk, tnull)}
    quotes = {"t": keys(qk, None), "px": rng.random(40).round(3), "q": np.arange(40)}
    return trades, quotes


_TOLERANCES = {
    "int": [None, 3], "float": [None, 1.25],
    "date": [None, 6, "6d", dtm.timedelta(days=5)],
    "datetime_us": [None, "90s", dtm.timedelta(minutes=2), 75_000_000],
    "datetime_ms": [None, "1m30s", dtm.timedelta(seconds=45)],
    "datetime_ns": [None, "2m", dtm.timedelta(minutes=1, microseconds=5)],
}


def test_asof_strategies():
    """Each strategy over each kind of key and tolerance of ``_TOLERANCES``
    against the reference; then against the Python oracle, a null right
    key included."""
    sides = {}
    for kind in _TOLERANCES:
        trades, quotes = _asof_sides(kind)
        sides[kind] = (*_both(trades), *_both(quotes))

    def check(case):
        (kind, tolerance), strategy = case
        tj, tt, qj, qt = sides[kind]
        want = tj.join_asof(qj, on="t", strategy=strategy, tolerance=tolerance)
        got = tt.join_asof(qt, on="t", strategy=strategy, tolerance=tolerance)
        _assert_frames_match(got, want)

    _each(itertools.product([(k, t) for k, ts in _TOLERANCES.items() for t in ts], ["backward", "forward", "nearest"]),
          check)
    _check_asof_against_python_oracle()
    _check_asof_null_right_key_matches_nothing()


def _by_sides() -> tuple[dict, dict]:
    rng = np.random.default_rng(19)
    syms = np.asarray(["AAPL", "MSFT", "IBM", "ORCL"], object)
    n_t, n_q = 40, 60
    trades = {"sym": syms[rng.integers(0, 4, n_t)], "venue": rng.integers(0, 2, n_t),
              "t": (_EPOCH_US + rng.integers(0, 600, n_t) * 1_000_000).astype("datetime64[us]"),
              "qty": rng.integers(1, 100, n_t)}
    quotes = {"sym": syms[rng.integers(0, 4, n_q)], "venue": rng.integers(0, 2, n_q),
              "t": (_EPOCH_US + rng.integers(0, 600, n_q) * 1_000_000).astype("datetime64[us]"),
              "bid": rng.random(n_q).round(2)}
    return trades, quotes


def _check_asof_by(by, strategy):
    """``by`` over a string key (two dictionaries) and over two columns,
    with a tolerance string, through both packages."""
    trades, quotes = _by_sides()
    (tj, tt), (qj, qt) = _both(trades), _both(quotes)
    for tol in (None, "20s"):
        want = tj.lazy().join_asof(qj.lazy(), on="t", by=by, strategy=strategy, tolerance=tol).collect()
        got = tt.lazy().join_asof(qt.lazy(), on="t", by=by, strategy=strategy, tolerance=tol).collect()
        _assert_frames_match(got, want)


def _asof_oracle(lk, rk, strategy, tolerance=None):
    """Polars' asof match of each left key among the right keys (None
    where there is none): a null key on either side matches nothing; ties
    in key go to the last right row (backward) or the first (forward)."""
    out = []
    for x in lk:
        cands = [(k, i) for i, k in enumerate(rk) if k is not None and x is not None]
        back = max((c for c in cands if c[0] <= x), default=None, key=lambda c: (c[0], c[1]))
        fwd = min((c for c in cands if c[0] >= x), default=None, key=lambda c: (c[0], c[1]))
        if strategy == "backward":
            pick = back
        elif strategy == "forward":
            pick = fwd
        else:
            pick = back if back is not None and (fwd is None or x - back[0] <= fwd[0] - x) else fwd
        if pick is not None and tolerance is not None and abs(x - pick[0]) > tolerance:
            pick = None
        out.append(None if pick is None else pick[1])
    return out


def _check_asof_null_right_key_matches_nothing():
    """A right row with a null key matches nothing (Polars). The reference
    matches it as its stored 0: backward gives [11.0, 10.0, 12.0, None]
    where Polars gives [None, 10.0, 12.0, None], forward [11.0, 12.0,
    13.0, None] where Polars gives [10.0, 12.0, 13.0, None]."""
    quotes = {"t": [1, None, 5, 7], "px": [10.0, 11.0, 12.0, 13.0]}
    trades = {"t": [0, 2, 6, None]}
    (qj, qt), (tj, tt) = _both(quotes), _both(trades)
    for strategy, polars, reference in (("backward", [None, 10.0, 12.0, None], [11.0, 10.0, 12.0, None]),
                                        ("forward", [10.0, 12.0, 13.0, None], [11.0, 12.0, 13.0, None]),
                                        ("nearest", [10.0, 10.0, 12.0, None], None)):
        got = tt.join_asof(qt, on="t", strategy=strategy)["px"].to_list()
        idx = _asof_oracle(trades["t"], quotes["t"], strategy)
        assert got == polars == [None if i is None else quotes["px"][i] for i in idx]
        if reference is not None:
            assert tj.join_asof(qj, on="t", strategy=strategy)["px"].to_list() == reference


def _check_asof_by_group_the_right_side_lacks():
    """A left row whose ``by`` group has no right row matches nothing; the
    reference gives it the next group's match (B takes C's quote)."""
    trades = {"sym": ["A", "B", "C"], "t": [5, 5, 5]}
    quotes = {"sym": ["A", "C"], "t": [1, 2], "px": [1.0, 2.0]}
    (tj, tt), (qj, qt) = _both(trades), _both(quotes)
    assert tt.join_asof(qt, on="t", by="sym")["px"].to_list() == [1.0, None, 2.0]
    assert tj.join_asof(qj, on="t", by="sym")["px"].to_list() == [1.0, 2.0, 2.0]


def _check_asof_against_python_oracle():
    """Every strategy and a tolerance over unsorted integer keys with
    duplicates and nulls on both sides, against the Python oracle."""
    rng = np.random.default_rng(5)
    rk = [None if i % 6 == 2 else int(v) for i, v in enumerate(rng.integers(0, 30, 25))]
    lk = [None if i % 7 == 5 else int(v) for i, v in enumerate(rng.integers(-3, 33, 30))]
    right = plt.DataFrame({"t": rk, "r": np.arange(25)})
    left = plt.DataFrame({"t": lk})
    for strategy, tol in itertools.product(("backward", "forward", "nearest"), (None, 2)):
        got = left.join_asof(right, on="t", strategy=strategy, tolerance=tol)["r"].to_list()
        assert got == _asof_oracle(lk, rk, strategy, tol), (strategy, tol)
    # an empty side: every left row unmatched, with and without `by`
    g = plt.DataFrame({"t": [1, 2], "g": ["a", "b"]})
    empty = plt.DataFrame({"t": np.zeros(0, np.int64), "g": np.zeros(0, object), "v": np.zeros(0)})
    for by in (None, "g"):
        assert g.join_asof(empty, on="t", by=by)["v"].to_list() == [None, None]
        assert empty.join_asof(g, on="t", by=by).height == 0


def test_asof_errors():
    df = plt.DataFrame({"t": [1, 2], "g": ["a", "b"]})
    with pytest.raises(plt.InvalidOperationError, match="tolerance"):
        df.join_asof(df, on="t", tolerance="1s")  # a duration string needs a temporal key
    days = plt.DataFrame({"t": [dtm.date(2020, 1, 1)]})
    with pytest.raises(plt.InvalidOperationError, match="whole number of days"):
        days.join_asof(days, on="t", tolerance="36h")
    with pytest.raises(plt.InvalidOperationError, match="calendar units"):
        days.join_asof(days, on="t", tolerance="1mo")
    wide = plt.DataFrame({"t": np.asarray(["1700-01-01", "2200-01-01"], "datetime64[ns]"), "g": ["a", "b"]})
    with pytest.raises(plt.InvalidOperationError, match="composite key range"):
        wide.join_asof(wide, on="t", by="g")
    # keys of two temporal dtypes would compare days with ticks, or two units' ticks: Polars raises
    us = plt.DataFrame({"t": np.asarray(["2020-01-01T00:00"], "datetime64[us]"), "v": [1]})
    for other in (days, plt.DataFrame({"t": np.asarray(["2020-01-01T00:00"], "datetime64[ms]")})):
        for a, b in ((other, us), (us, other)):
            with pytest.raises(plt.InvalidOperationError, match="asof join keys must have one dtype"):
                a.join_asof(b, on="t")
            with pytest.raises(plt.InvalidOperationError, match="asof join keys must have one dtype"):
                a.lazy().join_asof(b.lazy(), on="t").collect()


def test_chip_phases_at_a_small_size():
    """``chip_smoke.py``'s asof and range phases (``testing/phases.py``) at
    a small size through both packages: the asof join by ticker, backward
    with a tolerance of "1s" and nearest without one, and the monthly
    windows joined to orders. Tickers no quote has match nothing in the
    port; the reference gives them another ticker's quote (ROADMAP §3)."""
    from polars_tpu_torch.testing import pdsh, phases

    data = phases.asof_data(0.002, 1)
    port = phases.asof_frames(plt, data, "cpu")
    ref = {side: plj.DataFrame({c: data["names"][v] if c == "ticker" else
                                v.astype("datetime64[us]") if c == "ts" else v for c, v in cols.items()})
           for side, cols in (("quotes", data["quotes"]), ("trades", data["trades"]))}
    quoted = set(data["names"][data["quotes"]["ticker"]].tolist())
    for strategy, tol in (("backward", "1s"), ("nearest", None)):
        want = phases.asof_plan(plj, ref, strategy, tol).collect().to_dict(as_series=False)
        got = phases.asof_plan(plt, port, strategy, tol).collect().to_dict(as_series=False)
        assert got["ticker"] == want["ticker"] and got["n"] == want["n"]
        lone = [t not in quoted for t in want["ticker"]]  # no quote: no match (the reference takes the next ticker's)
        assert sum(lone) and all(m == 0 and x is None for m, x, o in zip(got["matched"], got["mid"], lone) if o)
        for c in ("matched", "mid", "notional"):
            g = [v for v, o in zip(got[c], lone) if not o]
            w = [v for v, o in zip(want[c], lone) if not o]
            assert [v is None for v in g] == [v is None for v in w], c
            np.testing.assert_allclose(np.asarray([np.nan if v is None else v for v in g], float),
                                       np.asarray([np.nan if v is None else v for v in w], float), rtol=1e-9)
    orders = pdsh.generate_pdsh(0.002, seed=1, tables=("orders",))["orders"]
    orders = {c: orders[c] for c in ("o_orderdate", "o_totalprice")}
    (wj, wt), (oj, ot) = _both(phases.range_windows()), _both(orders)
    want = phases.range_plan(plj, wj, oj).collect()
    got = phases.range_plan(plt, wt, ot).collect()
    _assert_frames_match(got, want)
    assert want.height == 12

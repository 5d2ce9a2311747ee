"""Temporal columns through both packages: the calendar fields of a Date
(``Expr.dt``), against ``polars_tpu`` and Python's ``datetime``; the cases
of ``tests/test_temporal.py``; every naive ``dt`` function over Datetimes
in ms, us and ns; temporal arithmetic, casts and aggregations with their
result dtypes; business days; Datetime, Duration and Time columns built
from numpy and from Python values. All exact.

Dates run from 1600 to 2400, with the century leap-year rules (1700, 1800,
1900 and 2100 are common years; 1600, 2000 and 2400 leap years), the
turns of years where the ISO week and year differ from the calendar's, the
ends of February, and nulls. One select computes every field in each
package (one JAX program); each field is then one case. The tests of this
slice's functions loop over their cases inside one test each (a failure
names its case), so the suite's item count grows by a few items only.

Where ``polars_tpu`` is wrong (ROADMAP section 3) the port is held to a
Python oracle of Polars' semantics, and the case says so: a millisecond
Datetime's fixed intervals (``truncate``, ``round``, ``offset_by`` by
"1h", "15m", "1w"), which the reference scales by 1,000; ``offset_by``
with two units ("3d12h"), which it rejects; the mean of a Date, which it
reads as milliseconds; a ``timedelta`` whose float seconds round down.

``test_week_groups_like_the_temporal_phase`` also runs the dynamic and
rolling group-bys that ``tests/test_torch_eager.py`` keeps
(``_check_dynamic_differential``), and ``test_civil_round_trip`` its
rolling functions over a frame of no rows (``_check_rolling_differential``
over the last of ``_ROLLING_FRAMES``).
"""

from __future__ import annotations

import datetime as dtm
from zoneinfo import ZoneInfo

import numpy as np
import pytest

import polars_tpu as plj
import polars_tpu_torch as plt
from polars_tpu_torch.kernels import temporal as T
from test_torch_eager import (_ROLLING_FRAMES, _check_dynamic_differential, _check_rolling_differential,
                              _release_compiled_programs)


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
    """Equal schemas and equal values (floats to rtol 1e-9)."""
    assert [(n, repr(d)) for n, d in got.schema.items()] == [(n, repr(d)) for n, d in want.schema.items()]
    g, w = got.to_dict(as_series=False), want.to_dict(as_series=False)
    for name, wcol in w.items():
        if isinstance(want.schema[name], plj.datatypes.FloatType):
            gv = np.asarray([np.nan if v is None else v for v in g[name]], np.float64)
            wv = np.asarray([np.nan if v is None else v for v in wcol], np.float64)
            np.testing.assert_allclose(gv, wv, rtol=1e-9, equal_nan=True, err_msg=name)
        else:
            assert g[name] == wcol, name

FIELDS = {  # field -> (the reference's dtype, the value from a datetime.date)
    "year": ("Int32", lambda d: d.year),
    "month": ("Int8", lambda d: d.month),
    "day": ("Int8", lambda d: d.day),
    "quarter": ("Int8", lambda d: (d.month - 1) // 3 + 1),
    "weekday": ("Int8", lambda d: d.isoweekday()),
    "week": ("Int8", lambda d: d.isocalendar()[1]),
    "iso_year": ("Int32", lambda d: d.isocalendar()[0]),
    "ordinal_day": ("Int16", lambda d: d.timetuple().tm_yday),
    "leap_year": ("Boolean", lambda d: d.year % 4 == 0 and (d.year % 100 != 0 or d.year % 400 == 0)),
    "days_in_month": ("Int8", lambda d: ((d.replace(day=28) + dtm.timedelta(days=4)).replace(day=1)
                                         - dtm.timedelta(days=1)).day),
}


def _dates() -> np.ndarray:
    rng = np.random.default_rng(11)
    lo, hi = (np.datetime64(f"{y}-01-01") for y in (1600, 2400))
    edges = [f"{y}-{md}" for y in (1600, 1700, 1900, 1999, 2000, 2004, 2008, 2020, 2021, 2026, 2100, 2399)
             for md in ("01-01", "01-02", "01-03", "01-04", "02-28", "02-29" if y % 4 == 0 and
                        (y % 100 != 0 or y % 400 == 0) else "03-01", "12-28", "12-29", "12-30", "12-31")]
    days = rng.integers(lo.astype(np.int64), hi.astype(np.int64), 300).astype("datetime64[D]")
    out = np.concatenate([np.asarray(edges, "datetime64[D]"), days, np.asarray(["NaT"] * 3, "datetime64[D]")])
    return out[rng.permutation(len(out))]


@pytest.fixture(scope="module")
def fields():
    """Every field of the dates in both packages, and the dates themselves."""
    dates = _dates()
    exprs = {pkg: [getattr(pkg.col("d").dt, f)().alias(f) for f in FIELDS] for pkg in (plj, plt)}
    want = plj.DataFrame({"d": dates}).lazy().select(exprs[plj]).collect()
    got = plt.DataFrame({"d": dates}, device="cpu").lazy().select(exprs[plt]).collect()
    py = [None if np.isnat(d) else d.astype(dtm.date) for d in dates]
    return want, got, py


@pytest.mark.parametrize("field", list(FIELDS))
def test_date_field(fields, field):
    want, got, py = fields
    dtype, of = FIELDS[field]
    assert repr(got.schema[field]) == repr(want.schema[field]) == dtype
    g = got[field].to_list()
    assert g == want[field].to_list()
    assert g == [None if d is None else of(d) for d in py]


@pytest.mark.parametrize("field", ["year", "month", "weekday", "ordinal_day"])
def test_date_field_groups_and_filters(field):
    """A field as a group key and in a filter, as Q7, Q8 and Q9 use
    ``dt.year``: both packages give the same frame."""
    dates = _dates()
    data = {"d": dates, "v": np.arange(len(dates), dtype=np.float64)}
    frames = plj.DataFrame(data), plt.DataFrame(data, device="cpu")
    outs = [
        df.lazy()
        .filter(getattr(pkg.col("d").dt, field)() > 2)
        .group_by(getattr(pkg.col("d").dt, field)().alias("f"))
        .agg(pkg.col("v").sum(), pkg.len())
        .sort("f")
        .collect()
        for pkg, df in zip((plj, plt), frames)
    ]
    assert outs[1].to_dict(as_series=False) == outs[0].to_dict(as_series=False)
    assert outs[0].height > 2


def test_civil_round_trip():
    """``days_from_civil`` inverts ``civil_from_days`` over every day from
    1600 to 2400, negative epoch days included."""
    import torch

    days = torch.arange(-135140, 157054, dtype=torch.int32)
    y, m, d = T.civil_from_days(days)
    assert torch.equal(T.days_from_civil(y, m, d), days)
    assert int(y.min()) == 1600 and int(y.max()) == 2399
    _release_compiled_programs()
    _check_rolling_differential(_ROLLING_FRAMES[2:])  # the rolling functions over a frame of no rows


# -- the cases of tests/test_temporal.py, through both packages ------------------------------

_DATES = {"d": [dtm.date(2024, 2, 29), dtm.date(1999, 12, 31), dtm.date(1970, 1, 1)],
          "ts": [dtm.datetime(2024, 2, 29, 13, 45, 30, 123456), dtm.datetime(1999, 12, 31, 23, 59, 59),
                 dtm.datetime(1970, 1, 1, 0, 0, 0)]}

TEMPORAL_CASES = {
    "date_parts": (_DATES, lambda pl, lf: lf.select(
        y=pl.col("d").dt.year(), m=pl.col("d").dt.month(), day=pl.col("d").dt.day(), q=pl.col("d").dt.quarter(),
        wd=pl.col("d").dt.weekday(), od=pl.col("d").dt.ordinal_day(), ly=pl.col("d").dt.is_leap_year())),
    "time_parts": (_DATES, lambda pl, lf: lf.select(
        h=pl.col("ts").dt.hour(), mi=pl.col("ts").dt.minute(), s=pl.col("ts").dt.second(),
        us=pl.col("ts").dt.microsecond())),
    "iso_week": ({"d": [dtm.date(2024, 1, 1), dtm.date(2023, 1, 1), dtm.date(2020, 12, 31)]},
                 lambda pl, lf: lf.select(w=pl.col("d").dt.week(), iy=pl.col("d").dt.iso_year())),
    "date_arith": ({"a": [dtm.date(2024, 1, 10)], "b": [dtm.date(2024, 1, 1)]}, lambda pl, lf: lf.select(
        diff=pl.col("a") - pl.col("b"), days=(pl.col("a") - pl.col("b")).dt.total_days())),
    "datetime_compare_literal": ({"d": [dtm.date(2024, 1, 1), dtm.date(2025, 1, 1)]},
                                 lambda pl, lf: lf.filter(pl.col("d") > dtm.date(2024, 6, 1))),
    "truncate": ({"d": [dtm.date(2024, 2, 29)], "ts": [dtm.datetime(2024, 2, 29, 13, 47)]},
                 lambda pl, lf: lf.select(mo=pl.col("d").dt.truncate("1mo"), y=pl.col("d").dt.truncate("1y"),
                                          h=pl.col("ts").dt.truncate("1h"))),
    "offset_by_month_end": ({"d": [dtm.date(2024, 1, 31)]}, lambda pl, lf: lf.select(
        p1=pl.col("d").dt.offset_by("1mo"), me=pl.col("d").dt.month_end(), ms=pl.col("d").dt.month_start(),
        dim=pl.col("d").dt.days_in_month())),
    "make_date_fn": ({"x": [0]}, lambda pl, lf: lf.select(d=pl.date(2024, 2, 29))),
    "duration_fn": ({"d": [dtm.date(2024, 1, 1)]}, lambda pl, lf: lf.select(x=pl.col("d") + pl.duration(days=10))),
    "timestamp_epoch": ({"ts": [dtm.datetime(1970, 1, 2, 0, 0, 0)]},
                        lambda pl, lf: lf.select(e=pl.col("ts").dt.epoch("s"))),
    "cast_date_datetime": ({"d": [dtm.date(2024, 5, 5)]}, lambda pl, lf: lf.select(
        ts=pl.col("d").cast(pl.Datetime("us")), back=pl.col("d").cast(pl.Datetime("us")).cast(pl.Date))),
    "group_by_date_key": ({"d": [dtm.date(2024, 1, 1), dtm.date(2024, 1, 1), dtm.date(2024, 2, 1)], "v": [1, 2, 3]},
                          lambda pl, lf: lf.group_by(pl.col("d").dt.month().alias("m")).agg(
                              s=pl.col("v").sum()).sort("m")),
}


def test_temporal_case():
    """Every case of ``TEMPORAL_CASES``, then the eager ``date_range`` and
    ``datetime_range`` under each ``closed``."""

    def case(name):
        data, plan = TEMPORAL_CASES[name]
        want = plan(plj, plj.DataFrame(data).lazy()).collect()
        got = plan(plt, plt.DataFrame(data, device="cpu").lazy()).collect()
        _assert_frames_match(got, want)

    def date_range(closed):
        got = []
        for pkg in (plj, plt):
            s = pkg.date_range(dtm.date(2024, 1, 15), dtm.date(2024, 5, 15), "1mo", closed=closed, eager=True)
            t = pkg.datetime_range(dtm.datetime(2024, 1, 1, 22), dtm.datetime(2024, 1, 2, 4), "2h", closed=closed,
                                   eager=True)
            got.append((s.name, s.to_list(), repr(s.dtype), t.to_list(), repr(t.dtype)))
        assert got[1] == got[0]
        assert len(got[0][1]) == 5 - (closed != "both") - (closed == "none")

    _each(TEMPORAL_CASES, case)
    _each(["both", "left", "right", "none"], date_range)


# -- every naive dt function over Datetimes in ms, us and ns ---------------------------------

UNITS = ("ms", "us", "ns")


def _datetimes(unit: str) -> np.ndarray:
    """Instants from 1600 to 2400 (1700 to 2260 in ns, which int64 holds),
    pre-1970 ones, month ends, leap days, exact midnights and nulls."""
    rng = np.random.default_rng(17)
    lo, hi = ((1700, 2260) if unit == "ns" else (1600, 2400))
    span = (np.datetime64(f"{lo}-01-01", unit), np.datetime64(f"{hi}-01-01", unit))
    rand = rng.integers(span[0].astype(np.int64), span[1].astype(np.int64), 160).astype(f"datetime64[{unit}]")
    edges = np.asarray(["1969-12-31T23:59:59.999", "1970-01-01T00:00:00", "1900-02-28T12:30:00",
                        "2000-02-29T23:59:59.5", "2024-01-31T07:45:00", "1899-12-31T00:00:00",
                        "2023-12-31T12:00:00", "1801-06-30T18:07:30.25", "2100-03-01T00:00:00.001"],
                       f"datetime64[{unit}]")
    out = np.concatenate([edges, rand, np.asarray(["NaT"] * 4, f"datetime64[{unit}]")])
    return out[rng.permutation(len(out))]


def _dt_functions(pl, unit: str) -> dict:
    """name -> expression over the Datetime column "t" (and the Time "tod")."""
    t = pl.col("t")
    fns = {name: getattr(t.dt, name)() for name in (
        "year", "month", "day", "quarter", "weekday", "week", "iso_year", "ordinal_day", "leap_year",
        "days_in_month", "hour", "minute", "second", "millisecond", "microsecond", "nanosecond", "date", "time",
        "datetime", "month_start", "month_end", "century", "millennium")}
    fns |= {
        "second_frac": t.dt.second(fractional=True),
        **{f"timestamp_{u}": t.dt.timestamp(u) for u in UNITS},
        "epoch_s": t.dt.epoch("s"), "epoch_d": t.dt.epoch("d"),
        **{f"cast_time_unit_{u}": t.dt.cast_time_unit(u) for u in UNITS},
        **{f"with_time_unit_{u}": t.dt.with_time_unit(u) for u in UNITS},
        **{f"truncate_{e}": t.dt.truncate(e) for e in ("1w", "1mo", "1h", "15m", "1d", "1q", "1y", "3mo")},
        **{f"round_{e}": t.dt.round(e) for e in ("1h", "15m", "1w", "1d")},
        **{f"offset_{e}": t.dt.offset_by(e) for e in ("1mo", "-1y", "2w", "-3d", "1h", "-15m", "1q")},
        "combine": t.dt.combine(pl.col("tod"), unit),
        "combine_time": t.dt.combine(dtm.time(12, 30, 15, 250000)),
        "replace": t.dt.replace(day=31, hour=5),
        "replace_year": t.dt.replace(year=2000, minute=7),
        "is_business_day": t.dt.is_business_day(),
        "add_business_days": t.dt.add_business_days(3, roll="forward"),
        "diff_total_hours": (t - t.min()).dt.total_hours(),
        "diff_total_ms": (t - t.min()).dt.total_milliseconds(),
        "diff_total_us": (t - t.min()).dt.total_microseconds(),
        "diff_total_ns": (t - t.min()).dt.total_nanoseconds(),
        "neg_total_days": (t.min() - t).dt.total_days(),
        "neg_total_seconds": (t.min() - t).dt.total_seconds(),
        "neg_total_minutes": (t.min() - t).dt.total_minutes(),
    }
    return fns


# the reference scales a millisecond column's fixed intervals by 1,000 (ROADMAP §3)
_MS_FAULTS = {"truncate_1w", "truncate_1h", "truncate_15m", "truncate_1d", "round_1h", "round_15m", "round_1w",
              "round_1d", "offset_1h", "offset_-15m", "offset_2w", "offset_-3d"}


def _floor(v: dtm.datetime, step: dtm.timedelta, anchor: dtm.datetime) -> dtm.datetime:
    return anchor + (v - anchor) // step * step


def _ms_oracle(name: str, v: dtm.datetime) -> dtm.datetime:
    """Polars' semantics of the cases in ``_MS_FAULTS``; weeks start on a
    Monday (1969-12-29)."""
    kind, every = name.split("_")
    monday, epoch = dtm.datetime(1969, 12, 29), dtm.datetime(1970, 1, 1)
    step = {"1w": dtm.timedelta(weeks=1), "1h": dtm.timedelta(hours=1), "15m": dtm.timedelta(minutes=15),
            "1d": dtm.timedelta(days=1)}.get(every)
    anchor = monday if every == "1w" else epoch
    if kind == "truncate":
        return _floor(v, step, anchor)
    if kind == "round":
        return _floor(v + step / 2, step, anchor)
    sign = -1 if every.startswith("-") else 1
    return v + sign * {"1h": dtm.timedelta(hours=1), "15m": dtm.timedelta(minutes=15),
                       "2w": dtm.timedelta(weeks=2), "3d": dtm.timedelta(days=3)}[every.lstrip("-")]


@pytest.fixture(scope="module")
def dt_functions():
    """Every function over each unit's Datetimes, in one select per package
    and unit."""
    out = {}
    for unit in UNITS:
        t = _datetimes(unit)
        us = np.arange(len(t)) * 7_919_000_123 % 86_400_000_000
        tod = [None if i % 11 == 3 else dtm.time(u // 3_600_000_000, u // 60_000_000 % 60, u // 1_000_000 % 60,
                                                 u % 1_000_000) for i, u in enumerate(us.tolist())]
        data = {"t": t, "tod": tod}
        frames = []
        for pkg, df in ((plj, plj.DataFrame(data)), (plt, plt.DataFrame(data, device="cpu"))):
            frames.append(df.lazy().select([e.alias(n) for n, e in _dt_functions(pkg, unit).items()]).collect())
        out[unit] = (*frames, plt.DataFrame({"t": t}, device="cpu")["t"].to_list())
    return out


def test_dt_function(dt_functions):
    """Every function of ``_dt_functions`` in each unit against the
    reference, then a few against Python's ``datetime``."""

    def check(case):
        unit, name = case
        want, got, py = dt_functions[unit]
        assert repr(got.schema[name]) == repr(want.schema[name])
        g = got[name].to_list()
        if unit == "ms" and name in _MS_FAULTS:
            assert g == [None if v is None else _ms_oracle(name, v) for v in py]
            assert g != want[name].to_list()  # the reference's fault, still there
        elif name == "second_frac":  # a float: XLA divides by a constant through its reciprocal
            np.testing.assert_allclose(np.asarray(g, float), np.asarray(want[name].to_list(), float), rtol=1e-9)
        else:
            assert g == want[name].to_list()

    _each([(unit, name) for unit in UNITS for name in _dt_functions(plt, unit)], check)
    _check_dt_fields_against_python()


def _check_dt_fields_against_python():
    """Time-of-day fields and calendar offsets of microsecond Datetimes
    against Python's ``datetime``, pre-1970 instants included."""
    t = _datetimes("us")
    df = plt.DataFrame({"t": t}, device="cpu")
    c = plt.col("t")
    out = df.lazy().select(c.dt.hour().alias("h"), c.dt.minute().alias("m"), c.dt.second().alias("s"),
                           c.dt.microsecond().alias("us"), c.dt.date().alias("d"), c.dt.time().alias("tod"),
                           c.dt.offset_by("1mo").alias("mo"), c.dt.offset_by("-1y").alias("y"),
                           c.dt.offset_by("3d12h").alias("d12"), c.dt.month_end().alias("me")).collect()
    py = df["t"].to_list()

    def months(v, n):
        y, m = divmod(v.month - 1 + n, 12)
        y += v.year
        last = (dtm.date(y + (m + 1) // 12, (m + 1) % 12 + 1, 1) - dtm.timedelta(days=1)).day
        return v.replace(year=y, month=m + 1, day=min(v.day, last))

    def month_end(v):
        return v.replace(day=(months(v.replace(day=1), 1) - dtm.timedelta(days=1)).day)

    want = {"h": lambda v: v.hour, "m": lambda v: v.minute, "s": lambda v: v.second, "us": lambda v: v.microsecond,
            "d": lambda v: v.date(), "tod": lambda v: v.time(), "mo": lambda v: months(v, 1),
            "y": lambda v: months(v, -12), "d12": lambda v: v + dtm.timedelta(days=3, hours=12), "me": month_end}
    for name, of in want.items():
        assert out[name].to_list() == [None if v is None else of(v) for v in py], name
    with pytest.raises(plj.InvalidOperationError):  # the reference takes one unit only (ROADMAP §3)
        plj.DataFrame({"t": t}).lazy().select(plj.col("t").dt.offset_by("3d12h")).collect()


# -- arithmetic, casts and aggregations ---------------------------------------------------------


def _arith_data() -> dict:
    rng = np.random.default_rng(23)
    n = 60
    us = rng.integers(-5_000_000_000_000_000, 5_000_000_000_000_000, n)
    null = rng.random(n) < 0.1
    ts = np.where(null, np.datetime64("NaT"), us.astype("datetime64[us]"))
    dur = rng.integers(-10**12, 10**12, n).astype("timedelta64[us]")
    dur[rng.random(n) < 0.1] = np.timedelta64("NaT")
    return {"ts": ts, "ts_ms": (us // 7).astype("datetime64[ms]"), "ts_ns": (us % 10**15 * 1000 - 10**17)
            .astype("datetime64[ns]"), "d": (us // 86_400_000_000).astype("datetime64[D]"), "dur": dur,
            "dur_ms": (us // 1_000_000_000).astype("timedelta64[ms]"), "k": rng.integers(0, 4, n),
            "i": rng.integers(1, 9, n)}


def _arith_exprs(pl) -> dict:
    c = pl.col
    return {
        "ts_minus_ts_ms": c("ts") - c("ts_ms"), "ts_ns_minus_ts": c("ts_ns") - c("ts"), "d_minus_d": c("d") - c("d"),
        "d_plus_dur": c("d") + c("dur"), "d_minus_dur": c("d") - c("dur"), "d_minus_dur_ms": c("d") - c("dur_ms"),
        "ts_plus_dur": c("ts") + c("dur"), "ts_ms_minus_dur": c("ts_ms") - c("dur"),
        "dur_plus_dur_ms": c("dur") + c("dur_ms"),
        "dur_times_3": c("dur") * 3, "three_times_dur": 3 * c("dur"), "dur_times_i": c("dur") * c("i"),
        "dur_div_2": c("dur") / 2, "dur_div_i": c("dur") / c("i"), "dur_times_half": c("dur") * 0.5,
        "ts_minus_d": c("ts") - c("d"),
        "cast_d_ms": c("d").cast(pl.Datetime("ms")), "cast_d_ns": c("d").cast(pl.Datetime("ns")),
        "cast_ts_date": c("ts").cast(pl.Date), "cast_ts_ns_date": c("ts_ns").cast(pl.Date),
        "cast_ts_time": c("ts").cast(pl.Time), "cast_ts_ms_time": c("ts_ms").cast(pl.Time),
        "cast_ts_ms": c("ts").cast(pl.Datetime("ms")), "cast_ts_ns": c("ts_ms").cast(pl.Datetime("ns")),
        "cast_dur_ms": c("dur").cast(pl.Duration("ms")), "cast_dur_ns": c("dur_ms").cast(pl.Duration("ns")),
        "cast_time_dur": c("ts").cast(pl.Time).cast(pl.Duration("us")),
        "cast_ts_i64": c("ts").cast(pl.Int64), "cast_d_i32": c("d").cast(pl.Int32), "cast_d_i64": c("d").cast(pl.Int64),
        "cast_dur_i64": c("dur").cast(pl.Int64), "cast_i_ts": c("i").cast(pl.Datetime("ms")),
        "cast_i_dur": c("i").cast(pl.Duration("ns")), "cast_i_date": c("i").cast(pl.Date),
        "cast_d_f64": c("d").cast(pl.Float64),
        "gt_datetime": c("ts") > dtm.datetime(1990, 6, 1, 12), "le_date": c("d") <= dtm.date(1969, 3, 1),
        "ns_ge_datetime": c("ts_ns") >= dtm.datetime(1968, 1, 1), "d_lt_datetime": c("d") < dtm.datetime(2001, 1, 1, 6),
        "dur_gt_timedelta": c("dur") > dtm.timedelta(days=2, hours=3), "ms_eq_lit": c("ts_ms") == c("ts_ms").max(),
        "between": c("ts").is_between(dtm.datetime(1950, 1, 1), dtm.datetime(2050, 1, 1)),
        "lit_duration": c("ts") + pl.lit(dtm.timedelta(hours=36)),
        "make_datetime": pl.datetime(2024, c("i"), 28, c("i"), 30, 15, 250, time_unit="ns"),
        "make_duration": pl.duration(days=c("i"), hours=2, milliseconds=c("i"), time_unit="ms"),
    }


def _agg_exprs(pl) -> dict:
    c = pl.col
    return {"dur_sum": c("dur").sum(), "dur_min": c("dur").min(), "dur_max": c("dur").max(),
            "dur_mean": c("dur").mean(), "dur_ms_mean": c("dur_ms").mean(), "ts_mean": c("ts").mean(),
            "ts_ns_mean": c("ts_ns").mean(), "ts_min": c("ts").min(), "ts_ms_max": c("ts_ms").max(),
            "d_max": c("d").max(), "hours": (c("ts") - c("ts_ms")).dt.total_hours().sum(),
            "n": pl.len()}


@pytest.fixture(scope="module")
def arith():
    data = _arith_data()
    out = []
    for pkg, df in ((plj, plj.DataFrame(data)), (plt, plt.DataFrame(data, device="cpu"))):
        lf = df.lazy()
        out.append((lf.select([e.alias(n) for n, e in _arith_exprs(pkg).items()]).collect(),
                    lf.group_by("k").agg([e.alias(n) for n, e in _agg_exprs(pkg).items()]).sort("k").collect(),
                    lf.select([e.alias(n) for n, e in _agg_exprs(pkg).items()]).collect()))
    return out


def test_temporal_arith_and_casts(arith):
    """Each expression of ``_arith_exprs`` with the reference's dtype and
    values, the aggregations of ``_agg_exprs`` in a group-by and in a
    select, and the mean of a Date."""
    (want, _, _), (got, _, _) = arith

    def check(name):
        assert repr(got.schema[name]) == repr(want.schema[name])
        assert got[name].to_list() == want[name].to_list()

    _each(_arith_exprs(plt), check)
    _each({"group_by": 1, "select": 2}.items(), lambda c: _assert_frames_match(arith[1][c[1]], arith[0][c[1]]))
    _check_date_mean_is_the_mean_day()


def _check_date_mean_is_the_mean_day():
    """The mean of a Date is a ``Datetime("ms")`` of the mean day (the
    reference reads the mean day count as milliseconds, ROADMAP §3)."""
    d = [dtm.date(2020, 1, 1), dtm.date(2020, 1, 4), None, dtm.date(1960, 7, 1)]
    for by in (False, True):
        lf = plt.DataFrame({"d": d, "k": [1, 1, 1, 2]}, device="cpu").lazy()
        out = (lf.group_by("k").agg(plt.col("d").mean()).sort("k") if by else lf.select(plt.col("d").mean())).collect()
        assert repr(out.schema["d"]) == "Datetime(time_unit='ms', time_zone=None)"
        epoch = dtm.datetime(1970, 1, 1)
        mean = epoch + sum((dtm.datetime(v.year, v.month, v.day) - epoch for v in d if v), dtm.timedelta()) / 3
        want = [dtm.datetime(2020, 1, 2, 12), dtm.datetime(1960, 7, 1)] if by else [mean]
        assert out["d"].to_list() == want
    ref = plj.DataFrame({"d": d}).lazy().select(plj.col("d").mean()).collect()["d"].to_list()
    assert ref != [mean]  # the reference's fault, still there


# -- business days ----------------------------------------------------------------------------------


def test_business_days():
    rng = np.random.default_rng(31)
    days = rng.integers(-3000, 3000, 80).astype("datetime64[D]")
    ends = days + rng.integers(-40, 40, 80)
    holidays = [dtm.date(1970, 1, 1), dtm.date(1968, 12, 25), dtm.date(1975, 5, 5), dtm.date(1961, 11, 3)]
    mask = (True, True, False, True, True, True, False)
    data = {"d": days, "e": ends}
    outs = []
    for pkg, df in ((plj, plj.DataFrame(data)), (plt, plt.DataFrame(data, device="cpu"))):
        c = pkg.col("d")
        outs.append(df.lazy().select(
            c.dt.is_business_day(week_mask=mask, holidays=holidays).alias("open"),
            c.dt.add_business_days(5, week_mask=mask, holidays=holidays, roll="forward").alias("fwd"),
            c.dt.add_business_days(-4, holidays=holidays, roll="backward").alias("back"),
            pkg.business_day_count("d", "e", week_mask=mask, holidays=holidays).alias("count"),
            pkg.business_day_count("d", "e").alias("count_default")).collect())
    _assert_frames_match(outs[1], outs[0])
    py = [v.astype(dtm.date) for v in days]
    assert outs[1]["open"].to_list() == [mask[v.weekday()] and v not in holidays for v in py]
    with pytest.raises(plt.PolarsError, match="non-business day"):
        plt.DataFrame(data, device="cpu").lazy().select(plt.col("d").dt.add_business_days(1)).collect()


# -- construction and export ------------------------------------------------------------------------


def test_columns_from_numpy_and_python():
    """Datetime, Duration and Time columns from numpy (NaT is null) and from
    Python values go back to Python and numpy as the reference's do."""
    ns = np.asarray(["1677-09-22T00:12:43.145224193", "NaT", "2262-04-11T23:47:16.854775807",
                     "1969-12-31T23:59:59.999999999"], "datetime64[ns]")
    td = np.asarray([-1, 0, 86_400_000_001, "NaT"], "timedelta64[us]")
    py = {
        "dt": [dtm.datetime(1600, 1, 1, 0, 0, 0, 1), None, dtm.datetime(2399, 12, 31, 23, 59, 59, 999999)],
        "date_dt": [dtm.date(1960, 2, 29), dtm.datetime(1960, 3, 1, 6), None],
        "td": [dtm.timedelta(days=-1, microseconds=3), None, dtm.timedelta(weeks=3, seconds=5)],
        "tm": [dtm.time(0, 0), dtm.time(23, 59, 59, 999999), None],
    }
    for data in ({"ns": ns, "td": td, "s": ns.astype("datetime64[s]"), "ms_td": td.astype("timedelta64[ms]")}, py):
        want, got = plj.DataFrame(data), plt.DataFrame(data, device="cpu")
        _assert_frames_match(got, want)
        for name in data:
            w, g = want[name].to_numpy(), got[name].to_numpy()
            assert g.dtype == w.dtype and [str(v) for v in g] == [str(v) for v in w], name
    # the reference builds a timedelta from float seconds and loses this microsecond
    got = plt.DataFrame({"x": [dtm.timedelta(seconds=1, microseconds=1)]}, device="cpu")["x"].to_list()
    assert got == [dtm.timedelta(seconds=1, microseconds=1)]
    _check_time_zones_name_their_queue_item()


def _check_time_zones_name_their_queue_item():
    """Aware values now build, round-trip and format: a column of aware
    datetimes, an aware literal, the tz functions, ``to_string`` and a cast
    to an aware Datetime. The JAX package's other host functions run
    (``concat_str``, ``cat.get_categories``, and ``list.join`` of a List,
    which refuses a String); ``drop_nulls()`` without a subset and
    ``fill_null(strategy=)`` (item 2) now run."""
    from polars_tpu_torch.plan import exprs as E

    aware = dtm.datetime(2024, 1, 1, tzinfo=dtm.timezone.utc)
    df = plt.DataFrame({"t": [dtm.datetime(2024, 1, 1)], "s": ["a"]}, device="cpu")
    col = plt.DataFrame({"t": [aware]}, device="cpu")
    assert col.schema["t"] == plt.Datetime("us", "UTC") and col["t"].to_list() == [aware]
    out = df.lazy().select(
        lit=plt.lit(aware), ams=plt.col("t").dt.replace_time_zone("Europe/Amsterdam"),
        utc=plt.col("t").dt.replace_time_zone("Europe/Amsterdam").dt.convert_time_zone("UTC"),
        base=plt.col("t").dt.replace_time_zone("Europe/Amsterdam").dt.base_utc_offset(),
        dst=plt.col("t").dt.replace_time_zone("Europe/Amsterdam").dt.dst_offset(),
        year=plt.col("t").dt.to_string("%Y"), f=plt.col("t").dt.strftime("%Y"),
        cast=plt.col("t").cast(plt.Datetime("us", "UTC"))).collect()
    assert out.to_dict(as_series=False) == {
        "lit": [aware], "ams": [dtm.datetime(2024, 1, 1, tzinfo=ZoneInfo("Europe/Amsterdam"))],
        "utc": [dtm.datetime(2023, 12, 31, 23, tzinfo=ZoneInfo("UTC"))], "base": [dtm.timedelta(hours=1)],
        "dst": [dtm.timedelta(0)], "year": ["2024"], "f": ["2024"], "cast": [aware]}
    assert df.lazy().drop_nulls().collect().height == 1
    assert df.lazy().select(plt.col("t").fill_null(strategy="forward")).collect()["t"].to_list() == [
        dtm.datetime(2024, 1, 1)]
    calls = {name: lambda name=name: df.lazy().select(plt.Expr(E.EFunction(name, (E.EColumn("s"),), ()))).collect()
             for name in ("concat_str", "cat.get_categories", "list.join")}
    assert calls["concat_str"]()["s"].to_list() == ["a"]
    assert calls["cat.get_categories"]()["s"].to_list() == ["a"]
    with pytest.raises(plt.InvalidOperationError, match="List"):
        calls["list.join"]()
    lists = plt.DataFrame({"s": [["a", "b"], None]}, device="cpu")
    assert lists.lazy().select(plt.Expr(E.EFunction("list.join", (E.EColumn("s"),), (("separator", "-"),)))).collect()[
        "s"].to_list() == ["a-b", None]


def test_week_groups_like_the_temporal_phase():
    """``chip_smoke.py``'s temporal phase (``testing/phases.temporal_plan``)
    at a small size: Datetime literals in a filter, ``truncate("1w")``, a
    Date cast to Datetime minus a Datetime, ``hour``,
    ``offset_by("1mo").month_end()``, and a group-by of Duration means,
    maxima and sums."""
    from polars_tpu_torch.testing import phases

    rng = np.random.default_rng(3)
    n = 400
    ship = rng.integers(8_700, 10_700, n)
    line = {"l_shipdate": ship.astype("datetime64[D]"),
            "l_receiptdate": (ship + rng.integers(1, 31, n)).astype("datetime64[D]"),
            "l_commitdate": (ship + rng.integers(-30, 60, n)).astype("datetime64[D]")}
    phases.add_shipts(line, 3)
    want = phases.temporal_plan(plj, plj.DataFrame(line)).collect()
    _assert_frames_match(phases.temporal_plan(plt, plt.DataFrame(line, device="cpu")).collect(), want)
    assert want.height > 50
    _release_compiled_programs()
    _check_dynamic_differential()

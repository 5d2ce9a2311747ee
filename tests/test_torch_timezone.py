"""Time zones, temporal formatting and parsing, and the null functions,
through both packages: ``kernels/timezone.py`` against ``zoneinfo`` at every
transition; the cases of ``tests/test_timezone.py``; every ``dt`` function
of a Datetime with a time zone (three zones, three time units) against
``polars_tpu``; ``to_string``/``strftime`` (a host op between segments);
``str.to_date``/``to_datetime``/``to_time``/``strptime`` and ``is_null``,
``fill_null``, ``fill_nan``, ``coalesce`` and the NaN tests; asof and range
joins over aware keys; the ``tz`` phase of ``chip_smoke.py`` at SF 0.003.

Frames are built from the same Python or numpy values in each package and
run through the same lazy plan (the port's ``Series`` has no ``dt``
namespace). Keys, counts, instants and strings must be equal; floats agree
to rtol 1e-9. Only zones that both the test host and the machine with the
card have: America/New_York, Europe/Amsterdam, Asia/Tokyo and UTC.

Where ``polars_tpu`` is wrong (ROADMAP section 3), the port is held to a
Python oracle (``zoneinfo``, ``datetime``) instead, in
``test_reference_faults_follow_polars``, which names each fault:
``str.to_datetime(time_zone=)`` drops the zone; ``pl.datetime`` and
``datetime_range`` with ``time_zone`` are naive; an aware Datetime cast to
``Date`` gives UTC's date; ``replace_time_zone(non_existent=)`` is ignored;
``dt.to_string`` leaves chrono's ``%.f`` as text. Beside them: a ``%z``
parse reads the wall clock as UTC, ``with_time_unit``/``cast_time_unit``
drop the zone, ``dt.datetime()`` keeps UTC's clock, and ``str.to_time``
ignores ``strict``.
"""

from __future__ import annotations

import datetime as dtm
import importlib.util
import pathlib
import warnings
from zoneinfo import ZoneInfo

import numpy as np
import pytest
import torch

import polars_tpu as plj
import polars_tpu_torch as plt
from polars_tpu_torch.kernels import timezone as TZ

ZONES = ("America/New_York", "Europe/Amsterdam", "Asia/Tokyo", "UTC")
NY, AMS, TOK = (ZoneInfo(z) for z in ZONES[:3])
UTC = dtm.timezone.utc
EPOCH = dtm.datetime(1970, 1, 1)


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
    assert [(n, repr(d)) for n, d in got.schema.items()] == [(n, repr(d)) for n, d in want.schema.items()]
    g, w = got.to_dict(as_series=False), want.to_dict(as_series=False)
    for name, wcol in w.items():
        if isinstance(want.schema[name], plj.datatypes.FloatType):
            assert [v is None for v in g[name]] == [v is None for v in wcol], name
            gv = np.asarray([np.nan if v is None else v for v in g[name]], np.float64)
            wv = np.asarray([np.nan if v is None else v for v in wcol], np.float64)
            np.testing.assert_allclose(gv, wv, rtol=1e-9, equal_nan=True, err_msg=name)
        else:
            assert g[name] == wcol, name


def _both(data: dict, plan):
    """``plan`` over a frame of ``data`` in each package; the frames must be
    equal. Returns the port's frame."""
    with warnings.catch_warnings():  # numpy's notice on parsing an ISO offset, in the JAX package
        warnings.simplefilter("ignore", DeprecationWarning)
        want = plan(plj, plj.DataFrame(data)).collect()
    got = plan(plt, plt.DataFrame(data, device="cpu")).collect()
    _assert_frames_match(got, want)
    return got


def _port(data: dict, plan):
    return plan(plt, plt.DataFrame(data, device="cpu")).collect()


def _us(d: dtm.datetime) -> int:
    """Exact microseconds since the epoch (an aware datetime: of its instant)."""
    base = EPOCH.replace(tzinfo=UTC) if d.tzinfo is not None else EPOCH
    return (d - base) // dtm.timedelta(microseconds=1)


# -- kernels/timezone.py ------------------------------------------------------------------------


def test_timezone_tables_against_zoneinfo():
    """At every transition of each zone's table, and a second before it, the
    offsets and the local clock agree with ``zoneinfo``; every wall time an
    hour around each transition maps back to an instant as ``fold=0`` (the
    earliest; ``fold=1`` with "latest") does, with the repeated hour flagged
    ambiguous and the skipped one non-existent; the time units scale."""
    def check(zone):
        trans, _, _ = TZ.tz_table(zone)
        z = ZoneInfo(zone)
        inst = np.unique(np.concatenate([trans, trans - 1_000_000, [0, _us(dtm.datetime(2024, 7, 1))]]))
        inst = inst[inst > _us(dtm.datetime(1885, 1, 1))]
        aware = [(EPOCH + dtm.timedelta(microseconds=int(u))).replace(tzinfo=UTC).astimezone(z) for u in inst]
        t = torch.as_tensor(inst)
        want_off = [a.utcoffset() // dtm.timedelta(microseconds=1) for a in aware]
        want_dst = [(a.dst() or dtm.timedelta(0)) // dtm.timedelta(microseconds=1) for a in aware]
        assert TZ.utc_offset(t, "us", zone).tolist() == want_off
        assert TZ.dst_offset(t, "us", zone).tolist() == want_dst
        assert TZ.local_from_utc(t, "us", zone).tolist() == [_us(a.replace(tzinfo=None)) for a in aware]
        assert TZ.utc_offset(t * 1000, "ns", zone).tolist() == [o * 1000 for o in want_off]
        assert TZ.utc_offset(t // 1000, "ms", zone).tolist() == [o // 1000 for o in want_off]
        # wall clocks every 15 minutes from an hour before each transition's local time to an hour after
        walls = sorted({_us(a.replace(tzinfo=None)) + k * 900_000_000 for a in aware[::2] for k in range(-4, 5)})
        walls = [w for w in walls if w > _us(dtm.datetime(1885, 1, 1))]
        naive = [EPOCH + dtm.timedelta(microseconds=w) for w in walls]
        early = [w.replace(tzinfo=z) for w in naive]
        late = [w.replace(tzinfo=z, fold=1) for w in naive]
        exists = [e.astimezone(UTC).astimezone(z).replace(tzinfo=None) == w for e, w in zip(early, naive)]
        repeated = [ex and e.utcoffset() != lt.utcoffset() for ex, e, lt in zip(exists, early, late)]
        for how, picks in (("earliest", early), ("latest", late)):
            utc, amb, nonex = TZ.utc_from_local(torch.as_tensor(walls), "us", zone, how)
            assert amb.tolist() == repeated, how
            assert nonex.tolist() == [not e for e in exists], how
            # a skipped wall time moves past the gap, as Python's fold=0 reads it (the offset before)
            want = [_us(p) if ex else _us(w.replace(tzinfo=z)) for p, w, ex in zip(picks, naive, exists)]
            assert utc.tolist() == want, how

    _each(ZONES, check)
    with pytest.raises(plt.ComputeError, match="time zone"):
        TZ.tz_table("Nowhere/Atlantis")


# -- the cases of tests/test_timezone.py ---------------------------------------------------------


def _ref_timezone_cases() -> dict:
    """The cases of ``tests/test_timezone.py`` as (data, plan) pairs."""
    c_ = "t"
    naive = {"t": [dtm.datetime(2021, 6, 1, 12), dtm.datetime(2021, 1, 1, 12), None]}
    return {
        "replace_roundtrip": (naive, lambda pl, df: df.lazy().select(
            r=pl.col(c_).dt.replace_time_zone("Europe/Amsterdam"),
            back=pl.col(c_).dt.replace_time_zone("Europe/Amsterdam").dt.replace_time_zone(None))),
        "convert_same_instant": (naive, lambda pl, df: df.lazy().select(
            c=pl.col(c_).dt.replace_time_zone("Europe/Amsterdam").dt.convert_time_zone("Asia/Tokyo"))
            .with_columns(h=pl.col("c").dt.hour(), ts=pl.col("c").dt.timestamp("us"))),
        "local_components": ({"t": [dtm.datetime(2021, 6, 1, 23, 30)]}, lambda pl, df: df.lazy().select(
            a=pl.col(c_).dt.replace_time_zone("UTC").dt.convert_time_zone("Europe/Amsterdam"))
            .select(d=pl.col("a").dt.day(), h=pl.col("a").dt.hour(), date=pl.col("a").dt.date())),
        "ambiguous_earliest_latest": ({"t": [dtm.datetime(2020, 10, 25, 2, 30)]}, lambda pl, df: df.lazy().select(
            e=pl.col(c_).dt.replace_time_zone("Europe/Amsterdam", ambiguous="earliest").dt.timestamp("us"),
            l=pl.col(c_).dt.replace_time_zone("Europe/Amsterdam", ambiguous="latest").dt.timestamp("us"))),
        "base_and_dst_offset": ({"t": naive["t"][:2]}, lambda pl, df: df.lazy().select(
            a=pl.col(c_).dt.replace_time_zone("Europe/Amsterdam")).select(
            b=pl.col("a").dt.base_utc_offset(), d=pl.col("a").dt.dst_offset())),
        "construction_inference": ({"t": [dtm.datetime(2021, 6, 1, 12, tzinfo=TOK)],
                                    "u": [dtm.datetime(2021, 6, 1, 12, tzinfo=UTC)]},
                                   lambda pl, df: df.lazy()),
        "wall_clock_ops": ({"t": [dtm.datetime(2021, 6, 1, 12, 34)]}, lambda pl, df: df.lazy().select(
            a=pl.col(c_).dt.replace_time_zone("Europe/Amsterdam")).select(
            tr=pl.col("a").dt.truncate("1d"), ms=pl.col("a").dt.month_start(), me=pl.col("a").dt.month_end(),
            d1=pl.col("a").dt.offset_by("1d"), h3=pl.col("a").dt.offset_by("3h"))),
        "group_and_filter_on_instants": ({"t": [dtm.datetime(2021, 6, 1, 12), dtm.datetime(2021, 6, 1, 13)],
                                          "v": [1, 2]}, lambda pl, df: df.lazy()
                                         .with_columns(pl.col(c_).dt.replace_time_zone("UTC"))
                                         .filter(pl.col(c_) > dtm.datetime(2021, 6, 1, 12, 30, tzinfo=UTC))),
        "to_string": ({"t": [dtm.datetime(2021, 6, 1, 12)]}, lambda pl, df: df.lazy().select(
            s=pl.col(c_).dt.replace_time_zone("Europe/Amsterdam").dt.to_string("%Y-%m-%d %H:%M %z"))),
    }


def test_reference_timezone_cases():
    """Each case of ``tests/test_timezone.py`` gives equal frames; a wall time
    the clock repeats or skips raises by default in both."""
    cases = _ref_timezone_cases()
    _each(sorted(cases), lambda name: _both(*cases[name]))
    got = _port(*cases["to_string"])
    assert got["s"].to_list() == ["2021-06-01 12:00 +0200"]
    got = _port(*cases["construction_inference"])
    assert got.schema["t"] == plt.Datetime("us", "Asia/Tokyo") and got.schema["u"] == plt.Datetime("us", "UTC")
    for wall in (dtm.datetime(2020, 10, 25, 2, 30), dtm.datetime(2020, 3, 29, 2, 30)):
        for pl in (plj, plt):
            with pytest.raises(Exception, match="ambiguous|non-existent"):
                pl.DataFrame({"t": [wall]}).lazy().select(pl.col("t").dt.replace_time_zone("Europe/Amsterdam")) \
                    .collect()


# -- every dt function of an aware Datetime --------------------------------------------------------


def _aware_instants(seed: int) -> list:
    """UTC instants (naive datetimes) from 1900 to 2060: random ones, and
    every hour and quarter hour within two hours of the DST changes of
    2021 in New York and Amsterdam, and nulls."""
    rng = np.random.default_rng(seed)
    us = rng.integers(_us(dtm.datetime(1900, 1, 1)), _us(dtm.datetime(2060, 1, 1)), 60)
    out = [EPOCH + dtm.timedelta(microseconds=int(u)) for u in us]
    for change in (dtm.datetime(2021, 3, 14, 7), dtm.datetime(2021, 11, 7, 6), dtm.datetime(2021, 3, 28, 1),
                   dtm.datetime(2021, 10, 31, 1)):
        out += [change + dtm.timedelta(minutes=15 * k + 7, seconds=13, microseconds=123_456) for k in range(-8, 9)]
    out[5] = out[40] = None
    return out


_DT_FIELDS = ("year", "quarter", "month", "week", "weekday", "day", "ordinal_day", "hour", "minute", "second",
              "millisecond", "microsecond", "nanosecond", "iso_year", "date", "time", "base_utc_offset",
              "dst_offset", "century", "month_start", "month_end")


def test_aware_dt_functions(dt_fields=_DT_FIELDS):
    """Every calendar and clock field, the offsets, the wall-clock moves
    (``truncate``, ``round``, ``offset_by``, ``replace``), ``timestamp``,
    ``to_string`` and ``replace_time_zone(None)`` of aware values in three
    zones and three time units (four pairs), equal through both packages (fixed
    intervals only in us and ns: the JAX package scales a millisecond
    column's by 1,000, ROADMAP section 3); and compares against aware
    literals, differences and a group-by on the local day."""
    data = {"t": _aware_instants(21)}

    def check(case):
        zone, unit = case

        def plan(pl, df):
            c = pl.col
            a = c("t").dt.cast_time_unit(unit).dt.replace_time_zone("UTC").dt.convert_time_zone(zone)
            lf = df.lazy().select(a=a)
            exprs = [getattr(c("a").dt, f)().alias(f) for f in dt_fields]
            exprs += [c("a").dt.timestamp("ms").alias("ts_ms"), c("a").dt.replace_time_zone(None).alias("wall"),
                      c("a").dt.offset_by("-1mo").alias("back_month"), c("a").dt.offset_by("2y").alias("years"),
                      c("a").dt.truncate("1mo").alias("month_of"), c("a").dt.truncate("1y").alias("year_start"),
                      c("a").dt.replace(day=1, hour=3).alias("repl"),
                      c("a").dt.to_string("%Y-%m-%d %H:%M:%S %z %Z").alias("text"),
                      (c("a") >= dtm.datetime(2021, 3, 28, 2, 30, tzinfo=UTC)).alias("after"),
                      (c("a") - dtm.datetime(2000, 1, 1, tzinfo=AMS)).alias("since")]
            if unit != "ms":
                exprs += [c("a").dt.truncate("1d").alias("day_start"), c("a").dt.truncate("1h").alias("hour_start"),
                          c("a").dt.truncate("1w").alias("week_start"), c("a").dt.round("1h").alias("rounded"),
                          c("a").dt.offset_by("1d").alias("next_day"), c("a").dt.offset_by("90m").alias("later")]
            return lf.select(*exprs)

        _both(data, plan)

    _each([("America/New_York", "us"), ("Europe/Amsterdam", "ns"), ("Europe/Amsterdam", "ms"), ("Asia/Tokyo", "us")],
          check)

    def group_plan(pl, df):
        c = pl.col
        return (df.lazy().select(a=c("t").dt.replace_time_zone("UTC").dt.convert_time_zone("America/New_York"),
                                 v=c("t").dt.year())
                .group_by(c("a").dt.truncate("1d").alias("day"))
                .agg(pl.len(), c("v").sum(), c("a").max().alias("last"))
                .sort("day"))

    _both({"t": _aware_instants(22)}, group_plan)


# -- to_string: the host op ----------------------------------------------------------------------


def test_to_string_runs_on_the_host_between_segments():
    """``to_string``/``strftime`` over Dates, naive and aware Datetimes in
    each unit and Times, equal to the JAX package where its format needs no
    chrono specifier, and to ``datetime.strftime`` everywhere; inside a
    larger expression, in ``with_columns`` (the column keeps its place) and
    after a group-by; a predicate over a formatted column stays above it."""
    d = [dtm.datetime(1969, 12, 31, 23, 59, 59, 999_999), dtm.datetime(2024, 2, 29, 7, 5, 3, 120_000), None,
         dtm.datetime(2024, 2, 29, 7, 5, 3, 120_000), dtm.datetime(1900, 3, 1)]
    data = {"d": d, "day": [None if x is None else x.date() for x in d],
            "tm": [None if x is None else x.time() for x in d], "k": [1, 2, 3, 1, 2]}
    fmt = "%Y/%m/%d %H:%M:%S %a %j %%"

    def plan(pl, df):
        c = pl.col
        return df.lazy().with_columns(
            d_ms=c("d").dt.cast_time_unit("ms").dt.to_string(fmt), d_ns=c("d").dt.cast_time_unit("ns").dt.strftime(fmt),
            day=c("day").dt.to_string("%d.%m.%Y"), tm=c("tm").dt.to_string("%H-%M-%S"),
            ny=c("d").dt.replace_time_zone("UTC").dt.convert_time_zone("America/New_York").dt.to_string(
                "%Y-%m-%d %H:%M %z %Z"),
            year=c("d").dt.to_string("%Y").str.slice(0, 2), plain=c("day").dt.to_string())

    got = _both(data, plan)
    assert got.columns == ["d", "day", "tm", "k", "d_ms", "d_ns", "ny", "year", "plain"]
    assert got["ny"].to_list()[:2] == ["1969-12-31 18:59 -0500 EST", "2024-02-29 02:05 -0500 EST"]
    chrono = "%H:%M:%S%.f|%.3f|%.6f|%.9f|%3f|%6f|%9f|%f|%:z"
    want = ["23:59:59.999999|.999|.999999|.999999000|999|999999|999999000|999999000|-05:00",
            "07:05:03.120|.120|.120000|.120000000|120|120000|120000000|120000000|-05:00", None,
            "07:05:03.120|.120|.120000|.120000000|120|120000|120000000|120000000|-05:00",
            "00:00:00|.000|.000000|.000000000|000|000000|000000000|000000000|-05:00"]
    out = _port(data, lambda pl, df: df.lazy().select(
        s=pl.col("d").dt.replace_time_zone("America/New_York").dt.to_string(chrono)))
    assert out["s"].to_list() == want
    ns = _port({"t": np.asarray(["2024-01-01T00:00:00.000000007"], "datetime64[ns]")},
               lambda pl, df: df.lazy().select(pl.col("t").dt.to_string("%.f|%.3f|%9f")))
    assert ns["t"].to_list() == [".000000007|.000|000000007"]
    # after a group-by, sorted; a filter over the text stays above the host op
    grouped = _both(data, lambda pl, df: df.lazy().group_by("k").agg(pl.col("day").max())
                    .with_columns(txt=pl.col("day").dt.to_string("%Y")).filter(pl.col("txt") > "2000").sort("k"))
    assert grouped["txt"].to_list() == ["2024", "2024"]
    # an aggregate's or a literal's text is one value, broadcast as a scalar
    scalars = {
        "aggregate": lambda pl, df: df.lazy().select(pl.col("day").max().dt.to_string("%Y")),
        "aggregate_with_columns": lambda pl, df: df.lazy().with_columns(m=pl.col("d").min().dt.to_string("%Y")),
        "literal": lambda pl, df: df.lazy().with_columns(m=pl.lit(dtm.date(2001, 1, 1)).dt.to_string("%Y-%j")),
        "literal_select": lambda pl, df: df.lazy().select(pl.lit(dtm.date(2001, 1, 1)).dt.to_string("%Y-%j")),
        "one_row": lambda pl, df: df.lazy().filter(pl.col("k") == 3).select(pl.col("day").dt.to_string("%Y")),
        "empty_aggregate": lambda pl, df: df.lazy().filter(pl.col("k") > 5).select(pl.col("day").max().dt.to_string()),
    }
    for case, plan in scalars.items():
        try:
            _both(data, plan)
        except AssertionError as exc:
            raise AssertionError(f"scalar case {case}: {exc}") from None
    assert _port(data, scalars["aggregate_with_columns"])["m"].to_list() == ["1900"] * 5
    lf = plt.DataFrame(data, device="cpu").lazy().with_columns(txt=plt.col("day").dt.to_string("%Y")) \
        .filter(plt.col("txt") > "2000")
    assert lf.explain().index("Filter") < lf.explain().index("WithColumns")
    with pytest.raises(plt.InvalidOperationError, match="host op"):
        plt.DataFrame(data, device="cpu").lazy().filter(plt.col("day").dt.to_string("%Y") == "2024").collect()


# -- parsing and the null functions -------------------------------------------------------------


def test_parse_and_null_functions():
    """``str.to_date``/``to_datetime``/``to_time``/``strptime`` (formats,
    ``exact=False``, ``strict=False``; a strict parse of a bad value fails
    in both), ``is_null``/``is_not_null``/``is_nan``/``is_not_nan``/
    ``is_finite``/``is_infinite``, ``fill_null`` by numbers, strings and
    temporals, ``fill_nan``, ``coalesce`` over numbers, strings and aware
    Datetimes, and ``drop_nulls(subset)``: the cases of ``tests/test_exprs.py``
    and ``tests/test_temporal.py`` and seeded frames, equal through both
    packages."""
    rng = np.random.default_rng(31)
    n = 40
    days = rng.integers(-3_000, 20_000, n)
    texts = [(dtm.date(1970, 1, 1) + dtm.timedelta(days=int(x))).isoformat() for x in days]
    texts = [None if i % 9 == 4 else "N/A" if i % 11 == 7 else t + f" {i % 24:02d}:{i % 60:02d}"
             for i, t in enumerate(texts)]
    f = rng.normal(size=n)
    f[rng.random(n) < 0.2] = np.nan
    data = {
        "s": texts, "i": [None if i % 5 == 0 else int(v) for i, v in enumerate(rng.integers(-9, 9, n))],
        "j": [None if i % 3 == 0 else int(v) for i, v in enumerate(rng.integers(0, 99, n))],
        "f": [float("inf") if i == 3 else None if i == 8 else float(v) for i, v in enumerate(f)],
        "w": [None if i % 4 == 1 else w for i, w in enumerate(rng.choice(["x", "y", "zz"], n).tolist())],
        "v": [None if i % 6 == 2 else w for i, w in enumerate(rng.choice(["p", "x", "q"], n).tolist())],
        "t": [None if i % 7 == 3 else EPOCH + dtm.timedelta(hours=int(h)) for i, h in
              enumerate(rng.integers(200_000, 300_000, n))],
    }

    def plan(pl, df):
        c = pl.col
        return df.lazy().select(
            d=c("s").str.to_date("%Y-%m-%d %H:%M", strict=False),
            d_search=c("s").str.to_date(exact=False, strict=False),
            dt_us=c("s").str.to_datetime("%Y-%m-%d %H:%M", strict=False),
            dt_ns=c("s").str.strptime(pl.Datetime("ns"), "%Y-%m-%d %H:%M", strict=False),
            dt_search=c("s").str.to_datetime("%Y-%m-%d", exact=False, strict=False),
            date_dtype=c("s").str.strptime(pl.Date, "%Y-%m-%d", exact=False, strict=False),
            is_null=c("i").is_null(), not_null=c("s").is_not_null(), nan=c("f").is_nan(), not_nan=c("f").is_not_nan(),
            finite=c("f").is_finite(), inf=c("f").is_infinite(), int_nan=c("i").is_nan(),
            i0=c("i").fill_null(0), i_j=c("i").fill_null(c("j")), i_f=c("i").fill_null(0.5),
            f0=c("f").fill_null(-1.0), fnan=c("f").fill_nan(0.0), fnan_null=c("f").fill_nan(None),
            w0=c("w").fill_null("none"), w_v=c("w").fill_null(c("v")),
            t0=c("t").fill_null(dtm.datetime(2000, 1, 1)),
            co=pl.coalesce("i", "j", 9), co_s=pl.coalesce(c("w"), c("v"), pl.lit("-")),
            co_t=pl.coalesce(c("t").dt.replace_time_zone("UTC"), dtm.datetime(2000, 1, 1, tzinfo=UTC)),
            n_null=c("i").is_null().sum(),
        )

    _both(data, plan)
    ref = {  # tests/test_exprs.py and tests/test_temporal.py
        "is_null_fills": ({"a": [1.0, None, float("nan")]}, lambda pl, df: df.lazy().select(
            isn=pl.col("a").is_null(), nan=pl.col("a").is_nan(), fill=pl.col("a").fill_null(0.0),
            fnan=pl.col("a").fill_nan(-1.0))),
        "coalesce": ({"a": [None, 2, None], "b": [1, None, None]},
                     lambda pl, df: df.lazy().select(c=pl.coalesce("a", "b", 9))),
        "strict_exact": ({"s": ["on 2021-03-04 it", "none here", None]}, lambda pl, df: df.lazy().select(
            d=pl.col("s").str.to_date(exact=False, strict=False))),
        "to_datetime_search": ({"s": ["ts=2021-03-04 05:06:07 end"]}, lambda pl, df: df.lazy().select(
            pl.col("s").str.to_datetime("%Y-%m-%d %H:%M:%S", exact=False))),
        "to_time": ({"s": ["05:06:07", "23:59:59", None]}, lambda pl, df: df.lazy().select(
            pl.col("s").str.to_time(), b=pl.col("s").str.strptime(pl.Time, "%H:%M:%S"))),
        "drop_nulls": ({"a": [1, None, 3], "b": ["x", "y", None]}, lambda pl, df: df.lazy().drop_nulls(["a", "b"])),
    }
    _each(sorted(ref), lambda name: _both(*ref[name]))
    out = _port(*ref["coalesce"])
    assert out["c"].to_list() == [1, 2, 9]
    for pl in (plj, plt):
        for parse in (lambda c: c.str.to_date("%Y-%m-%d %H:%M"), lambda c: c.str.strptime(pl.Datetime, "%Y-%m-%d %H:%M")):
            with pytest.raises(Exception, match="conversion from `str`"):
                pl.DataFrame({"s": texts}).lazy().select(parse(pl.col("s"))).collect()
    # a bad value that a filter drops before the parse does not fail it
    ok = _port({"s": ["2021-01-02", "bad"], "k": [1, 2]},
               lambda pl, df: df.lazy().filter(pl.col("k") == 1).select(pl.col("s").str.to_date()))
    assert ok["s"].to_list() == [dtm.date(2021, 1, 2)]


# -- the faults of the reference -----------------------------------------------------------------


def test_reference_faults_follow_polars():
    """Where ``polars_tpu`` is wrong the port follows Polars, held to
    ``zoneinfo`` and ``datetime``; each check names the fault."""
    def to_datetime_drops_the_zone():
        out = _port({"s": ["2024-06-01 02:30", "2024-11-03 01:30"]}, lambda pl, df: df.lazy().select(
            pl.col("s").str.to_datetime("%Y-%m-%d %H:%M", time_zone="America/New_York", ambiguous="earliest")))
        assert out.schema["s"] == plt.Datetime("us", "America/New_York")
        assert out["s"].to_list() == [dtm.datetime(2024, 6, 1, 2, 30, tzinfo=NY),
                                      dtm.datetime(2024, 11, 3, 1, 30, tzinfo=NY)]
        assert out["s"].to_list()[1].utcoffset() == dtm.timedelta(hours=-4)  # the earlier instant
        ref = plj.DataFrame({"s": ["2024-06-01 02:30"]}).lazy().select(
            plj.col("s").str.to_datetime("%Y-%m-%d %H:%M", time_zone="America/New_York")).collect()
        assert ref.schema["s"] == plj.Datetime("us")  # the fault: naive
        # a %z format parses instants, shown in UTC (the JAX package reads the wall clock as UTC)
        z = _port({"s": ["2024-06-01 02:30 +0200"]}, lambda pl, df: df.lazy().select(
            pl.col("s").str.to_datetime("%Y-%m-%d %H:%M %z")))
        assert z.schema["s"] == plt.Datetime("us", "UTC")
        assert z["s"].to_list() == [dtm.datetime(2024, 6, 1, 0, 30, tzinfo=UTC)]
        with pytest.raises(plt.InvalidOperationError, match="non-existent"):
            _port({"s": ["2024-03-10 02:30"]}, lambda pl, df: df.lazy().select(
                pl.col("s").str.to_datetime("%Y-%m-%d %H:%M", time_zone="America/New_York")))

    def datetime_and_datetime_range_are_naive():
        out = _port({"k": [1]}, lambda pl, df: df.lazy().select(
            pl.datetime(2024, 7, 1, 9, 30, time_zone="Europe/Amsterdam")))
        assert out.schema["datetime"] == plt.Datetime("us", "Europe/Amsterdam")
        assert out["datetime"].to_list() == [dtm.datetime(2024, 7, 1, 9, 30, tzinfo=AMS)]
        days = plt.datetime_range(dtm.datetime(2024, 3, 30), dtm.datetime(2024, 4, 1), "1d",
                                  time_zone="Europe/Amsterdam", eager=True)
        assert days.dtype == plt.Datetime("us", "Europe/Amsterdam")
        assert days.to_list() == [dtm.datetime(2024, 3, d, tzinfo=AMS) for d in (30, 31)] + [
            dtm.datetime(2024, 4, 1, tzinfo=AMS)]
        hours = plt.datetime_range(dtm.datetime(2024, 3, 31, 1), dtm.datetime(2024, 3, 31, 4), "1h",
                                   time_zone="Europe/Amsterdam", time_unit="ms", eager=True)
        assert hours.dtype == plt.Datetime("ms", "Europe/Amsterdam")
        assert [h.hour for h in hours.to_list()] == [1, 3, 4]  # 02:00 does not exist that night
        ref = plj.datetime_range(dtm.datetime(2024, 3, 30), dtm.datetime(2024, 4, 1), "1d",
                                 time_zone="Europe/Amsterdam", eager=True)
        assert ref.dtype == plj.Datetime("us")  # the fault: naive

    def aware_cast_to_date_gives_the_utc_date():
        data = {"t": [dtm.datetime(2024, 6, 1, 2, 30)]}
        plan = lambda pl, df: df.lazy().select(  # noqa: E731
            d=pl.col("t").dt.replace_time_zone("UTC").dt.convert_time_zone("America/New_York").cast(pl.Date),
            tm=pl.col("t").dt.replace_time_zone("UTC").dt.convert_time_zone("America/New_York").cast(pl.Time))
        out = _port(data, plan)
        assert out["d"].to_list() == [dtm.date(2024, 5, 31)]
        assert out["tm"].to_list() == [dtm.time(22, 30)]
        assert plan(plj, plj.DataFrame(data)).collect()["d"].to_list() == [dtm.date(2024, 6, 1)]  # the fault

    def replace_time_zone_ignores_non_existent():
        data = {"t": [dtm.datetime(2024, 3, 10, 2, 30), dtm.datetime(2024, 3, 10, 4, 0)]}
        out = _port(data, lambda pl, df: df.lazy().select(pl.col("t").dt.replace_time_zone(
            "America/New_York", ambiguous="earliest", non_existent="null")))
        assert out["t"].to_list() == [None, dtm.datetime(2024, 3, 10, 4, tzinfo=NY)]
        with pytest.raises(plt.InvalidOperationError, match="non-existent"):
            _port(data, lambda pl, df: df.lazy().select(pl.col("t").dt.replace_time_zone(
                "America/New_York", ambiguous="earliest")))
        amb = _port({"t": [dtm.datetime(2024, 11, 3, 1, 30)]}, lambda pl, df: df.lazy().select(
            pl.col("t").dt.replace_time_zone("America/New_York", ambiguous="null")))
        assert amb["t"].to_list() == [None]
        ref = plj.DataFrame(data).lazy().select(plj.col("t").dt.replace_time_zone(
            "America/New_York", ambiguous="earliest", non_existent="null")).collect()
        assert ref["t"].to_list()[0] == dtm.datetime(2024, 3, 10, 3, 30, tzinfo=NY)  # the fault: moved

    def to_string_leaves_chrono_fractions_as_text():
        data = {"t": [dtm.datetime(2024, 1, 1, 12, 0, 0, 500_000)]}
        plan = lambda pl, df: df.lazy().select(pl.col("t").dt.to_string("%H:%M:%S%.f"))  # noqa: E731
        assert _port(data, plan)["t"].to_list() == ["12:00:00.500"]
        assert plan(plj, plj.DataFrame(data)).collect()["t"].to_list() == ["12:00:00%.f"]  # the fault

    def units_keep_the_zone_and_datetime_is_local():
        data = {"t": [dtm.datetime(2024, 6, 1, 2, 30)]}
        out = _port(data, lambda pl, df: df.lazy().select(
            a=pl.col("t").dt.replace_time_zone("UTC").dt.convert_time_zone("Asia/Tokyo")).select(
            ms=pl.col("a").dt.cast_time_unit("ms"), ns=pl.col("a").dt.with_time_unit("ns"),
            local=pl.col("a").dt.datetime()))
        assert out.schema["ms"] == plt.Datetime("ms", "Asia/Tokyo")
        assert out.schema["ns"] == plt.Datetime("ns", "Asia/Tokyo")
        assert out["ms"].to_list() == [dtm.datetime(2024, 6, 1, 11, 30, tzinfo=TOK)]
        assert out["local"].to_list() == [dtm.datetime(2024, 6, 1, 11, 30)]

    def to_time_strict_raises():
        with pytest.raises(plt.InvalidOperationError, match="conversion from `str` to `time`"):
            _port({"s": ["25:00:00"]}, lambda pl, df: df.lazy().select(pl.col("s").str.to_time()))
        out = _port({"s": ["25:00:00"]}, lambda pl, df: df.lazy().select(pl.col("s").str.to_time(strict=False)))
        assert out["s"].to_list() == [None]

    checks = [to_datetime_drops_the_zone, datetime_and_datetime_range_are_naive,
              aware_cast_to_date_gives_the_utc_date, replace_time_zone_ignores_non_existent,
              to_string_leaves_chrono_fractions_as_text, units_keep_the_zone_and_datetime_is_local,
              to_time_strict_raises]
    _each(checks, lambda check: check())


# -- joins over aware keys ---------------------------------------------------------------------------


def test_aware_joins_casts_and_supertypes():
    """``join_asof`` and ``join_where`` over aware keys of one zone (their
    instants), equal through both packages; keys of two zones raise; casts
    between zones and to naive keep the instants; the supertype of two
    zones is UTC and of a zone and a naive value the zone."""
    rng = np.random.default_rng(41)
    q = sorted(EPOCH + dtm.timedelta(minutes=int(m)) for m in rng.integers(27_000_000, 27_010_000, 30))
    t = sorted(EPOCH + dtm.timedelta(minutes=int(m)) for m in rng.integers(27_000_000, 27_010_000, 12))
    quotes = {"ts": q, "bid": rng.normal(size=30).tolist(), "sym": rng.choice(["A", "B"], 30).tolist()}
    trades = {"ts": t, "sym": rng.choice(["A", "B"], 12).tolist()}

    def aware(pl, data, zone):
        return pl.DataFrame(data).lazy().with_columns(
            pl.col("ts").dt.replace_time_zone("UTC").dt.convert_time_zone(zone))

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want = aware(plj, trades, "Europe/Amsterdam").join_asof(
            aware(plj, quotes, "Europe/Amsterdam"), on="ts", by="sym", strategy="backward").collect()
    got = aware(plt, trades, "Europe/Amsterdam").join_asof(
        aware(plt, quotes, "Europe/Amsterdam"), on="ts", by="sym", strategy="backward").collect()
    _assert_frames_match(got, want)
    win = {"lo": [q[3], q[10]], "hi": [q[9], q[25]], "w": [1, 2]}
    win_plan = lambda pl: aware(pl, quotes, "Asia/Tokyo").join_where(  # noqa: E731
        pl.DataFrame(win).lazy().with_columns(pl.col("lo").dt.replace_time_zone("UTC").dt.convert_time_zone(
            "Asia/Tokyo"), pl.col("hi").dt.replace_time_zone("UTC").dt.convert_time_zone("Asia/Tokyo")),
        pl.col("ts") >= pl.col("lo"), pl.col("ts") < pl.col("hi")).group_by("w").agg(pl.len()).sort("w")
    _assert_frames_match(win_plan(plt).collect(), win_plan(plj).collect())
    with pytest.raises(plt.InvalidOperationError, match="asof join keys"):
        aware(plt, trades, "Europe/Amsterdam").join_asof(aware(plt, quotes, "Asia/Tokyo"), on="ts").collect()
    with pytest.raises(plt.InvalidOperationError, match="two time zones"):
        aware(plt, quotes, "Asia/Tokyo").join_where(aware(plt, trades, "UTC").rename({"ts": "t2", "sym": "s2"}),
                                                   plt.col("ts") < plt.col("t2")).collect()
    from polars_tpu_torch.plan.schema_resolve import supertype

    assert supertype(plt.Datetime("us", "Asia/Tokyo"), plt.Datetime("ns", "UTC")) == plt.Datetime("ns", "UTC")
    assert supertype(plt.Datetime("ms"), plt.Datetime("us", "Asia/Tokyo")) == plt.Datetime("us", "Asia/Tokyo")
    assert supertype(plt.Datetime("us", "Asia/Tokyo"), plt.Datetime("ns", "Europe/Amsterdam")) == \
        plt.Datetime("ns", "UTC")
    cast = _both({"t": q[:4]}, lambda pl, df: df.lazy().select(
        a=pl.col("t").dt.replace_time_zone("Asia/Tokyo")).select(
        utc=pl.col("a").cast(pl.Datetime("us", "UTC")), naive=pl.col("a").cast(pl.Datetime("ns")),
        i=pl.col("a").cast(pl.Int64), back=pl.col("a").cast(pl.Datetime("us", "UTC")) == pl.col("a")))
    assert cast["back"].to_list() == [True] * 4


# -- the tz phase of chip_smoke.py --------------------------------------------------------------------


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_tz_phase_plans():
    """``chip_smoke.py``'s ``tz`` phase (``testing/phases.tz_ship_plan`` and
    ``tz_orders_plan``) at SF 0.003 with its data: the port equals the
    phase's zoneinfo oracle exactly, optimized and as written; and equals
    ``polars_tpu`` over the same rows without the New York wall times that
    do not exist (the reference moves them: ROADMAP section 3); the
    zone-aware parse (``tz_localize_plan``) equals its oracle; a strict
    parse of the text raises in both."""
    from polars_tpu_torch.testing import phases

    cs = _chip_smoke()
    raw, _ = cs.generate(0.003, 42, ["tz"])
    line, orders = raw["lineitem"], raw["orders"]
    cols = cs.PHASE_COLUMNS["tz"]
    lf, of = ({c: t[c] for c in cols[n]} for n, t in (("lineitem", line), ("orders", orders)))
    want = cs.tz_ship_oracle(line)
    want_o = cs.tz_orders_oracle(orders, 42)
    assert want["null_rows"] > 0 and want_o["skipped_rows"] > 0 and want_o["na_rows"] > 0
    for no_opt in (False, True):
        out = phases.tz_ship_plan(plt, plt.DataFrame(lf, device="cpu")).collect(no_optimization=no_opt)
        cs._check_nullable(out, "day", want["day"], want["day_valid"], "tz.ship")
        cs._check_nullable(out, "base", want["base"], want["base_valid"], "tz.ship")
        cs.check_columns(out, want, exact=("n", "nulls", "evening", "weekend", "summer"), floats=("qty",),
                         label="tz.ship")
        assert out["label"].to_list() == want["label"]
        out = phases.tz_orders_plan(plt, plt.DataFrame(of, device="cpu")).collect(no_optimization=no_opt)
        cs.check_columns(out, want_o, exact=("year", "month", "n", "unparsed", "first"), floats=("price",),
                         label="tz.orders")
    cs.check_columns(phases.tz_localize_plan(plt, plt.DataFrame(of, device="cpu")).collect(),
                     cs.tz_localize_oracle(orders, 42), exact=("n", "same", "nulls", "first", "last"),
                     label="tz.localize")
    # the differential, without the New York wall times that do not exist
    def exists_in_ny(wall_us: np.ndarray) -> np.ndarray:
        walls = [EPOCH + dtm.timedelta(microseconds=int(w)) for w in wall_us]
        return np.asarray([w.replace(tzinfo=NY).astimezone(UTC).astimezone(NY).replace(tzinfo=None) == w
                           for w in walls])

    _both({c: v[exists_in_ny(line["l_shipts"].astype(np.int64))] for c, v in lf.items()}, phases.tz_ship_plan)
    hour, _ = phases.orderts_parts(orders["o_orderdate"], 42)
    day = orders["o_orderdate"].astype("datetime64[D]").astype(np.int64)
    _both({c: v[exists_in_ny((day * 24 + hour) * 3_600_000_000)] for c, v in of.items()}, phases.tz_orders_plan)
    for pl, df in ((plj, plj.DataFrame(of)), (plt, plt.DataFrame(of, device="cpu"))):
        with pytest.raises(Exception, match="conversion from `str`"):
            phases.tz_orders_plan(pl, df, strict=True).collect()

"""The plans and data of ``chip_smoke.py``'s phases outside PDS-H, shared
with ``testing/profile_query.py``:

- ``temporal``: a ``Datetime("us")`` column ``l_shipts`` on PDS-H lineitem
  (``l_shipdate`` plus a time of day from the seed) filtered to 1995-1996
  against datetime literals, the week (``dt.truncate("1w")``), the lead time
  (a Date cast to Datetime minus a Datetime), ``dt.hour`` and
  ``offset_by("1mo").month_end()``, grouped by week;
- ``asof``: one trading day of quotes and trades at the size of NYSE TAQ
  (the trades/quotes shape of the Polars user guide's ``join_asof`` section
  and of pandas' ``merge_asof`` example): ``join_asof`` by ticker, then
  aggregates per ticker;
- ``range``: twelve monthly windows of 1995 ``join_where`` PDS-H orders on
  two date inequalities, then a sum and a count per window;
- ``frameops``: the frame operations the optimizer's passes rewrite, on
  PDS-H lineitem: the first line of each order and the orders of one line
  (``unique`` by ``l_orderkey``, ``keep`` first and none); a lazy ``concat``
  of the 1995 and 1996 lines, then ``with_row_index``, ``rename``, ``drop``
  and a group-by; and the per-order totals joined back to their own mean by
  line count, a subplan used twice that common-subplan elimination runs
  once;
- ``tz``: time zones, formatting and parsing. Shipments stamped in New
  York's local time (``l_shipts`` read as its wall clock, the spring-forward
  hours null, the fall-back hours the earlier instant) shown in Amsterdam:
  the hour, weekday and offsets, a filter against an aware literal, a
  group-by of the Amsterdam day, each day labelled by ``to_string``; and
  order timestamps parsed at ingest (``o_orderts``, ``"%Y-%m-%d %H:%M"``
  from ``o_orderdate`` and an hour from the seed, one row in 1,000
  ``"N/A"``), localized in New York, coalesced with the order date's
  midnight, then summed by local year and month;
- ``window``: windows and position functions. ``window.cust``: PDS-H
  orders from 1993 (a row mask), each customer's running spend and days
  since the previous order in date order, the dense rank of each order's
  price within the customer and its share of the customer's total, then the
  top three orders of each customer; ``window.line``: lineitem rows with a
  discount of 5% or more (a row mask that keeps about half), the previous
  row's price, the quantity's change, the last returned line's price
  carried forward, each line's price rank within its order, the running
  quantity of the order in line-number order and each supplier's first
  line.
"""

from __future__ import annotations

import datetime as dtm

import numpy as np

EPOCH = dtm.date(1970, 1, 1)
DAY_US = 86_400_000_000
TEMPORAL_FROM, TEMPORAL_TO = (dtm.date(1995, 1, 1) - EPOCH).days * DAY_US, (dtm.date(1997, 1, 1) - EPOCH).days * DAY_US
ASOF_DAY_US = (dtm.date(2024, 3, 1) - EPOCH).days * DAY_US + (9 * 60 + 30) * 60_000_000  # 09:30 of one day
ASOF_SPAN_US = int(6.5 * 3600 * 1_000_000)  # to 16:00
ASOF_TICKERS = 2_000
TEMPORAL_COLUMNS = ["l_shipdate", "l_commitdate", "l_receiptdate"]


def add_shipts(lineitem: dict, seed: int) -> None:
    """Add ``l_shipts`` to the lineitem columns: ``l_shipdate`` plus a time of
    day drawn from the seed, as ``datetime64[us]``."""
    ship = lineitem["l_shipdate"].astype("datetime64[D]").astype(np.int64)
    tod = np.random.default_rng(seed + 8).integers(0, DAY_US, len(ship), dtype=np.int64)
    lineitem["l_shipts"] = (ship * DAY_US + tod).astype("datetime64[us]")


def temporal_plan(pl, line):
    """The temporal phase's query over a lineitem frame with ``l_shipts``."""
    c = pl.col
    return (line.lazy()
            .filter((c("l_shipts") >= dtm.datetime(1995, 1, 1)) & (c("l_shipts") < dtm.datetime(1997, 1, 1)))
            .with_columns(week=c("l_shipts").dt.truncate("1w"),
                          lead=c("l_receiptdate").cast(pl.Datetime("us")) - c("l_shipts"),
                          hour=c("l_shipts").dt.hour(),
                          due=c("l_shipts").dt.offset_by("1mo").dt.month_end())
            .group_by("week")
            .agg(lead_mean=c("lead").mean(), lead_max=c("lead").max(), lead_hours=c("lead").dt.total_hours().sum(),
                 morning=(c("hour") < 12).sum(), on_time=(c("l_commitdate") < c("due")).sum(), n=pl.len())
            .sort("week"))


def asof_data(scale: float, seed: int) -> dict:
    """One trading day of quotes and trades at the size of NYSE TAQ (60M
    quotes, 15M trades at ``scale`` 10): times in microseconds from 09:30 to
    16:00 in time order, a ticker among 2,000 (its code into the sorted
    names), bid and ask, quantity and price."""
    rng = np.random.default_rng(seed + 9)
    n_q, n_t = int(6_000_000 * scale), int(1_500_000 * scale)
    names = np.asarray([f"T{i:04d}" for i in range(ASOF_TICKERS)], object)
    mid = 20.0 + rng.random(ASOF_TICKERS) * 480.0
    q_tick = rng.integers(0, ASOF_TICKERS, n_q).astype(np.int32)
    q_mid = mid[q_tick] * (1 + rng.normal(0, 0.001, n_q))
    spread = rng.integers(1, 20, n_q) * 0.01
    t_tick = rng.integers(0, ASOF_TICKERS, n_t).astype(np.int32)
    return {
        "names": names,
        "quotes": {"ts": ASOF_DAY_US + np.sort(rng.integers(0, ASOF_SPAN_US, n_q)), "ticker": q_tick,
                   "bid": np.round(q_mid - spread / 2, 4), "ask": np.round(q_mid + spread / 2, 4)},
        "trades": {"ts": ASOF_DAY_US + np.sort(rng.integers(0, ASOF_SPAN_US, n_t)), "ticker": t_tick,
                   "qty": rng.integers(1, 500, n_t) * 100,
                   "price": np.round(mid[t_tick] * (1 + rng.normal(0, 0.002, n_t)), 4)},
    }


def asof_frames(pl, data: dict, dev) -> dict:
    """The two frames on ``dev``; each ticker column is its codes under a
    dictionary of its own (the same sorted names), as encoding the strings
    would give."""
    import torch

    from polars_tpu_torch import datatypes as dt
    from polars_tpu_torch.core.buffer import Buffer
    from polars_tpu_torch.core.column import Column
    from polars_tpu_torch.utils.strtable import StringTable

    frames = {}
    for side, cols in (("quotes", data["quotes"]), ("trades", data["trades"])):
        built = []
        for c, v in cols.items():
            if c == "ticker":
                built.append(Column(c, dt.String(), Buffer.from_numpy(v, None, dtype=torch.int32, device=dev),
                                    StringTable(data["names"], sorted_order=True)))
            else:
                arr = v.astype("datetime64[us]") if c == "ts" else v
                built.append(pl.DataFrame({c: arr}, device=dev)._get(c))
        frames[side] = pl.DataFrame._from_columns(built)
    return frames


def asof_plan(pl, frames: dict, strategy: str, tolerance):
    """Each trade with its ticker's quote (``strategy``, ``tolerance``), then
    per ticker the notional, the mean mid of the matched quotes, the matches
    and the trades."""
    c = pl.col
    return (frames["trades"].lazy()
            .join_asof(frames["quotes"].lazy(), on="ts", by="ticker", strategy=strategy, tolerance=tolerance)
            .group_by("ticker")
            .agg(notional=(c("qty") * c("price")).sum(), mid=((c("ask") + c("bid")) / 2).mean(),
                 matched=c("bid").count(), n=pl.len())
            .sort("ticker"))


def range_windows() -> dict:
    """The columns of the twelve months of 1995 as [w_start, w_end) windows."""
    starts = [dtm.date(1995, m, 1) for m in range(1, 13)]
    return {"w_id": np.arange(1, 13), "w_start": starts, "w_end": starts[1:] + [dtm.date(1996, 1, 1)]}


def range_plan(pl, windows, orders):
    """The windows joined to the orders dated in them, summed per window."""
    c = pl.col
    return (windows.lazy()
            .join_where(orders.lazy(), c("o_orderdate") >= c("w_start"), c("o_orderdate") < c("w_end"))
            .group_by("w_id")
            .agg(c("o_totalprice").sum(), pl.len())
            .sort("w_id"))


FRAMEOPS_COLUMNS = ["l_orderkey", "l_linenumber", "l_shipdate", "l_returnflag", "l_linestatus", "l_quantity",
                    "l_extendedprice"]


def frameops_plans(pl, line) -> dict:
    """The frameops phase's four queries over a lineitem frame, by name."""
    c = pl.col
    orders = line.lazy().select("l_orderkey", "l_linenumber", "l_shipdate")

    def year(y: int):
        return line.lazy().filter((c("l_shipdate") >= dtm.date(y, 1, 1)) & (c("l_shipdate") < dtm.date(y + 1, 1, 1)))

    per_order = line.lazy().group_by("l_orderkey").agg(total=c("l_extendedprice").sum(), lines=pl.len())
    return {
        "first": orders.unique(subset=["l_orderkey"], keep="first", maintain_order=True),
        "single": orders.unique(subset=["l_orderkey"], keep="none", maintain_order=True),
        "concat": (pl.concat([year(1995), year(1996)])
                   .with_row_index("row")
                   .rename({"l_returnflag": "flag", "l_linestatus": "status"})
                   .drop("l_shipdate")
                   .group_by("flag", "status")
                   .agg(qty=c("l_quantity").sum(), price=c("l_extendedprice").sum(), n=pl.len(),
                        last_row=c("row").max())
                   .sort("flag", "status")),
        "cache": (per_order
                  .join(per_order.group_by("lines").agg(avg_total=c("total").mean()), on="lines")
                  .filter(c("total") > c("avg_total"))
                  .group_by("lines")
                  .agg(orders=pl.len(), total=c("total").sum())
                  .sort("lines")),
    }


TZ_SHIP, TZ_SHOWN = "America/New_York", "Europe/Amsterdam"
TZ_SINCE = dtm.datetime(1993, 1, 1)  # the filter's bound, on Amsterdam's wall clock
ORDERTS_FORMAT = "%Y-%m-%d %H:%M"
ORDERTS_FROM_YEAR = 1995


def orderts_parts(orderdate: np.ndarray, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """(the hour of each order's timestamp, the rows whose text is
    ``"N/A"``), drawn from the seed."""
    rng = np.random.default_rng(seed + 10)
    return rng.integers(0, 24, len(orderdate)), rng.random(len(orderdate)) < 0.001


def add_orderts(orders: dict, seed: int) -> None:
    """Add ``o_orderts`` to the orders columns: ``o_orderdate`` and an hour
    from the seed as ``"%Y-%m-%d %H:%M"`` text, ``"N/A"`` in one row of
    1,000; each distinct text is made once and the rows take it by index."""
    day = orders["o_orderdate"].astype("datetime64[D]").astype(np.int64)
    hour, na = orderts_parts(day, seed)
    first = int(day.min())
    uniq, inv = np.unique((day - first) * 24 + hour, return_inverse=True)
    texts = np.asarray([(EPOCH + dtm.timedelta(days=first + int(k) // 24)).strftime("%Y-%m-%d")
                        + f" {int(k) % 24:02d}:00" for k in uniq] + ["N/A"], dtype=object)
    orders["o_orderts"] = texts[np.where(na, len(uniq), inv.reshape(-1))]


def tz_ship_plan(pl, line):
    """Part (a): ``l_shipts`` as New York's wall clock (``non_existent`` null,
    ``ambiguous`` the earlier instant) shown in Amsterdam, the rows from
    ``TZ_SINCE`` on and the null ones, per Amsterdam day: the rows, the
    quantity, the nulls, the rows after 18:00, on a weekend and in summer
    time, the base offset; each day's label by ``to_string``."""
    from zoneinfo import ZoneInfo

    c = pl.col
    ams = (c("l_shipts").dt.replace_time_zone(TZ_SHIP, ambiguous="earliest", non_existent="null")
           .dt.convert_time_zone(TZ_SHOWN))
    return (line.lazy()
            .with_columns(ams=ams)
            .with_columns(hour=c("ams").dt.hour(), weekday=c("ams").dt.weekday(),
                          base=c("ams").dt.base_utc_offset(), dst=c("ams").dt.dst_offset())
            .filter(c("ams").is_null() | (c("ams") >= TZ_SINCE.replace(tzinfo=ZoneInfo(TZ_SHOWN))))
            .group_by(c("ams").dt.truncate("1d").alias("day"))
            .agg(n=pl.len(), qty=c("l_quantity").sum(), nulls=c("ams").is_null().sum(),
                 evening=(c("hour") >= 18).sum(), weekend=(c("weekday") >= 6).sum(),
                 summer=(c("dst") > dtm.timedelta(0)).sum(), base=c("base").max())
            .with_columns(label=c("day").dt.to_string("%Y-%m-%d %z"))
            .sort("day"))


def tz_orders_plan(pl, orders, *, strict: bool = False):
    """Part (b): ``o_orderts`` parsed (``strict=False``: ``"N/A"`` is null)
    and localized in New York (a skipped hour null), coalesced with the
    order date's local midnight; from ``ORDERTS_FROM_YEAR`` on, per local
    year and month: the price, the orders, the failed parses and the
    first instant."""
    c = pl.col
    parsed = (c("o_orderts").str.strptime(pl.Datetime("us"), ORDERTS_FORMAT, strict=strict)
              .dt.replace_time_zone(TZ_SHIP, ambiguous="earliest", non_existent="null"))
    midnight = c("o_orderdate").cast(pl.Datetime("us")).dt.replace_time_zone(TZ_SHIP)
    return (orders.lazy()
            .with_columns(parsed=parsed)
            .with_columns(ts=pl.coalesce(c("parsed"), midnight))
            .filter(c("ts").dt.year() >= ORDERTS_FROM_YEAR)
            .group_by(c("ts").dt.year().alias("year"), c("ts").dt.month().alias("month"))
            .agg(price=c("o_totalprice").sum(), n=pl.len(), unparsed=c("parsed").is_null().sum(),
                 first=c("ts").min())
            .sort("year", "month"))


def tz_localize_plan(pl, orders):
    """Part (b)'s text parsed straight into New York's zone
    (``str.strptime(pl.Datetime("us", TZ_SHIP))``), over the rows outside
    the 01:00 and 02:00 hours, where no local time is skipped or repeated
    (there the zone-aware parse raises, as in Polars, so part (b) parses
    naive text and localizes it with ``non_existent="null"``): the rows, the
    rows equal to part (b)'s localized parse, the nulls, the first and the
    last instant."""
    c = pl.col
    aware = c("o_orderts").str.strptime(pl.Datetime("us", TZ_SHIP), ORDERTS_FORMAT, strict=False)
    naive = (c("o_orderts").str.strptime(pl.Datetime("us"), ORDERTS_FORMAT, strict=False)
             .dt.replace_time_zone(TZ_SHIP))
    return (orders.lazy()
            .filter(~c("o_orderts").str.contains(" 0[12]:"))
            .select(n=pl.len(), same=(aware == naive).sum(), nulls=aware.is_null().sum(),
                    first=aware.min(), last=aware.max()))


STATS_COLUMNS = ["l_returnflag", "l_linestatus", "l_extendedprice", "l_discount", "l_quantity", "l_tax", "l_suppkey",
                 "l_orderkey", "l_linenumber"]


def _stats_flags_aggs(pl) -> list:
    c = pl.col
    return [c("l_extendedprice", "l_discount").std().name.suffix("_std"),
            c("l_quantity").var().name.suffix("_var"),
            c("l_quantity").median().name.suffix("_median"),
            c("l_extendedprice").quantile(0.9, "linear").name.suffix("_p90"),
            c("l_discount").quantile(0.25, "nearest").name.suffix("_p25"),
            c("l_tax").null_count().name.suffix("_nulls"),
            (c("l_discount") > 0.09).any().alias("any_high_disc"),
            (c("l_tax") >= 0).all().alias("all_taxed"),
            c("l_extendedprice").arg_max().name.suffix("_argmax"),
            pl.len()]


def stats_flags(pl, line):
    """``stats.flags`` through the eager API: a DataFrame."""
    return line.group_by("l_returnflag", "l_linestatus").agg(*_stats_flags_aggs(pl)).sort(
        "l_returnflag", "l_linestatus")


def stats_key_mult(scale: float) -> int:
    """The factor of ``l_orderkey`` in ``stats.casts``: 200 at SF10, where
    the orders above 10,737,418 of 15,000,000 overflow Int32 (28% of rows),
    and as large a share at any other scale."""
    return round(2000 / scale)


def _stats_casts(pl, line, key_mult: int, *, strict_overflow: bool = False):
    c = pl.col
    return line.lazy().select(
        price_i32=c("l_extendedprice").cast(pl.Int32),
        qty_i8=c("l_quantity").cast(pl.Int8),
        key_i32=(c("l_orderkey") * key_mult).cast(pl.Int32, strict=strict_overflow),
        line_i64=c("l_linenumber").cast(pl.String).cast(pl.Int64),
        disc_pct=(c("l_discount") * 100).round().cast(pl.Int64),
        net=(c("l_extendedprice") * (1 - c("l_discount"))).log().exp().sqrt().abs().clip(0, 300))


def stats_plans(pl, line, scale: float) -> dict:
    """The stats phase's lazy plans over a lineitem frame of
    ``STATS_COLUMNS``: ``flags`` (the eager query's plan), ``supp``,
    ``casts`` (the cast columns summed over a wildcard), ``cast_frame``
    (the cast columns themselves, whose eager ``null_count`` the phase
    checks) and ``strict`` (the overflowing cast made strict: it must
    raise)."""
    c = pl.col
    return {
        "flags": line.lazy().group_by("l_returnflag", "l_linestatus").agg(*_stats_flags_aggs(pl)).sort(
            "l_returnflag", "l_linestatus"),
        "supp": line.lazy().group_by("l_suppkey").agg(c("l_extendedprice").std(), c("l_discount").median(),
                                                    pl.len()).sort("l_suppkey"),
        "casts": _stats_casts(pl, line, stats_key_mult(scale)).select(pl.all().sum()),
        "cast_frame": _stats_casts(pl, line, stats_key_mult(scale)),
        "strict": _stats_casts(pl, line, stats_key_mult(scale), strict_overflow=True).select(pl.all().sum()),
    }


def _quantile(values: np.ndarray, q: float, interpolation: str) -> float:
    """One group's quantile as the engine takes it: positions ``(n-1)*q``,
    ``nearest`` rounding half to even (np.partition: no full sort)."""
    n = len(values)
    if n == 0:
        return float("nan")
    pos = (n - 1) * q
    lo, hi = int(np.floor(pos)), int(np.ceil(pos))
    if interpolation == "nearest":
        k = int(np.round(pos))
        return float(np.partition(values, k)[k])
    part = np.partition(values, [lo, hi])
    a, b = float(part[lo]), float(part[hi])
    if interpolation == "lower":
        return a
    if interpolation == "higher":
        return b
    if interpolation == "midpoint":
        return (a + b) / 2
    return a + (b - a) * (pos - lo)


def _two_pass_var(values: np.ndarray, inv: np.ndarray, n: np.ndarray, ddof: int) -> np.ndarray:
    """Per group: the mean first, then the squares of the differences."""
    mean = np.bincount(inv, weights=values, minlength=len(n)) / np.maximum(n, 1)
    d = values - mean[inv]
    ss = np.bincount(inv, weights=d * d, minlength=len(n))
    return np.where(n > ddof, ss / np.maximum(n - ddof, 1), np.nan)


def _median_of_levels(levels: np.ndarray, codes: np.ndarray, inv: np.ndarray, n: np.ndarray) -> np.ndarray:
    """Per group, the linear median of a column of few distinct values
    (``levels[codes]``), from a (group, level) histogram: O(rows)."""
    k = len(levels)
    hist = np.bincount(inv * k + codes, minlength=len(n) * k).reshape(len(n), k)
    cum = np.cumsum(hist, axis=1)
    pos = (n - 1) / 2.0
    lo, hi = np.floor(pos).astype(np.int64), np.ceil(pos).astype(np.int64)

    def at(rank):
        return levels[np.argmax(cum > rank[:, None], axis=1)]

    a, b = at(lo), at(hi)
    return np.where(n > 0, a + (b - a) * (pos - lo), np.nan)


def _few_codes(values: np.ndarray) -> tuple[list, np.ndarray]:
    """(the sorted distinct values, each row's index among them) of a
    column of few distinct values, without sorting the rows: text by a set
    of its values and one comparison per value; numbers by the distinct
    values of a sample and ``searchsorted``, with a full ``np.unique`` only
    where a row is not among them."""
    if values.dtype == object:
        levels = sorted(set(values.tolist()))
        codes = np.zeros(len(values), np.int64)
        for i, v in enumerate(levels[1:], 1):
            codes[values == v] = i
        return levels, codes
    levels = np.unique(values[:: max(1, len(values) // 100_000)])
    codes = np.searchsorted(levels, values).clip(0, max(len(levels) - 1, 0))
    if len(values) and not np.array_equal(levels[codes], values):
        levels, codes = np.unique(values, return_inverse=True)
    return levels.tolist(), codes.reshape(-1)


def _dense_codes(keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(the sorted distinct keys, each row's index among them) of
    non-negative integer keys, by a bincount: O(rows + largest key)."""
    present = np.bincount(keys) > 0
    rank = np.cumsum(present) - 1
    return np.flatnonzero(present), rank[keys]


def stats_oracle(line: dict, scale: float) -> dict:
    """The stats phase in numpy, O(rows) but for three partitions per
    (flag, status) group: keys coded without a sort, two-pass variances by
    bincount, the median discount per supplier from a (supplier, discount)
    histogram, the other quantiles by ``np.partition``, sums of the casts in
    int64 (an Int32 sum wraps, as the engine's does)."""
    flag, status = line["l_returnflag"], line["l_linestatus"]
    price, disc, qty, tax = line["l_extendedprice"], line["l_discount"], line["l_quantity"], line["l_tax"]
    f_u, f_inv = _few_codes(flag)
    s_u, s_inv = _few_codes(status)
    present, inv = _dense_codes(f_inv * len(s_u) + s_inv)
    n = np.bincount(inv, minlength=len(present))
    flags = {"l_returnflag": [str(f_u[p // len(s_u)]) for p in present],
             "l_linestatus": [str(s_u[p % len(s_u)]) for p in present],
             "l_extendedprice_std": np.sqrt(_two_pass_var(price, inv, n, 1)),
             "l_discount_std": np.sqrt(_two_pass_var(disc, inv, n, 1)),
             "l_quantity_var": _two_pass_var(qty, inv, n, 1),
             "l_tax_nulls": np.zeros(len(present), np.int64),
             "any_high_disc": np.bincount(inv, weights=disc > 0.09, minlength=len(present)) > 0,
             "all_taxed": np.bincount(inv, weights=~(tax >= 0), minlength=len(present)) == 0,
             "len": n.astype(np.int64)}
    med, p90, p25, argmax = [], [], [], []
    for g in range(len(present)):
        rows = np.flatnonzero(inv == g)
        med.append(_quantile(qty[rows], 0.5, "linear"))
        p90.append(_quantile(price[rows], 0.9, "linear"))
        p25.append(_quantile(disc[rows], 0.25, "nearest"))
        argmax.append(int(np.argmax(price[rows])))
    flags.update(l_quantity_median=np.asarray(med), l_extendedprice_p90=np.asarray(p90), l_discount_p25=np.asarray(p25),
                 l_extendedprice_argmax=np.asarray(argmax, np.int64))

    keys, sinv = _dense_codes(line["l_suppkey"])
    sn = np.bincount(sinv, minlength=len(keys))
    d_levels, d_codes = _few_codes(disc)
    supp_out = {"l_suppkey": keys, "l_extendedprice": np.sqrt(_two_pass_var(price, sinv, sn, 1)),
                "l_discount": _median_of_levels(np.asarray(d_levels), d_codes, sinv, sn), "len": sn.astype(np.int64)}

    key = line["l_orderkey"] * stats_key_mult(scale)
    fits = (key >= -(2**31)) & (key < 2**31)
    net = np.clip(np.abs(np.sqrt(np.exp(np.log(price * (1 - disc))))), 0, 300)
    casts = {"price_i32": int(np.trunc(price).astype(np.int64).sum()),
             "qty_i8": int(np.trunc(qty).astype(np.int64).sum()),
             "key_i32": int(key[fits].sum()),
             "line_i64": int(line["l_linenumber"].sum()),
             "disc_pct": int(np.round(disc * 100).astype(np.int64).sum()),
             "net": float(net.sum())}
    casts["price_i32"] = int(np.int64(casts["price_i32"]).astype(np.int32))  # Int32 sums wrap
    casts["key_i32"] = int(np.int64(casts["key_i32"]).astype(np.int32))
    nulls = {"price_i32": 0, "qty_i8": 0, "key_i32": int((~fits).sum()), "line_i64": 0, "disc_pct": 0, "net": 0}
    return {"flags": flags, "supp": supp_out, "casts": casts, "cast_nulls": nulls}


# -- window phase ---------------------------------------------------------------------------

WINDOW_CUST_COLUMNS = ["o_orderkey", "o_custkey", "o_totalprice", "o_orderdate"]
WINDOW_LINE_COLUMNS = ["l_orderkey", "l_linenumber", "l_suppkey", "l_quantity", "l_extendedprice", "l_discount",
                       "l_returnflag"]
WINDOW_CUST_SINCE = dtm.date(1993, 1, 1)
WINDOW_LINE_DISCOUNT = 0.05


def window_plans(pl, orders, line) -> dict:
    """The window phase's plans over frames of ``WINDOW_CUST_COLUMNS`` and
    ``WINDOW_LINE_COLUMNS`` (either may be None)."""
    c = pl.col
    plans = {}
    if orders is not None:
        plans["cust"] = (
            orders.lazy()
            .filter(c("o_orderdate") >= WINDOW_CUST_SINCE)
            .with_columns(spend=c("o_totalprice").cum_sum().over("o_custkey", order_by="o_orderdate"),
                          gap=c("o_orderdate").diff().over("o_custkey", order_by="o_orderdate"),
                          rank=c("o_totalprice").rank("dense", descending=True).over("o_custkey"),
                          share=c("o_totalprice") / c("o_totalprice").sum().over("o_custkey"))
            .filter(c("rank") <= 3))
    if line is not None:
        plans["line"] = (
            line.lazy()
            .filter(c("l_discount") >= WINDOW_LINE_DISCOUNT)
            .select(prev_price=c("l_extendedprice").shift(1),
                    dqty=c("l_quantity").diff(),
                    last_r=pl.when(c("l_returnflag") == "R").then(c("l_extendedprice")).forward_fill(),
                    pos=c("l_extendedprice").rank("ordinal").over("l_orderkey"),
                    run_qty=c("l_quantity").cum_sum().over("l_orderkey", order_by="l_linenumber"),
                    first_supp=c("l_suppkey").is_first_distinct()))
    return plans


def _segments(keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """For rows sorted by ``keys``: (each row's segment start, each row's
    position in its segment)."""
    n = len(keys)
    first = np.ones(n, bool)
    first[1:] = keys[1:] != keys[:-1]
    start = np.maximum.accumulate(np.where(first, np.arange(n), 0)) if n else np.zeros(0, np.int64)
    return start, np.arange(n) - start


def _segmented_cumsum(x: np.ndarray, start: np.ndarray, pos: np.ndarray) -> np.ndarray:
    """Running sums that restart at each segment, by doubling steps up to
    the longest segment (no sum crosses a segment, so no large total is
    subtracted)."""
    out = x.astype(np.float64).copy()
    step = 1
    longest = int(pos.max()) + 1 if len(pos) else 0
    while step < longest:
        add = np.zeros_like(out)
        add[step:] = np.where(pos[step:] >= step, out[:-step], 0.0)
        out, step = out + add, step * 2
    return out


def window_oracle(orders: dict | None, line: dict | None) -> dict:
    """The window phase in numpy: each output column as (values in its
    storage type, validity or None). Orders within a group follow a stable
    sort, as the engine's ties do."""
    out = {}
    if orders is not None:
        days = orders["o_orderdate"].astype("datetime64[D]").astype(np.int64)
        m = days >= (WINDOW_CUST_SINCE - EPOCH).days
        cust, price, days, okey = orders["o_custkey"][m], orders["o_totalprice"][m], days[m], orders["o_orderkey"][m]
        n = len(cust)
        by_date = np.lexsort((days, cust))
        start, pos = _segments(cust[by_date])
        spend = np.empty(n)
        spend[by_date] = _segmented_cumsum(price[by_date], start, pos)
        gap = np.zeros(n, np.int64)
        gap_ok = np.zeros(n, bool)
        prev = np.concatenate([[0], days[by_date][:-1]])
        gap[by_date] = (days[by_date] - prev) * DAY_US
        gap_ok[by_date] = pos > 0
        by_price = np.lexsort((-price, cust))
        sp, sc = price[by_price], cust[by_price]
        newval = np.ones(n, bool)
        newval[1:] = (sp[1:] != sp[:-1]) | (sc[1:] != sc[:-1])
        dense = np.cumsum(newval)
        gstart, _ = _segments(sc)
        rank = np.empty(n, np.int64)
        rank[by_price] = dense - dense[gstart] + 1 if n else dense
        ids, inv = np.unique(cust, return_inverse=True)
        share = price / np.bincount(inv.reshape(-1), weights=price, minlength=len(ids))[inv.reshape(-1)]
        keep = rank <= 3
        out["cust"] = {"o_orderkey": (okey[keep], None), "o_custkey": (cust[keep], None),
                       "o_totalprice": (price[keep], None), "o_orderdate": (days[keep], None),
                       "spend": (spend[keep], None), "gap": (gap[keep], gap_ok[keep]), "rank": (rank[keep], None),
                       "share": (share[keep], None)}
    if line is not None:
        m = line["l_discount"] >= WINDOW_LINE_DISCOUNT
        okey, lnum, supp = line["l_orderkey"][m], line["l_linenumber"][m], line["l_suppkey"][m]
        qty, price, flag = line["l_quantity"][m], line["l_extendedprice"][m], line["l_returnflag"][m]
        n = len(okey)
        first = np.arange(n) > 0
        prev_price = np.concatenate([[0.0], price[:-1]])
        dqty = qty - np.concatenate([[0.0], qty[:-1]])
        is_r = flag == "R"
        src = np.maximum.accumulate(np.where(is_r, np.arange(n), -1)) if n else np.zeros(0, np.int64)
        by_price = np.lexsort((price, okey))
        _, ppos = _segments(okey[by_price])
        pos = np.empty(n, np.int64)
        pos[by_price] = ppos + 1
        by_line = np.lexsort((lnum, okey))
        lstart, lpos = _segments(okey[by_line])
        run = np.empty(n)
        run[by_line] = _segmented_cumsum(qty[by_line], lstart, lpos)
        _, first_at = np.unique(supp, return_index=True)
        first_supp = np.zeros(n, bool)
        first_supp[first_at] = True
        out["line"] = {"prev_price": (prev_price, first), "dqty": (dqty, first),
                       "last_r": (price[np.maximum(src, 0)], src >= 0), "pos": (pos, None),
                       "run_qty": (run, None), "first_supp": (first_supp, None)}
    return out


def check_window(out, want: dict, label: str) -> float:
    """A window result frame against ``window_oracle``'s columns, row for
    row in storage: integers, dates, durations, flags and null masks
    exactly, floats to rtol 1e-9. Returns the largest relative float
    error."""
    worst = 0.0
    for name, (values, valid) in want.items():
        if out.height != len(values):
            raise AssertionError(f"{label}: {out.height} rows, want {len(values)}")
        buf = out._get(name).buffer
        got = buf.values.cpu().numpy()
        got_valid = np.ones(len(got), bool) if buf.validity is None else buf.validity.cpu().numpy()
        want_valid = np.ones(len(values), bool) if valid is None else valid
        if not np.array_equal(got_valid, want_valid):
            raise AssertionError(f"{label} {name}: nulls differ from the oracle's")
        g, w = got[want_valid], np.asarray(values)[want_valid]
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=1e-9, atol=0, err_msg=f"{label} {name}")
            if len(w):
                worst = max(worst, float(np.max(np.abs(g - w) / np.maximum(np.abs(w), 1e-300))))
        elif not np.array_equal(g.astype(np.int64), w.astype(np.int64)):
            raise AssertionError(f"{label} {name}: {g[:5]} != {w[:5]}")
    return worst

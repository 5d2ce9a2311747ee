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
- ``rolling``: the TAQ day of ``asof`` as a trading desk reads it.
  ``rolling.quotes``: per ticker, the mid's mean and standard deviation over
  the last 5 minutes, its maximum over the last minute, its EWM with a half
  life of 50 quotes, and the spread's mean over the last 20 quotes;
  ``rolling.bars``: one-minute bars per ticker (open, high, low and close of
  the mid, the mean spread, the quotes), ``group_by_dynamic``;
  ``rolling.trades``: five-minute windows every minute per ticker (the
  quantity, the notional and the trades: five shifted copies of the trades,
  each filtered to its window, in one concat), and ``LazyFrame.rolling``
  over the last minute of each trade (the quantity's sum, the price's mean
  and maximum).
- ``recode``: a pricing analyst's feature pass over PDS-H lineitem.
  ``recode.line``: the price in cents (a Decimal(15, 2) cast), the charge
  (cents times one plus the tax as a Decimal, rounded half to even), the
  price band (``cut``), a late flag (``any_horizontal`` of two date
  comparisons), the last of the three dates (``max_horizontal``), the rate
  (``sum_horizontal`` of discount and tax), a weight per ship mode
  (``replace_strict`` without a default) and the return flag spelled out
  (``replace``), then per (band, ship mode, flag) the count, the Decimal
  sums, the mean rate, the late lines, the last date and the weighted
  quantity, sorted; ``recode.sample``: the price decile of every line
  (``qcut`` with labels) and the run of its order (``rle_id``), then the
  1% of lines whose order key hashes to 0 mod 100 (``hash``, a row mask
  over every line), and per decile the count, the distinct orders, Pearson's and Spearman's
  correlation of quantity and price and their covariance.
- ``strings``: text, Categorical and Enum columns. ``strings.cust``: a CRM
  report over PDS-H customers, whose 1.5M addresses at SF10 make an
  unordered dictionary (above ``ordinal_dict_max``): orders joined to their
  customers, the segment as an Enum, the priority as a Categorical and its
  digit by ``str.extract``, grouped by address (the sorted group-by), then a
  label by ``concat_str`` of the segment and the upper-cased name, its
  length, the customer number extracted from the name, sorted by address
  (the dictionary's ordinal remap); ``strings.line``: a shipping-text
  clean-up over PDS-H lineitem (small sorted dictionaries): the ship mode
  as an Enum, the instruction lower-cased with ``_`` for spaces, the return
  flag and the line status joined by ``+``, the number that ends the comment
  and its length, two ship-mode flags (``contains_any``, ``is_between``),
  grouped by the joined flags and the mode, with the text's minima and
  maxima.
- ``nested``: List and Struct columns over PDS-H lineitem, as a retail
  analyst builds per-basket features. ``nested.orders``: each order's
  lines imploded (``group_by(l_orderkey).agg(col(...))``: 15M lists over
  60M elements at SF10) into its prices, quantities and ship modes, then
  per order the line count, the total price, the mean quantity, the top
  price, whether any line ships by AIR and the first ship mode in sorted
  order (``list.len``, ``sum``, ``mean``, ``max``, ``contains``,
  ``sort().first()``); ``nested.explode``: each line's comment split into
  words (``str.split``, its ``list.len`` and the number it ends with), the
  orders of five lines or more (a filter on ``list.len``) exploded back to
  their lines, the quantity and the number paired in a Struct
  (``pl.struct``) and unnested again, then per ship mode the lines, the
  price sum and mean, and the quantity, number and word sums.
- ``io``: the tables of a reporting database joined with the facts.
  PDS-H ``supplier`` and ``nation`` live in a ``sqlite3`` database (in
  memory, and a copy in a file): ``read_database`` reads the suppliers over
  the open connection and ``read_database_uri`` the nations from the file's
  ``sqlite://`` URI onto the device, where lineitem of 1995-1996 is joined
  to both and summed per nation (revenue and lines). ``io.database`` takes
  lineitem from the device; ``io.scan`` from a Parquet file of it clustered
  by ship date in 60 row groups (``io_write_parquet``), whose
  scan takes the date range and the four columns the plan reads.
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


def asof_data(scale: float, seed: int, *, tickers: int = ASOF_TICKERS) -> dict:
    """One trading day of quotes and trades at the size of NYSE TAQ (60M
    quotes, 15M trades at ``scale`` 10): times in microseconds from 09:30 to
    16:00 in time order, a ticker among ``tickers`` (its code into the
    sorted names), bid and ask, quantity and price."""
    rng = np.random.default_rng(seed + 9)
    n_q, n_t = int(6_000_000 * scale), int(1_500_000 * scale)
    names = np.asarray([f"T{i:04d}" for i in range(tickers)], object)
    mid = 20.0 + rng.random(tickers) * 480.0
    q_tick = rng.integers(0, tickers, n_q).astype(np.int32)
    q_mid = mid[q_tick] * (1 + rng.normal(0, 0.001, n_q))
    spread = rng.integers(1, 20, n_q) * 0.01
    t_tick = rng.integers(0, tickers, n_t).astype(np.int32)
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


# -- rolling phase -----------------------------------------------------------------------------

MINUTE_US = 60_000_000
ROLLING_HALF_LIFE = 50  # quotes
ROLLING_SPREAD_QUOTES = 20
_FEW = 16  # windows of at most this many values: the oracle's variance in two passes


def rolling_plans(pl, frames: dict) -> dict:
    """The rolling phase's three plans over ``asof_frames``: ``quotes`` and
    ``bars`` are lazy plans; ``trades`` is a :class:`TradeWindows`."""
    c = pl.col
    mid = (c("bid") + c("ask")) / 2
    spread = c("ask") - c("bid")
    quotes = frames["quotes"].lazy()
    return {
        "quotes": quotes.select(
            mean_5m=mid.rolling_mean_by("ts", "5m").over("ticker"),
            std_5m=mid.rolling_std_by("ts", "5m").over("ticker"),
            max_1m=mid.rolling_max_by("ts", "1m").over("ticker"),
            ewm=mid.ewm_mean(half_life=ROLLING_HALF_LIFE).over("ticker"),
            spread_20=spread.rolling_mean(ROLLING_SPREAD_QUOTES).over("ticker")),
        "bars": quotes.group_by_dynamic("ts", every="1m", group_by="ticker").agg(
            open=mid.first(), high=mid.max(), low=mid.min(), close=mid.last(), spread=spread.mean(), n=pl.len()),
        "trades": TradeWindows(pl, frames["trades"]),
    }


class TradeWindows:
    """``rolling.trades``: the five-minute windows every minute
    (``group_by_dynamic``) and the last minute of each trade
    (``LazyFrame.rolling``), collected together as (windows, per trade)."""

    def __init__(self, pl, trades) -> None:
        self._pl, self._trades = pl, trades

    def plans(self):
        c = self._pl.col
        lf = self._trades.lazy()
        windows = lf.group_by_dynamic("ts", every="1m", period="5m", group_by="ticker").agg(
            qty=c("qty").sum(), notional=(c("qty") * c("price")).sum(), n=self._pl.len())
        per_trade = lf.rolling("ts", period="1m", group_by="ticker").agg(
            qty_1m=c("qty").sum(), px_1m=c("price").mean(), px_max_1m=c("price").max())
        return windows, per_trade

    def collect(self, **kwargs):
        windows, per_trade = self.plans()
        return windows.collect(**kwargs), per_trade.collect(**kwargs)


def _group_order(ticker: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(the rows by ticker, time order kept (the times are sorted); each
    sorted row's group start; its position in the group)."""
    order = np.argsort(ticker.astype(np.int16) if len(ticker) and ticker.max() < 2**15 else ticker, kind="stable")
    start, pos = _segments(ticker[order])
    return order, start, pos


def _group_runs(d: np.ndarray, start: np.ndarray) -> np.ndarray:
    """The running sums of ``d`` restarted at each group: each group summed
    on its own, so that a window's sum is no larger a difference than its
    group's."""
    run = np.empty_like(d)
    bounds = np.flatnonzero(np.diff(start, prepend=-1)) if len(d) else np.zeros(0, np.int64)
    for b, e in zip(bounds, np.append(bounds[1:], len(d))):
        run[b:e] = np.cumsum(d[b:e])
    return run


def _shifted_prefix(x: np.ndarray, start: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(x minus its group's first value, in long double; its running sums
    per group)."""
    d = x.astype(np.longdouble) - x[start].astype(np.longdouble)
    return d, _group_runs(d, start)


def _run_ends(key: np.ndarray) -> np.ndarray:
    """For sorted keys: one past the last row equal to each row's key."""
    ends = np.append(np.flatnonzero(np.diff(key)) + 1, len(key))
    return np.repeat(ends, np.diff(ends, prepend=0))


def _window_sum(run: np.ndarray, start: np.ndarray, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """The sum over each non-empty window [lo, hi) of one group, from the
    group's running sums."""
    return run[hi - 1] - np.where(lo > start[lo], run[np.maximum(lo - 1, 0)], 0)


def _window_max(x: np.ndarray, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """max of x[lo:hi) (every window non-empty): a sparse table up to the
    widest window, each window the larger of two overlapping blocks."""
    width = hi - lo
    tables = [x]
    while (1 << len(tables)) <= width.max():
        t, s = tables[-1], 1 << (len(tables) - 1)
        nxt = t.copy()
        nxt[:-s] = np.maximum(t[:-s], t[s:])
        tables.append(nxt)
    k = np.floor(np.log2(width)).astype(np.int64)
    out = np.empty(len(x))
    for level in np.unique(k):
        m = k == level
        t = tables[level]
        out[m] = np.maximum(t[lo[m]], t[hi[m] - (1 << level)])
    return out


def _ewm_oracle(x: np.ndarray, start: np.ndarray, alpha: float) -> np.ndarray:
    """ewm_mean(adjust=True) of each group by ``scipy.signal.lfilter``:
    sum (1-alpha)^k x[t-k] over sum (1-alpha)^k."""
    from scipy.signal import lfilter

    out = np.empty(len(x))
    bounds = np.flatnonzero(np.diff(start, prepend=-1)) if len(x) else np.zeros(0, np.int64)
    ends = np.append(bounds[1:], len(x))
    a = [1.0, -(1.0 - alpha)]
    for b, e in zip(bounds, ends):
        out[b:e] = lfilter([1.0], a, x[b:e]) / lfilter([1.0], a, np.ones(e - b))
    return out


def _window_moment(mid: np.ndarray, start: np.ndarray, lo: np.ndarray, hi: np.ndarray, power: int) -> np.ndarray:
    """Each window's sum of the values' deviations from their ticker's
    first (``power`` 1), or of their squares (2), in long double."""
    d = mid.astype(np.longdouble) - mid[start].astype(np.longdouble)
    return _window_sum(_group_runs(d if power == 1 else d * d, start), start, lo, hi)


def _few_variances(mid: np.ndarray, lo: np.ndarray, hi: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(the windows of at most ``_FEW`` values, their variances in two passes
    over their own values): there the variance lies far below the prefix
    sums' rounding."""
    few = np.flatnonzero(hi - lo <= _FEW)
    flo, fn = lo[few], (hi - lo)[few]
    vals = [np.where(k < fn, mid[np.minimum(flo + k, len(mid) - 1)], 0).astype(np.longdouble) for k in range(_FEW)]
    fmean = sum(vals) / fn
    return few, sum(np.where(k < fn, (v - fmean) ** 2, 0) for k, v in enumerate(vals)) / np.maximum(fn - 1, 1)


def _trade_windows(tick: np.ndarray, ts: np.ndarray, qty: np.ndarray, price: np.ndarray, all_ts: np.ndarray) -> dict:
    """The five-minute windows every minute per ticker, from per-minute
    sums (the trades sorted by ticker and time)."""
    tmin = (all_ts.min() // MINUTE_US) * MINUTE_US
    span = int((all_ts.max() - tmin) // MINUTE_US + 1)
    slot = tick * span + (ts - tmin) // MINUTE_US
    n_t = int(tick.max()) + 1 if len(tick) else 0
    first = np.flatnonzero(np.diff(slot, prepend=-1))  # slots ascend: each minute's first trade
    grid = {"qty": np.zeros(n_t * span, np.int64), "n": np.zeros(n_t * span, np.int64),
            "notional": np.zeros(n_t * span, np.longdouble)}
    if len(first):
        grid["qty"][slot[first]] = np.add.reduceat(qty, first)
        grid["n"][slot[first]] = np.diff(np.append(first, len(slot)))
        grid["notional"][slot[first]] = np.add.reduceat(qty.astype(np.longdouble) * price, first)
    wins = {}
    for name, g in grid.items():
        per = g.reshape(n_t, span)
        acc = per.copy()
        for k in range(1, 5):  # a window from minute m holds minutes m..m+4
            acc[:, :-k] += per[:, k:]
        wins[name] = acc.reshape(-1)
    has = wins["n"] > 0
    cell = np.flatnonzero(has)
    return {"ticker": cell // span, "ts": tmin + (cell % span) * MINUTE_US, "qty": wins["qty"][has],
            "notional": wins["notional"][has].astype(np.float64), "n": wins["n"][has]}


def rolling_oracle(data: dict) -> dict:
    """The rolling phase in numpy, each window summed in long double over
    values shifted by their ticker's first: ``quotes`` (columns in row
    order, with their validity), ``bars``, ``windows`` and ``per_trade``.
    Its parts run in threads (numpy lets go of the interpreter lock)."""
    from concurrent.futures import ThreadPoolExecutor

    q, t = data["quotes"], data["trades"]
    order, start, pos = _group_order(q["ticker"])
    tick, ts = q["ticker"][order].astype(np.int64), q["ts"][order]
    mid = (q["bid"][order] + q["ask"][order]) / 2
    spread = q["ask"][order] - q["bid"][order]
    key = tick << 40 | (ts - ASOF_DAY_US)
    hi = _run_ends(key)
    torder, tstart, _ = _group_order(t["ticker"])
    ttick, tts = t["ticker"][torder].astype(np.int64), t["ts"][torder]
    qty, price = t["qty"][torder], t["price"][torder]

    def max_1m():
        return {"max_1m": (_window_max(mid, np.searchsorted(key, key - MINUTE_US, side="right"), hi), None)}

    def ewm():
        return {"ewm": (_ewm_oracle(mid, start, 1.0 - 2.0 ** (-1.0 / ROLLING_HALF_LIFE)), None)}

    def spread_and_bars():
        _, ps = _shifted_prefix(spread, start)
        idx = np.arange(len(spread))
        lo_r = np.maximum(idx - (ROLLING_SPREAD_QUOTES - 1), start)
        col = {"spread_20": ((spread[start] + _window_sum(ps, start, lo_r, idx + 1) / (idx + 1 - lo_r)).astype(
            np.float64), pos >= ROLLING_SPREAD_QUOTES - 1)}
        minute = (ts // MINUTE_US) * MINUTE_US
        first = np.flatnonzero(np.diff(tick << 40 | (minute - ASOF_DAY_US), prepend=-1))
        last = np.append(first[1:], len(minute)) - 1
        counts = last - first + 1
        bars = {"ticker": tick[first], "ts": minute[first], "open": mid[first],
                "high": np.maximum.reduceat(mid, first), "low": np.minimum.reduceat(mid, first), "close": mid[last],
                "spread": (spread[start][first] + _window_sum(ps, start, first, last + 1) / counts).astype(
                    np.float64), "n": counts}
        return col, bars

    def per_trade():
        tkey = ttick << 40 | (tts - ASOF_DAY_US)
        thi = _run_ends(tkey)
        tlo = np.searchsorted(tkey, tkey - MINUTE_US, side="right")
        pq = np.concatenate([[0], np.cumsum(qty)])
        _, pp = _shifted_prefix(price, tstart)
        cols = {"qty_1m": pq[thi] - pq[tlo],
                "px_1m": (price[tstart] + _window_sum(pp, tstart, tlo, thi) / (thi - tlo)).astype(np.float64),
                "px_max_1m": _window_max(price, tlo, thi)}
        back = np.empty_like(torder)
        back[torder] = np.arange(len(torder))
        return {"ts": t["ts"], "ticker": t["ticker"], **{k: v[back] for k, v in cols.items()}}

    with ThreadPoolExecutor(max_workers=8) as pool:
        jobs = {"max": pool.submit(max_1m), "ewm": pool.submit(ewm), "spread": pool.submit(spread_and_bars),
                "per_trade": pool.submit(per_trade),
                "trade_windows": pool.submit(_trade_windows, ttick, tts, qty, price, t["ts"])}
        lo5 = np.searchsorted(key, key - 5 * MINUTE_US, side="right")
        for k, power in (("s1", 1), ("s2", 2)):
            jobs[k] = pool.submit(_window_moment, mid, start, lo5, hi, power)
        jobs["few"] = pool.submit(_few_variances, mid, lo5, hi)
        res = {k: j.result() for k, j in jobs.items()}
    spread_col, bars = res["spread"]
    s1, s2, n = res["s1"], res["s2"], (hi - lo5).astype(np.longdouble)
    var = np.maximum((s2 - s1 * s1 / n) / np.maximum(n - 1, 1), 0)
    var[res["few"][0]] = res["few"][1]
    cols = {"mean_5m": ((mid[start] + s1 / n).astype(np.float64), None),
            "std_5m": (np.sqrt(var).astype(np.float64), hi - lo5 > 1), **res["max"], **res["ewm"], **spread_col}
    back = np.empty_like(order)
    back[order] = np.arange(len(order))
    quotes = {name: (v[back], None if ok is None else ok[back]) for name, (v, ok) in cols.items()}
    return {"quotes": {k: quotes[k] for k in ("mean_5m", "std_5m", "max_1m", "ewm", "spread_20")}, "bars": bars,
            "windows": res["trade_windows"], "per_trade": res["per_trade"]}


# -- recode phase ----------------------------------------------------------------------------

RECODE_COLUMNS = ["l_orderkey", "l_quantity", "l_extendedprice", "l_discount", "l_tax", "l_returnflag",
                  "l_shipdate", "l_commitdate", "l_receiptdate", "l_shipmode"]
RECODE_BANDS = [10000, 25000, 50000, 75000]
RECODE_MODE_WEIGHTS = {"AIR": 1.25, "FOB": 0.8, "MAIL": 0.9, "RAIL": 0.7, "REG AIR": 1.1, "SHIP": 0.6, "TRUCK": 0.75}
RECODE_FLAGS = {"A": "accepted", "R": "returned"}
RECODE_DECILES = [f"d{i}" for i in range(10)]
RECODE_SEED = 42
RECODE_SAMPLE = 100  # one order in this many, by its hash


def recode_plans(pl, line) -> dict:
    """``recode.line`` and ``recode.sample`` over a lineitem frame of (at
    least) ``RECODE_COLUMNS``."""
    c = pl.col
    cents = c("l_extendedprice").cast(pl.Decimal(15, 2))
    features = line.lazy().with_columns(
        cents=cents,
        charge=cents * (1 + c("l_tax")).cast(pl.Decimal(15, 2)),
        band=c("l_extendedprice").cut(RECODE_BANDS),
        late=pl.any_horizontal(c("l_receiptdate") > c("l_commitdate"), c("l_shipdate") > c("l_commitdate")),
        last=pl.max_horizontal("l_shipdate", "l_commitdate", "l_receiptdate"),
        rate=pl.sum_horizontal("l_discount", "l_tax"),
        w=c("l_shipmode").replace_strict(RECODE_MODE_WEIGHTS),
        flag=c("l_returnflag").replace(RECODE_FLAGS))
    keys = ("band", "l_shipmode", "flag")
    line_plan = features.group_by(*keys).agg(
        pl.len(), c("cents").sum(), c("charge").sum(), c("rate").mean(), c("late").sum(), c("last").max(),
        (c("w") * c("l_quantity")).sum().alias("weighted")).sort(*keys)
    quantiles = [i / 10 for i in range(1, 10)]
    sample = (line.lazy()
              .with_columns(decile=c("l_extendedprice").qcut(quantiles, labels=RECODE_DECILES),
                            run=c("l_orderkey").rle_id())
              .filter(c("l_orderkey").hash(seed=RECODE_SEED) % RECODE_SAMPLE == 0)
              .group_by("decile")
              .agg(pl.len(), c("run").n_unique().alias("orders"), pl.corr("l_quantity", "l_extendedprice").alias("r"),
                   pl.corr("l_quantity", "l_extendedprice", method="spearman").alias("rho"),
                   pl.cov("l_quantity", "l_extendedprice").alias("cov"))
              .sort("decile"))
    return {"line": line_plan, "sample": sample}


_SPLITMIX = (0x9E3779B97F4A7C15, 0xBF58476D1CE4E5B9, 0x94D049BB133111EB)


def splitmix64(x: np.ndarray, seed: int) -> np.ndarray:
    """``kernels/hashing.hash_column`` of an integer column in numpy
    ``uint64``: splitmix64 of the value plus the seed."""
    c1, c2, c3 = (np.uint64(k) for k in _SPLITMIX)
    with np.errstate(over="ignore"):
        z = x.astype(np.int64).view(np.uint64) + np.uint64(seed % 2**64) + c1
        z = (z ^ (z >> np.uint64(30))) * c2
        z = (z ^ (z >> np.uint64(27))) * c3
        return z ^ (z >> np.uint64(31))


def _half_even_div(num: np.ndarray, d: int) -> np.ndarray:
    q, r = np.divmod(num, d)  # floor division: 0 <= r < d
    up = (2 * r > d) | ((2 * r == d) & (q % 2 == 1))
    return q + up


def _linear_quantiles(x: np.ndarray, qs: list) -> np.ndarray:
    """Polars' linear quantiles: the values at ``(n-1) q`` and the next
    position, blended as ``lo + (hi - lo) * frac``."""
    pos = (len(x) - 1) * np.asarray(qs, np.float64)
    lo_i = np.floor(pos).astype(np.int64)
    hi_i = np.minimum(lo_i + 1, len(x) - 1)
    part = np.partition(x, np.unique(np.concatenate([lo_i, hi_i])))
    lo, hi = part[lo_i], part[hi_i]
    return lo + (hi - lo) * (pos - lo_i)


def _avg_rank(x: np.ndarray) -> np.ndarray:
    """1-based ranks, ties averaged."""
    u, inv, cnt = np.unique(x, return_inverse=True, return_counts=True)
    start = np.cumsum(cnt) - cnt
    return (start + (cnt + 1) / 2.0)[inv.reshape(-1)]


def _pearson_ld(x: np.ndarray, y: np.ndarray) -> tuple[float, float]:
    """(Pearson's r, the covariance with ddof 1) in two passes in long
    double."""
    x, y = x.astype(np.longdouble), y.astype(np.longdouble)
    dx, dy = x - x.mean(), y - y.mean()
    sxy = (dx * dy).sum()
    return float(sxy / np.sqrt((dx * dx).sum() * (dy * dy).sum())), float(sxy / (len(x) - 1))


def recode_oracle(line: dict) -> dict:
    """The recode phase in numpy: keys, counts, run ids and Decimal sums
    exact (int64 cents, the charge rounded half to even), floats in f64 sums,
    the correlations and covariance in two passes in long double."""
    price, tax, disc, qty = line["l_extendedprice"], line["l_tax"], line["l_discount"], line["l_quantity"]
    cents = np.round(price * 100).astype(np.int64)
    charge = _half_even_div(cents * np.round((1 + tax) * 100).astype(np.int64), 100)
    band = np.zeros(len(price), np.int64)
    for b in RECODE_BANDS:
        band += price > b
    ship, commit, receipt = (line[k].astype("datetime64[D]").astype(np.int64)
                             for k in ("l_shipdate", "l_commitdate", "l_receiptdate"))
    late = (receipt > commit) | (ship > commit)
    last = np.maximum(np.maximum(ship, commit), receipt)
    modes = sorted(RECODE_MODE_WEIGHTS)
    mode_codes = np.searchsorted(np.asarray(modes, object), line["l_shipmode"])
    weight = np.asarray([RECODE_MODE_WEIGHTS[m] for m in modes])[mode_codes]
    flag_names = sorted({RECODE_FLAGS.get(f, f) for f in ("A", "N", "R")})
    raw_flags = sorted(RECODE_FLAGS.keys() | {"N"})
    flag_of = np.asarray([flag_names.index(RECODE_FLAGS.get(f, f)) for f in raw_flags])
    flag_codes = flag_of[np.searchsorted(np.asarray(raw_flags, object), line["l_returnflag"])]
    nb, nm, nf = len(RECODE_BANDS) + 1, len(modes), len(flag_names)
    key = (band * nm + mode_codes) * nf + flag_codes
    k = nb * nm * nf
    n = np.bincount(key, minlength=k)
    present = np.flatnonzero(n)
    if np.abs(cents).sum() >= 2**53 or np.abs(charge).sum() >= 2**53:
        raise ValueError("the f64 sums of the oracle would not be exact")
    day0 = last.min()
    span = int(last.max() - day0) + 1
    seen = np.bincount(key * span + (last - day0), minlength=k * span).reshape(k, span) > 0
    last_max = day0 + span - 1 - np.argmax(seen[:, ::-1], axis=1)
    labels = [f"({a}, {b}]" for a, b in zip(["-inf", *map(str, RECODE_BANDS)], [*map(str, RECODE_BANDS), "inf"])]
    out_line = {
        "band": [labels[p // (nm * nf)] for p in present],
        "l_shipmode": [modes[p // nf % nm] for p in present],
        "flag": [flag_names[p % nf] for p in present],
        "len": n[present].astype(np.int64),
        "cents": np.bincount(key, weights=cents, minlength=k)[present].astype(np.int64),
        "charge": np.bincount(key, weights=charge, minlength=k)[present].astype(np.int64),
        "rate": np.bincount(key, weights=disc + tax, minlength=k)[present] / n[present],
        "late": np.bincount(key, weights=late, minlength=k)[present].astype(np.int64),
        "last": last_max[present],
        "weighted": np.bincount(key, weights=weight * qty, minlength=k)[present],
    }

    breaks = _linear_quantiles(price, [i / 10 for i in range(1, 10)])
    decile = np.zeros(len(price), np.int64)
    for b in breaks:
        decile += price > b
    okey = line["l_orderkey"]
    run = np.cumsum(np.concatenate([[0], okey[1:] != okey[:-1]]))
    keep = splitmix64(okey, RECODE_SEED) % np.uint64(RECODE_SAMPLE) == 0
    d, r, q, p = decile[keep], run[keep], qty[keep], price[keep]
    sample = {k2: [] for k2 in ("decile", "len", "orders", "r", "rho", "cov")}
    for g in np.unique(d):
        rows = d == g
        pr, cov = _pearson_ld(q[rows], p[rows])
        rho, _ = _pearson_ld(_avg_rank(q[rows]), _avg_rank(p[rows]))
        sample["decile"].append(RECODE_DECILES[g])
        sample["len"].append(int(rows.sum()))
        sample["orders"].append(len(np.unique(r[rows])))
        sample["r"].append(pr)
        sample["rho"].append(rho)
        sample["cov"].append(cov)
    sample = {k2: v if k2 == "decile" else np.asarray(v) for k2, v in sample.items()}
    return {"line": out_line, "sample": sample, "sampled_rows": int(keep.sum())}


def check_recode(out, want: dict, label: str, exact=(), floats=(), dates=()) -> float:
    """``out`` against the oracle: the exact columns equal (Decimals as
    their cents, dates as days), floats to rtol 1e-9; the largest relative
    error."""
    worst = 0.0
    for name, w in want.items():
        got = out[name].to_list()
        if name in exact:
            if name in ("cents", "charge"):
                got = [int(v.scaleb(2)) for v in got]
            if got != (w if isinstance(w, list) else np.asarray(w).tolist()):
                raise AssertionError(f"{label} {name}: {got[:8]} != {list(w)[:8]}")
        elif name in dates:
            days = [(v - EPOCH).days for v in got]
            if days != list(np.asarray(w).tolist()):
                raise AssertionError(f"{label} {name}: {days[:8]} != {list(w)[:8]}")
        elif name in floats:
            g = np.asarray(got, np.float64)
            err = np.abs(g - w) / np.maximum(np.abs(w), 1e-300)
            if not np.all(err <= 1e-9):
                raise AssertionError(f"{label} {name}: largest relative error {err.max()}")
            worst = max(worst, float(err.max(initial=0.0)))
    return worst


# -- strings -------------------------------------------------------------------------------

STRINGS_CUST_COLUMNS = {"customer": ["c_custkey", "c_name", "c_address", "c_phone", "c_mktsegment"],
                        "orders": ["o_custkey", "o_totalprice", "o_orderpriority"]}
STRINGS_LINE_COLUMNS = ["l_quantity", "l_returnflag", "l_linestatus", "l_shipinstruct", "l_shipmode", "l_comment"]
STRINGS_MODE_LOW, STRINGS_MODE_HIGH = "FOB", "RAIL"


def strings_plans(pl, customer, orders, line) -> dict:
    """``strings.cust`` over customer and orders frames, ``strings.line``
    over a lineitem frame (either may be None)."""
    from polars_tpu_torch.testing.pdsh import _SEGMENTS, _SHIPMODES

    c = pl.col
    out = {}
    if customer is not None:
        out["cust"] = (
            orders.lazy().join(customer.lazy(), left_on="o_custkey", right_on="c_custkey")
            .with_columns(seg=c("c_mktsegment").cast(pl.Enum(_SEGMENTS)),
                          prio=c("o_orderpriority").cast(pl.Categorical),
                          digit=c("o_orderpriority").str.extract(r"^(\d)-", 1).str.to_integer())
            .group_by("c_address")
            .agg(c("c_name").first(), c("o_totalprice").sum().alias("spend"), pl.len(), c("digit").sum(),
                 c("prio").min(), c("c_phone").max(), c("seg").first())
            .with_columns(label=pl.concat_str([c("seg"), c("c_name").str.to_uppercase()], separator="|"))
            .with_columns(label_len=c("label").str.len_chars(),
                          number=c("c_name").str.extract(r"#0*(\d+)", 1).str.to_integer())
            .sort("c_address"))
    if line is not None:
        out["line"] = (
            line.lazy().with_columns(
                mode=c("l_shipmode").cast(pl.Enum(_SHIPMODES)),
                instr=c("l_shipinstruct").str.to_lowercase().str.replace_all(" ", "_"),
                flags=c("l_returnflag") + c("l_linestatus"),
                cnum=c("l_comment").str.extract(r"(\d+)$", 1).str.to_integer(),
                clen=c("l_comment").str.len_chars(),
                air=c("l_shipmode").str.contains_any(["AIR"]),
                mid=c("l_shipmode").is_between(STRINGS_MODE_LOW, STRINGS_MODE_HIGH))
            .group_by("flags", "mode")
            .agg(pl.len(), c("l_quantity").sum(), c("l_comment").min().alias("cmin"),
                 c("l_comment").max().alias("cmax"), c("instr").max(), c("cnum").sum(), c("clen").mean(),
                 c("air").sum(), c("mid").sum())
            .sort("flags", "mode"))
    return out


def _text_codes(values: np.ndarray) -> tuple[list, np.ndarray]:
    """(the sorted distinct strings, each row's index among them) by one
    dictionary lookup per row, without sorting the rows."""
    rows = values.tolist()
    levels = sorted(set(rows))
    rank = dict(zip(levels, range(len(levels))))
    return levels, np.fromiter(map(rank.__getitem__, rows), np.int64, count=len(rows))


def _group_extreme(key: np.ndarray, code: np.ndarray, k: int, m: int, largest: bool) -> np.ndarray:
    """The least (or greatest) of ``code`` (in [0, m)) per group of ``key``
    (in [0, k)), by which (group, code) pairs occur."""
    seen = np.bincount(key * m + code, minlength=k * m).reshape(k, m) > 0
    return m - 1 - np.argmax(seen[:, ::-1], axis=1) if largest else np.argmax(seen, axis=1)


def strings_oracle(customer: dict | None, orders: dict | None, line: dict | None) -> dict:
    """The strings phase in numpy, per distinct value and then gathered:
    ``strings.cust`` keyed by customer key (``c_address`` is ``addr{key-1}``,
    sorted by one host argsort of the addresses), ``strings.line`` per
    (flags, mode) by ``bincount``. Keys, strings and counts exact; sums of
    money in f64."""
    import re

    from polars_tpu_torch.testing.pdsh import _SEGMENTS, _SHIPMODES

    out = {}
    if customer is not None:
        ck = orders["o_custkey"] - 1
        nc = len(customer["c_custkey"])
        n = np.bincount(ck, minlength=nc)
        has = np.flatnonzero(n)
        pri_levels, pri = _text_codes(orders["o_orderpriority"])
        digit = np.asarray([int(p.split("-")[0]) for p in pri_levels])[pri]
        pmin = _group_extreme(ck, pri, nc, len(pri_levels), False)
        addr = customer["c_address"][has]
        order = np.argsort(addr.astype(str), kind="stable")
        rows = has[order]
        names = customer["c_name"][rows]
        segs = customer["c_mktsegment"][rows]
        labels = [f"{s}|{nm.upper()}" for s, nm in zip(segs.tolist(), names.tolist())]
        out["cust"] = {
            "c_address": addr[order].tolist(), "c_name": names.tolist(),
            "spend": np.bincount(ck, weights=orders["o_totalprice"], minlength=nc)[rows],
            "len": n[rows], "digit": np.bincount(ck, weights=digit, minlength=nc)[rows].astype(np.int64),
            "prio": [pri_levels[i] for i in pmin[rows]], "c_phone": customer["c_phone"][rows].tolist(),
            "seg": segs.tolist(), "label": labels, "label_len": np.asarray([len(x) for x in labels]),
            "number": np.asarray([int(re.search(r"#0*(\d+)", x).group(1)) for x in names.tolist()]),
        }
    if line is not None:
        rf_levels, rf = _text_codes(line["l_returnflag"])
        ls_levels, ls = _text_codes(line["l_linestatus"])
        mode_levels, mode = _text_codes(line["l_shipmode"])
        enum_pos = np.asarray([_SHIPMODES.index(m) for m in mode_levels])
        in_levels, instr = _text_codes(line["l_shipinstruct"])
        cm_levels, cm = _text_codes(line["l_comment"])
        flag_names = sorted(a + b for a in rf_levels for b in ls_levels)
        flag = np.asarray([[flag_names.index(a + b) for b in ls_levels] for a in rf_levels])[rf, ls]
        nm = len(_SHIPMODES)
        key = flag * nm + enum_pos[mode]
        k = len(flag_names) * nm
        n = np.bincount(key, minlength=k)
        present = np.flatnonzero(n)
        instr_text = [s.lower().replace(" ", "_") for s in in_levels]
        instr_rank = np.argsort(np.argsort(instr_text))
        instr_sorted = sorted(instr_text)
        cnum = np.asarray([int(re.search(r"(\d+)$", s).group(1)) if re.search(r"(\d+)$", s) else 0
                           for s in cm_levels])
        if not all(re.search(r"(\d+)$", s) for s in cm_levels):
            raise ValueError("the oracle expects every comment to end in a number")
        clen = np.asarray([len(s) for s in cm_levels], np.float64)
        air = np.asarray(["AIR" in m for m in mode_levels])
        mid = np.asarray([STRINGS_MODE_LOW <= m <= STRINGS_MODE_HIGH for m in mode_levels])
        cmin = _group_extreme(key, cm, k, len(cm_levels), False)
        cmax = _group_extreme(key, cm, k, len(cm_levels), True)
        imax = _group_extreme(key, instr_rank[instr], k, len(in_levels), True)
        out["line"] = {
            "flags": [flag_names[p // nm] for p in present], "mode": [_SHIPMODES[p % nm] for p in present],
            "len": n[present], "l_quantity": np.bincount(key, weights=line["l_quantity"], minlength=k)[present],
            "cmin": [cm_levels[i] for i in cmin[present]], "cmax": [cm_levels[i] for i in cmax[present]],
            "instr": [instr_sorted[i] for i in imax[present]],
            "cnum": np.bincount(key, weights=cnum[cm], minlength=k)[present].astype(np.int64),
            "clen": np.bincount(key, weights=clen[cm], minlength=k)[present] / n[present],
            "air": np.bincount(key, weights=air[mode], minlength=k)[present].astype(np.int64),
            "mid": np.bincount(key, weights=mid[mode], minlength=k)[present].astype(np.int64),
        }
    return out


def check_strings(out, want: dict, label: str, floats=()) -> float:
    """``out`` against the oracle: every column equal but ``floats``, which
    agree to rtol 1e-9; the largest relative error."""
    worst = 0.0
    for name, w in want.items():
        got = out[name].to_list()
        if name in floats:
            g = np.asarray(got, np.float64)
            err = np.abs(g - w) / np.maximum(np.abs(w), 1e-300)
            if not np.all(err <= 1e-9):
                raise AssertionError(f"{label} {name}: largest relative error {err.max()}")
            worst = max(worst, float(err.max(initial=0.0)))
        elif got != (w if isinstance(w, list) else np.asarray(w).tolist()):
            bad = next(i for i, (a, b) in enumerate(zip(got, list(w))) if a != b) if len(got) == len(w) else -1
            raise AssertionError(f"{label} {name}: first difference at row {bad} of {len(got)} "
                                 f"(lengths {len(got)}, {len(w)})")
    return worst


NESTED_COLUMNS = ["l_orderkey", "l_extendedprice", "l_quantity", "l_shipmode", "l_comment"]
NESTED_MIN_LINES = 5  # nested.explode keeps the orders of at least this many lines


def nested_plans(pl, line) -> dict:
    """``nested.orders`` and ``nested.explode`` over a lineitem frame."""
    c = pl.col
    baskets = line.lazy().group_by("l_orderkey").agg(
        c("l_extendedprice").alias("prices"), c("l_quantity").alias("qty"), c("l_shipmode").alias("modes"))
    orders = (
        baskets.with_columns(n=c("prices").list.len(), total=c("prices").list.sum(), avg_qty=c("qty").list.mean(),
                             top=c("prices").list.max(), air=c("modes").list.contains("AIR"),
                             first_mode=c("modes").list.sort().list.first())
        .select("l_orderkey", "n", "total", "avg_qty", "top", "air", "first_mode")
        .sort("l_orderkey"))
    words = c("l_comment").str.split(" ")
    explode = (
        line.lazy().with_columns(words=words.list.len(), num=words.list.last().str.to_integer())
        .group_by("l_orderkey").agg(c("l_extendedprice").alias("prices"), c("l_quantity").alias("qty"),
                                    c("l_shipmode").alias("modes"), c("words"), c("num"))
        .filter(c("prices").list.len() >= NESTED_MIN_LINES)
        .explode("prices", "qty", "modes", "words", "num")
        .with_columns(pair=pl.struct(c("qty").alias("q"), c("num").alias("k")))
        .unnest("pair")
        .group_by("modes")
        .agg(pl.len(), c("prices").sum().alias("price"), c("prices").mean().alias("avg_price"),
             c("q").sum().alias("qty"), c("k").sum().alias("num"), c("words").sum())
        .sort("modes"))
    return {"orders": orders, "explode": explode}


def nested_oracle(line: dict) -> dict:
    """The nested phase in numpy over the lines (sorted by order key, as
    ``testing/pdsh.generate_pdsh`` makes them): per order by ``reduceat``
    over each order's run of lines, per ship mode by ``bincount``. Keys,
    counts and strings exact; sums and means of money in f64."""
    import re

    key = line["l_orderkey"]
    if np.any(key[1:] < key[:-1]):
        raise ValueError("the oracle expects the lines sorted by order key")
    start = np.flatnonzero(np.r_[True, key[1:] != key[:-1]])
    n = np.diff(np.r_[start, len(key)])
    price, qty = line["l_extendedprice"], line["l_quantity"]
    mode_levels, mode = _text_codes(line["l_shipmode"])
    air = mode == mode_levels.index("AIR") if "AIR" in mode_levels else np.zeros(len(mode), bool)
    out = {"orders": {
        "l_orderkey": key[start], "n": n, "total": np.add.reduceat(price, start), "avg_qty":
            np.add.reduceat(qty, start) / n, "top": np.maximum.reduceat(price, start),
        "air": np.maximum.reduceat(air, start), "first_mode": np.minimum.reduceat(mode, start),
    }, "mode_levels": mode_levels}
    cm_levels, cm = _text_codes(line["l_comment"])
    nums = np.asarray([int(re.search(r"(-?\d+)$", s).group(1)) for s in cm_levels], np.int64)
    words = np.asarray([len(s.split(" ")) for s in cm_levels], np.int64)
    keep = np.repeat(n >= NESTED_MIN_LINES, n)
    m, k = mode[keep], len(mode_levels)
    cnt = np.bincount(m, minlength=k)
    present = np.flatnonzero(cnt)
    psum = np.bincount(m, weights=price[keep], minlength=k)
    out["explode"] = {
        "modes": present, "len": cnt[present], "price": psum[present], "avg_price": psum[present] / cnt[present],
        "qty": np.bincount(m, weights=qty[keep], minlength=k)[present],
        "num": np.bincount(m, weights=nums[cm[keep]], minlength=k)[present].astype(np.int64),
        "words": np.bincount(m, weights=words[cm[keep]], minlength=k)[present].astype(np.int64),
    }
    out["exploded_rows"] = int(keep.sum())
    return out


def check_nested(out, want: dict, levels: list, label: str, floats=(), strings=()) -> float:
    """``out`` against the oracle column by column in numpy: every column
    equal but ``floats`` (rtol 1e-9); ``strings`` as indices into
    ``levels`` (the output's dictionary mapped onto them). The largest
    relative error."""
    worst = 0.0
    for name, w in want.items():
        col = out._get(name)
        if name in strings:
            lut = np.asarray([levels.index(v) for v in col.table.values.tolist()] or [0], np.int64)
            vals, validity = col._host()
            if validity is not None:
                raise AssertionError(f"{label} {name}: nulls where the oracle has none")
            got = lut[vals]
        else:
            got = np.asarray(col.to_numpy())
        w = np.asarray(w)
        if got.shape != w.shape:
            raise AssertionError(f"{label} {name}: {got.shape[0]} rows, the oracle has {w.shape[0]}")
        if name in floats:
            err = np.abs(got.astype(np.float64) - w) / np.maximum(np.abs(w), 1e-300)
            if not np.all(err <= 1e-9):
                raise AssertionError(f"{label} {name}: largest relative error {err.max()}")
            worst = max(worst, float(err.max(initial=0.0)))
        elif not np.array_equal(got, w):
            bad = int(np.flatnonzero(got != w)[0])
            raise AssertionError(f"{label} {name}: first difference at row {bad} of {got.shape[0]}: "
                                 f"{got[bad]!r} against {w[bad]!r}")
    return worst


RESHAPE_COLUMNS = ["l_orderkey", "l_suppkey", "l_returnflag", "l_shipmode", "l_quantity", "l_extendedprice",
                   "l_discount", "l_tax"]
RESHAPE_MEASURES = ["l_quantity", "l_extendedprice", "l_discount", "l_tax"]
RESHAPE_PIVOT_VALUES = ["l_quantity", "l_extendedprice"]


def reshape_plans(pl, line) -> dict:
    """``reshape.pivot`` (a supplier x ship-mode matrix of the summed
    quantity and price; the pivot collects at its node, so building the
    plan runs it) and ``reshape.unpivot`` (four measures in long form, then
    per measure and return flag the sum, the mean and the count), each a
    function that gives the LazyFrame to collect."""
    c = pl.col

    def pivot():
        return line.lazy().pivot(on="l_shipmode", index="l_suppkey", values=RESHAPE_PIVOT_VALUES,
                                 aggregate_function="sum", sort_columns=True).sort("l_suppkey")

    def unpivot():
        return (line.lazy().unpivot(on=RESHAPE_MEASURES, index=["l_orderkey", "l_returnflag"])
                .group_by("variable", "l_returnflag")
                .agg(c("value").sum().alias("sum"), c("value").mean().alias("mean"), pl.len())
                .sort("variable", "l_returnflag"))

    return {"pivot": pivot, "unpivot": unpivot}


def reshape_oracle(line: dict) -> dict:
    """The reshape phase in numpy: per (supplier, ship mode) cell the sums by
    ``bincount`` over ``supplier * modes + mode`` (a cell with no line is
    null), per (measure, return flag) the sums and counts by ``bincount``
    over the flag's codes."""
    mode_levels, mode = _text_codes(line["l_shipmode"])
    supp, supp_idx = np.unique(line["l_suppkey"], return_inverse=True)
    k = len(mode_levels)
    cell = supp_idx.reshape(-1) * k + mode
    count = np.bincount(cell, minlength=len(supp) * k).reshape(len(supp), k)
    pivot: dict = {"l_suppkey": supp}
    for v in RESHAPE_PIVOT_VALUES:
        sums = np.bincount(cell, weights=line[v], minlength=len(supp) * k).reshape(len(supp), k)
        for j, m in enumerate(mode_levels):  # _text_codes' levels are sorted, as sort_columns orders them
            pivot[f"{v}_{m}"] = np.where(count[:, j] > 0, sums[:, j], np.nan)
    flag_levels, flag = _text_codes(line["l_returnflag"])
    n = np.bincount(flag, minlength=len(flag_levels))
    rows = {"variable": [], "l_returnflag": [], "sum": [], "mean": [], "len": []}
    for v in sorted(RESHAPE_MEASURES):
        s = np.bincount(flag, weights=line[v], minlength=len(flag_levels))
        for j, f in enumerate(flag_levels):
            if n[j]:
                rows["variable"].append(v)
                rows["l_returnflag"].append(f)
                rows["sum"].append(s[j])
                rows["mean"].append(s[j] / n[j])
                rows["len"].append(int(n[j]))
    return {"pivot": pivot, "unpivot": {k2: np.asarray(v2) for k2, v2 in rows.items()},
            "long_rows": len(mode) * len(RESHAPE_MEASURES)}


def check_reshape(out, want: dict, label: str, floats=(), strings=()) -> float:
    """``out`` against the oracle column by column: ``strings`` and the
    rest exactly, ``floats`` to rtol 1e-9 with nulls where the oracle has
    NaN. The largest relative error."""
    worst = 0.0
    if out.columns != list(want):
        raise AssertionError(f"{label}: columns {out.columns} != {list(want)}")
    for name, w in want.items():
        col = out._get(name)
        got = np.asarray(col.to_pylist(), dtype=object) if name in strings else np.asarray(col.to_numpy())
        w = np.asarray(w)
        if got.shape != w.shape:
            raise AssertionError(f"{label} {name}: {got.shape[0]} rows, the oracle has {w.shape[0]}")
        if name in floats:
            got = got.astype(np.float64)
            if not np.array_equal(np.isnan(got), np.isnan(w)):
                raise AssertionError(f"{label} {name}: nulls differ from the oracle's")
            ok = ~np.isnan(w)
            err = np.abs(got[ok] - w[ok]) / np.maximum(np.abs(w[ok]), 1e-300)
            if not np.all(err <= 1e-9):
                raise AssertionError(f"{label} {name}: largest relative error {err.max()}")
            worst = max(worst, float(err.max(initial=0.0)))
        elif not np.array_equal(got, w):
            bad = int(np.flatnonzero(got != w)[0])
            raise AssertionError(f"{label} {name}: first difference at row {bad}: {got[bad]!r} against {w[bad]!r}")
    return worst


NESTKEYS_LINE_COLUMNS = ["l_orderkey", "l_extendedprice", "l_quantity", "l_shipmode", "l_returnflag",
                         "l_linestatus"]
NESTKEYS_ORDER_COLUMNS = ["o_orderkey", "o_orderpriority", "o_orderdate"]


def nestkeys_plans(pl, line, orders) -> dict:
    """Nested values as keys, each a LazyFrame: ``baskets`` (which sets of
    ship modes orders use: per order the sorted distinct modes, a List,
    then the orders, revenue and lines per set, sorted by the set),
    ``basket_stats`` (over the orders in key order: the distinct sets, the
    distinct hashes of them, the first rows of each set and the orders
    whose set equals the previous order's), ``struct_rank`` (the orders
    sorted by a Struct of priority and date, descending, with the run of
    each key), ``struct_groups`` (the lines grouped by a Struct of return
    flag, line status and ship mode, unnested) and ``struct_distinct``
    (the distinct (priority, date) Structs, counted)."""
    c = pl.col
    out = {}
    if line is not None:
        per_order = line.lazy().group_by("l_orderkey").agg(
            modes=c("l_shipmode").unique().sort(), rev=c("l_extendedprice").sum(), n=pl.len())
        out["baskets"] = (per_order.group_by("modes")
                          .agg(orders=pl.len(), rev=c("rev").sum(), lines=c("n").sum()).sort("modes"))
        out["basket_stats"] = per_order.sort("l_orderkey").select(
            distinct=c("modes").n_unique(), hashes=c("modes").hash().n_unique(),
            firsts=c("modes").is_first_distinct().sum(), repeats=(c("modes") == c("modes").shift(1)).sum())
        key = pl.struct("l_returnflag", "l_linestatus", "l_shipmode").alias("key")
        out["struct_groups"] = (line.lazy().group_by(key)
                                .agg(qty=c("l_quantity").sum(), rev=c("l_extendedprice").sum(), n=pl.len())
                                .sort("key").unnest("key"))
    if orders is not None:
        key = pl.struct("o_orderpriority", "o_orderdate").alias("key")
        out["struct_rank"] = (orders.lazy().select("o_orderkey", key)
                              .sort("key", descending=True, maintain_order=True)
                              .select("o_orderkey", run=c("key").rle_id()))
        out["struct_distinct"] = orders.lazy().select(key).unique().select(pl.len())
    return out


def nestkeys_oracle(line: dict | None, orders: dict | None) -> dict:
    """The nestkeys plans in numpy. Per order (the lines sorted by order
    key, as ``testing/pdsh.generate_pdsh`` makes them) one 7-bit mask of
    its ship modes by ``np.bitwise_or.reduceat``; ``np.unique`` of the
    masks; the sets (at most 127) ordered in Python as lists of mode names,
    the order of Polars' List sort. The Struct sort by ``np.lexsort`` over
    the codes (stable, so ties keep the orders' order), the groups and the
    distinct pairs by ``np.unique`` of one combined code. Keys and counts
    exact, sums of money in f64."""
    out: dict = {}
    if line is not None:
        key = line["l_orderkey"]
        if np.any(key[1:] < key[:-1]):
            raise ValueError("the oracle expects the lines sorted by order key")
        start = np.flatnonzero(np.r_[True, key[1:] != key[:-1]])
        n = np.diff(np.r_[start, len(key)])
        mode_levels, mode = _text_codes(line["l_shipmode"])
        masks = np.bitwise_or.reduceat(np.left_shift(1, mode), start)
        rev = np.add.reduceat(line["l_extendedprice"], start)
        uniq, inv = np.unique(masks, return_inverse=True)
        inv = inv.reshape(-1)
        sets = [[mode_levels[b] for b in range(len(mode_levels)) if (int(m) >> b) & 1] for m in uniq]
        order = sorted(range(len(sets)), key=lambda i: sets[i])
        out["baskets"] = {
            "modes": [sets[i] for i in order],
            "orders": np.bincount(inv, minlength=len(uniq))[order],
            "rev": np.bincount(inv, weights=rev, minlength=len(uniq))[order],
            "lines": np.bincount(inv, weights=n, minlength=len(uniq)).astype(np.int64)[order],
        }
        out["basket_stats"] = {"distinct": np.asarray([len(uniq)]), "hashes": np.asarray([len(uniq)]),
                               "firsts": np.asarray([len(uniq)]),
                               "repeats": np.asarray([int(np.sum(masks[1:] == masks[:-1]))])}
        out["orders_with_lines"] = len(start)
        flag_levels, flag = _text_codes(line["l_returnflag"])
        status_levels, status = _text_codes(line["l_linestatus"])
        k_s, k_m = len(status_levels), len(mode_levels)
        combined = (flag * k_s + status) * k_m + mode
        cells, cinv = np.unique(combined, return_inverse=True)
        cinv = cinv.reshape(-1)
        out["struct_groups"] = {
            "l_returnflag": [flag_levels[v] for v in (cells // (k_s * k_m)).tolist()],
            "l_linestatus": [status_levels[v] for v in ((cells // k_m) % k_s).tolist()],
            "l_shipmode": [mode_levels[v] for v in (cells % k_m).tolist()],
            "qty": np.bincount(cinv, weights=line["l_quantity"], minlength=len(cells)),
            "rev": np.bincount(cinv, weights=line["l_extendedprice"], minlength=len(cells)),
            "n": np.bincount(cinv, minlength=len(cells)),
        }
    if orders is not None:
        _, prio = _text_codes(orders["o_orderpriority"])
        date = np.asarray(orders["o_orderdate"]).astype("datetime64[D]").astype(np.int64)
        order = np.lexsort((-date, -prio))
        p, d = prio[order], date[order]
        change = np.r_[True, (p[1:] != p[:-1]) | (d[1:] != d[:-1])]
        out["struct_rank"] = {"o_orderkey": np.asarray(orders["o_orderkey"])[order],
                              "run": np.cumsum(change) - 1}
        out["struct_distinct"] = {"len": np.asarray([int(change.sum())])}
    return out


def check_nestkeys(out, want: dict, label: str, floats=(), lists=(), strings=()) -> float:
    """``out`` against the oracle column by column: ``lists`` and
    ``strings`` as Python values, the rest as numpy arrays, exactly but
    ``floats`` (rtol 1e-9). The largest relative error."""
    worst = 0.0
    if out.columns != list(want):
        raise AssertionError(f"{label}: columns {out.columns} != {list(want)}")
    for name, w in want.items():
        col = out._get(name)
        if name in lists or name in strings:
            got = col.to_pylist()
            if got != list(w):
                bad = next(i for i, (a, b) in enumerate(zip(got + [None], list(w) + [None])) if a != b)
                raise AssertionError(f"{label} {name}: first difference at row {bad} of {len(got)} "
                                     f"(the oracle has {len(w)})")
            continue
        got, w = np.asarray(col.to_numpy()), np.asarray(w)
        if got.shape != w.shape:
            raise AssertionError(f"{label} {name}: {got.shape[0]} rows, the oracle has {w.shape[0]}")
        if name in floats:
            err = np.abs(got.astype(np.float64) - w) / np.maximum(np.abs(w), 1e-300)
            if not np.all(err <= 1e-9):
                raise AssertionError(f"{label} {name}: largest relative error {err.max()}")
            worst = max(worst, float(err.max(initial=0.0)))
        elif not np.array_equal(got, w):
            bad = int(np.flatnonzero(got != w)[0])
            raise AssertionError(f"{label} {name}: first difference at row {bad}: {got[bad]!r} against {w[bad]!r}")
    return worst


# -- io ---------------------------------------------------------------------------------------

IO_LINE_COLUMNS = ["l_suppkey", "l_shipdate", "l_extendedprice", "l_discount"]
IO_FILE_COLUMNS = IO_LINE_COLUMNS + ["l_quantity", "l_tax"]  # the Parquet file's: two the plan does not read
IO_SINCE, IO_UNTIL = dtm.date(1995, 1, 1), dtm.date(1997, 1, 1)
IO_SUPPLIER_QUERY = "select s_suppkey, s_name, s_nationkey, s_acctbal from supplier order by s_suppkey"
IO_NATION_QUERY = "select n_nationkey, n_name from nation order by n_nationkey"


def io_database(supplier: dict, nation: dict, path: str):
    """An in-memory ``sqlite3`` database of the generator's ``supplier`` and
    ``nation`` (the columns the queries read), and a copy of it in the file
    ``path``; the open in-memory connection."""
    import sqlite3

    conn = sqlite3.connect(":memory:")
    conn.execute("create table supplier (s_suppkey integer primary key, s_name text, s_nationkey integer, "
                 "s_acctbal real)")
    conn.executemany("insert into supplier values (?, ?, ?, ?)", zip(
        np.asarray(supplier["s_suppkey"]).tolist(), list(supplier["s_name"]),
        np.asarray(supplier["s_nationkey"]).tolist(), np.asarray(supplier["s_acctbal"]).tolist()))
    conn.execute("create table nation (n_nationkey integer primary key, n_name text)")
    conn.executemany("insert into nation values (?, ?)",
                     zip(np.asarray(nation["n_nationkey"]).tolist(), list(nation["n_name"])))
    conn.commit()
    copy = sqlite3.connect(path)
    conn.backup(copy)
    copy.close()
    return conn


def io_plan(pl, line, supplier, nation):
    return (
        line.lazy()
        .filter((pl.col("l_shipdate") >= IO_SINCE) & (pl.col("l_shipdate") < IO_UNTIL))
        .join(supplier.lazy(), left_on="l_suppkey", right_on="s_suppkey", validate="m:1")
        .join(nation.lazy(), left_on="s_nationkey", right_on="n_nationkey", validate="m:1")
        .group_by("n_name")
        .agg(revenue=(pl.col("l_extendedprice") * (1 - pl.col("l_discount"))).sum(), lines=pl.len())
        .sort("n_name")
    )


def io_write_parquet(line: dict, path: str, row_groups: int = 60) -> dict:
    """``IO_FILE_COLUMNS`` of lineitem as one Parquet file, sorted by ship
    date (a date-clustered fact table) in ``row_groups`` row groups (1M rows
    each at SF10), with pyarrow; its size and row groups."""
    import os

    import pyarrow as pa
    import pyarrow.parquet as pq

    days = np.asarray(line["l_shipdate"]).astype("datetime64[D]").astype(np.int64)
    order = np.argsort((days - days.min()).astype(np.int16), kind="stable")  # a radix sort: 7 years of days
    table = pa.table({c: pa.array(np.asarray(line[c]).take(order)) for c in IO_FILE_COLUMNS})
    pq.write_table(table, path, row_group_size=max(-(-len(order) // row_groups), 1000), use_dictionary=False)
    return {"bytes": os.path.getsize(path), "row_groups": pq.ParquetFile(path).metadata.num_row_groups}


def io_oracle(line: dict, supplier: dict, nation: dict) -> dict:
    """``io_plan`` in numpy: each kept line's nation by two lookups, then
    one weighted count per nation."""
    days = np.asarray(line["l_shipdate"]).astype("datetime64[D]").astype(np.int64)
    lo, hi = ((d - EPOCH).days for d in (IO_SINCE, IO_UNTIL))
    keep = (days >= lo) & (days < hi)
    supp_key = np.asarray(supplier["s_suppkey"])
    nation_of = np.full(int(supp_key.max()) + 1, -1, np.int64)
    nation_of[supp_key] = np.asarray(supplier["s_nationkey"])
    nat = nation_of[np.asarray(line["l_suppkey"])[keep]]
    rev = np.asarray(line["l_extendedprice"])[keep] * (1 - np.asarray(line["l_discount"])[keep])
    keys = np.asarray(nation["n_nationkey"])
    sums = np.bincount(nat, weights=rev, minlength=int(keys.max()) + 1)[keys]
    counts = np.bincount(nat, minlength=int(keys.max()) + 1)[keys]
    names = np.asarray(nation["n_name"], dtype=object)
    order = np.argsort(names.astype(str), kind="stable")
    order = order[counts[order] > 0]
    return {"n_name": names[order], "revenue": sums[order], "lines": counts[order].astype(np.uint32)}

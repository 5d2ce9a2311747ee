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
  midnight, then summed by local year and month.
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

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
  once.
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

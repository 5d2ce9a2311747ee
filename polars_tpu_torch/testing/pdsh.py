"""PDS-H (TPC-H-derived) data generator + reference queries (copied from
polars_tpu/testing/pdsh.py: ``generate_pdsh`` unchanged, ``q1`` on this
package).

Seeded numpy generator producing the TPC-H schema at a given scale factor
(reference test pattern: py-polars/tests/benchmark/data/ + the pdsh logic
tests, crates/polars-lazy/src/tests/pdsh.rs). Row counts follow the TPC-H
spec ratios; value distributions are simplified but exercise the same paths
(dates, dictionary keys, skewed foreign keys, monetary decimals-as-floats).
"""

from __future__ import annotations

import datetime as dtm

import numpy as np

_NATIONS = [
    "ALGERIA", "ARGENTINA", "BRAZIL", "CANADA", "EGYPT", "ETHIOPIA", "FRANCE",
    "GERMANY", "INDIA", "INDONESIA", "IRAN", "IRAQ", "JAPAN", "JORDAN", "KENYA",
    "MOROCCO", "MOZAMBIQUE", "PERU", "CHINA", "ROMANIA", "SAUDI ARABIA",
    "VIETNAM", "RUSSIA", "UNITED KINGDOM", "UNITED STATES",
]
_REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
_NATION_REGION = [0, 1, 1, 1, 4, 0, 3, 3, 2, 2, 4, 4, 2, 4, 0, 0, 0, 1, 2, 3, 4, 2, 3, 3, 1]
_SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY"]
_PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
_SHIPMODES = ["AIR", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP", "TRUCK"]
_INSTRUCTIONS = ["COLLECT COD", "DELIVER IN PERSON", "NONE", "TAKE BACK RETURN"]

_EPOCH = dtm.date(1970, 1, 1)
_START = (dtm.date(1992, 1, 1) - _EPOCH).days
_END = (dtm.date(1998, 12, 1) - _EPOCH).days


def _dates(rng, n, lo=_START, hi=_END):
    return rng.integers(lo, hi, n).astype("datetime64[D]")


def _mod_strings(fmt, period, n):
    """Vectorized ``[fmt(i) for i in range(n)]`` where fmt only depends on
    ``i % period``: synthesize the period once, gather the rest. Turns the
    60M-row SF10 comment columns from minutes of f-string loops into an
    indexed take (bench budget, VERDICT r3 item 2)."""
    table = np.asarray([fmt(i) for i in range(min(period, n))], object)
    if n <= period:
        return table[:n]
    return table[np.arange(n, dtype=np.int64) % period]


def generate_pdsh(scale: float = 0.01, seed: int = 42, tables=None) -> dict:
    """TPC-H tables as dicts of numpy arrays.

    ``tables``: optional iterable restricting which tables to build (each
    table draws from its own child rng, so a subset is value-identical to
    the same table in a full run)."""
    want = None if tables is None else set(tables)

    def _rng(k):
        return np.random.default_rng([seed, k])

    rng = _rng(0)
    n_cust = max(int(150_000 * scale), 10)
    n_orders = n_cust * 10
    n_line = int(n_orders * 4)
    n_part = max(int(200_000 * scale), 10)
    n_supp = max(int(10_000 * scale), 5)
    n_psupp = n_part * 4

    region = {
        "r_regionkey": np.arange(5, dtype=np.int64),
        "r_name": np.asarray(_REGIONS, object),
        "r_comment": np.asarray([f"region comment {i}" for i in range(5)], object),
    }
    nation = {
        "n_nationkey": np.arange(25, dtype=np.int64),
        "n_name": np.asarray(_NATIONS, object),
        "n_regionkey": np.asarray(_NATION_REGION, np.int64),
        "n_comment": np.asarray([f"nation comment {i}" for i in range(25)], object),
    }
    rng = _rng(1)
    customer = {
        "c_custkey": np.arange(1, n_cust + 1, dtype=np.int64),
        "c_name": np.char.add("Customer#", np.char.zfill(
            np.arange(1, n_cust + 1).astype("U9"), 9)).astype(object),
        "c_address": np.char.add("addr", np.arange(n_cust).astype("U9")).astype(object),
        "c_nationkey": rng.integers(0, 25, n_cust),
        "c_phone": _mod_strings(lambda i: f"{10+i%25}-{i%1000:03d}-{i%10000:04d}", 50_000, n_cust),
        "c_acctbal": np.round(rng.uniform(-999.99, 9999.99, n_cust), 2),
        "c_mktsegment": np.asarray(_SEGMENTS, object)[rng.integers(0, 5, n_cust)],
        "c_comment": _mod_strings(lambda i: f"customer comment {i % 1009}", 1009, n_cust),
    }
    rng = _rng(2)
    o_custkey = rng.integers(1, n_cust + 1, n_orders)
    o_orderdate = _dates(rng, n_orders)
    orders = {
        "o_orderkey": np.arange(1, n_orders + 1, dtype=np.int64),
        "o_custkey": o_custkey.astype(np.int64),
        "o_orderstatus": np.asarray(["F", "O", "P"], object)[rng.integers(0, 3, n_orders)],
        "o_totalprice": np.round(rng.uniform(800.0, 500000.0, n_orders), 2),
        "o_orderdate": o_orderdate,
        "o_orderpriority": np.asarray(_PRIORITIES, object)[rng.integers(0, 5, n_orders)],
        "o_clerk": _mod_strings(lambda i: f"Clerk#{i%1000:09d}", 1000, n_orders),
        "o_shippriority": np.zeros(n_orders, np.int64),
        "o_comment": _mod_strings(lambda i: f"order comment {i % 977}", 977, n_orders),
    }
    rng = _rng(3)
    l_orderkey = rng.integers(1, n_orders + 1, n_line).astype(np.int64)
    l_orderkey.sort()
    odate_of = o_orderdate[l_orderkey - 1].astype("datetime64[D]").astype(np.int64)
    l_ship = odate_of + rng.integers(1, 122, n_line)
    l_commit = odate_of + rng.integers(30, 91, n_line)
    l_receipt = l_ship + rng.integers(1, 31, n_line)
    lineitem = {
        "l_orderkey": l_orderkey,
        "l_partkey": rng.integers(1, n_part + 1, n_line).astype(np.int64),
        "l_suppkey": rng.integers(1, n_supp + 1, n_line).astype(np.int64),
        "l_linenumber": (np.arange(n_line) % 7 + 1).astype(np.int64),
        "l_quantity": rng.integers(1, 51, n_line).astype(np.float64),
        "l_extendedprice": np.round(rng.uniform(900.0, 100000.0, n_line), 2),
        "l_discount": np.round(rng.integers(0, 11, n_line) / 100.0, 2),
        "l_tax": np.round(rng.integers(0, 9, n_line) / 100.0, 2),
        "l_returnflag": np.asarray(["A", "N", "R"], object)[rng.integers(0, 3, n_line)],
        "l_linestatus": np.asarray(["F", "O"], object)[rng.integers(0, 2, n_line)],
        "l_shipdate": l_ship.astype("datetime64[D]"),
        "l_commitdate": l_commit.astype("datetime64[D]"),
        "l_receiptdate": l_receipt.astype("datetime64[D]"),
        "l_shipinstruct": np.asarray(_INSTRUCTIONS, object)[rng.integers(0, 4, n_line)],
        "l_shipmode": np.asarray(_SHIPMODES, object)[rng.integers(0, 7, n_line)],
        "l_comment": _mod_strings(lambda i: f"line comment {i % 499}", 499, n_line),
    }
    if want is not None and not (want & {"supplier", "part", "partsupp"}):
        # the trailing tables are independent (own rngs) — skip their build
        out = {"region": region, "nation": nation, "customer": customer,
               "orders": orders, "lineitem": lineitem}
        return {k: v for k, v in out.items() if k in want}
    rng = _rng(4)
    supplier = {
        "s_suppkey": np.arange(1, n_supp + 1, dtype=np.int64),
        "s_name": np.asarray([f"Supplier#{i:09d}" for i in range(1, n_supp + 1)], object),
        "s_address": np.asarray([f"saddr{i}" for i in range(n_supp)], object),
        "s_nationkey": rng.integers(0, 25, n_supp).astype(np.int64),
        "s_phone": np.asarray([f"{10+i%25}-{i%1000:03d}" for i in range(n_supp)], object),
        "s_acctbal": np.round(rng.uniform(-999.99, 9999.99, n_supp), 2),
        "s_comment": _mod_strings(lambda i: f"supplier comment {i % 1013}", 1013, n_supp),
    }
    _types = ["ECONOMY ANODIZED STEEL", "LARGE BRUSHED BRASS", "STANDARD POLISHED TIN",
              "SMALL PLATED COPPER", "MEDIUM BURNISHED NICKEL", "PROMO BURNISHED COPPER",
              "PROMO PLATED STEEL", "ECONOMY BRUSHED TIN"]
    _containers = ["SM CASE", "LG BOX", "MED BAG", "JUMBO JAR", "WRAP PACK"]
    rng = _rng(5)
    part = {
        "p_partkey": np.arange(1, n_part + 1, dtype=np.int64),
        "p_name": _mod_strings(lambda i: f"part name {i % 92} color{i % 7}", 92 * 7, n_part),
        "p_mfgr": _mod_strings(lambda i: f"Manufacturer#{i % 5 + 1}", 5, n_part),
        "p_brand": _mod_strings(lambda i: f"Brand#{i % 5 + 1}{i % 5 + 1}", 5, n_part),
        "p_type": np.asarray(_types, object)[rng.integers(0, len(_types), n_part)],
        "p_size": rng.integers(1, 51, n_part).astype(np.int64),
        "p_container": np.asarray(_containers, object)[rng.integers(0, 5, n_part)],
        "p_retailprice": np.round(rng.uniform(900.0, 2000.0, n_part), 2),
        "p_comment": np.asarray([f"part comment {i % 131}" for i in range(n_part)], object),
    }
    # (ps_partkey, ps_suppkey) is a primary key in TPC-H: each part gets 4
    # DISTINCT suppliers (spec's supplier rotation formula)
    rng = _rng(6)
    _ps_base = rng.integers(0, n_supp, n_part)
    _ps_step = max(n_supp // 4, 1)
    _ps_supp = ((_ps_base[:, None] + np.arange(4)[None, :] * _ps_step) % n_supp + 1).reshape(-1)
    partsupp = {
        "ps_partkey": np.repeat(np.arange(1, n_part + 1, dtype=np.int64), 4),
        "ps_suppkey": _ps_supp.astype(np.int64),
        "ps_availqty": rng.integers(1, 10000, n_psupp).astype(np.int64),
        "ps_supplycost": np.round(rng.uniform(1.0, 1000.0, n_psupp), 2),
        "ps_comment": _mod_strings(lambda i: f"ps comment {i % 199}", 199, n_psupp),
    }
    out = {
        "region": region, "nation": nation, "customer": customer,
        "orders": orders, "lineitem": lineitem, "supplier": supplier,
        "part": part, "partsupp": partsupp,
    }
    if want is not None:
        out = {k: v for k, v in out.items() if k in want}
    return out


# ---------------------------------------------------------------------------
# queries — polars_tpu_torch implementations
# ---------------------------------------------------------------------------


def q1(lineitem):
    import polars_tpu_torch as pl

    return (
        lineitem.lazy()
        .filter(pl.col("l_shipdate") <= dtm.date(1998, 9, 2))
        .group_by("l_returnflag", "l_linestatus")
        .agg(
            sum_qty=pl.col("l_quantity").sum(),
            sum_base_price=pl.col("l_extendedprice").sum(),
            sum_disc_price=(pl.col("l_extendedprice") * (1 - pl.col("l_discount"))).sum(),
            sum_charge=(
                pl.col("l_extendedprice") * (1 - pl.col("l_discount")) * (1 + pl.col("l_tax"))
            ).sum(),
            avg_qty=pl.col("l_quantity").mean(),
            avg_price=pl.col("l_extendedprice").mean(),
            avg_disc=pl.col("l_discount").mean(),
            count_order=pl.len(),
        )
        .sort("l_returnflag", "l_linestatus")
    )

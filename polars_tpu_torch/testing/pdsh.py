"""PDS-H (TPC-H-derived) data generator + reference queries (copied from
polars_tpu/testing/pdsh.py: ``generate_pdsh`` unchanged and all 22
queries, ``q1`` to ``q22``, on this package).

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

# the tables each ported query reads, in the order its function takes them,
# and the columns it reads of each (q1's, q3's and q4's are bench.py's lists)
QUERY_COLUMNS = {
    "q1": {"lineitem": ["l_shipdate", "l_returnflag", "l_linestatus", "l_quantity", "l_extendedprice",
                        "l_discount", "l_tax"]},
    "q3": {"customer": ["c_custkey", "c_mktsegment"],
           "orders": ["o_orderkey", "o_custkey", "o_orderdate", "o_shippriority"],
           "lineitem": ["l_orderkey", "l_shipdate", "l_extendedprice", "l_discount"]},
    "q4": {"orders": ["o_orderkey", "o_orderdate", "o_orderpriority"],
           "lineitem": ["l_orderkey", "l_commitdate", "l_receiptdate"]},
    "q5": {"customer": ["c_custkey", "c_nationkey"],
           "orders": ["o_orderkey", "o_custkey", "o_orderdate"],
           "lineitem": ["l_orderkey", "l_suppkey", "l_extendedprice", "l_discount"],
           "supplier": ["s_suppkey", "s_nationkey"],
           "nation": ["n_nationkey", "n_name", "n_regionkey"],
           "region": ["r_regionkey", "r_name"]},
    "q6": {"lineitem": ["l_shipdate", "l_discount", "l_quantity", "l_extendedprice"]},
    "q10": {"customer": ["c_custkey", "c_name", "c_address", "c_nationkey", "c_phone", "c_acctbal", "c_comment"],
            "orders": ["o_orderkey", "o_custkey", "o_orderdate"],
            "lineitem": ["l_orderkey", "l_returnflag", "l_extendedprice", "l_discount"],
            "nation": ["n_nationkey", "n_name"]},
    "q11": {"nation": ["n_nationkey", "n_name"],
            "supplier": ["s_suppkey", "s_nationkey"],
            "partsupp": ["ps_partkey", "ps_suppkey", "ps_availqty", "ps_supplycost"]},
    "q12": {"orders": ["o_orderkey", "o_orderpriority"],
            "lineitem": ["l_orderkey", "l_shipmode", "l_commitdate", "l_receiptdate", "l_shipdate"]},
    "q14": {"lineitem": ["l_partkey", "l_shipdate", "l_extendedprice", "l_discount"],
            "part": ["p_partkey", "p_type"]},
    "q15": {"lineitem": ["l_suppkey", "l_shipdate", "l_extendedprice", "l_discount"],
            "supplier": ["s_suppkey", "s_name", "s_address", "s_phone"]},
    "q17": {"lineitem": ["l_partkey", "l_quantity", "l_extendedprice"],
            "part": ["p_partkey", "p_brand", "p_container"]},
    "q18": {"customer": ["c_custkey", "c_name"],
            "orders": ["o_orderkey", "o_custkey", "o_orderdate", "o_totalprice"],
            "lineitem": ["l_orderkey", "l_quantity"]},
    "q19": {"lineitem": ["l_partkey", "l_quantity", "l_shipmode", "l_shipinstruct", "l_extendedprice",
                        "l_discount"],
            "part": ["p_partkey", "p_container", "p_size"]},
    "q20": {"nation": ["n_nationkey", "n_name"],
            "supplier": ["s_suppkey", "s_name", "s_address", "s_nationkey"],
            "partsupp": ["ps_partkey", "ps_suppkey", "ps_availqty"],
            "part": ["p_partkey", "p_name"],
            "lineitem": ["l_partkey", "l_suppkey", "l_shipdate", "l_quantity"]},
    "q2": {"region": ["r_regionkey", "r_name"],
           "nation": ["n_nationkey", "n_name", "n_regionkey"],
           "supplier": ["s_suppkey", "s_name", "s_address", "s_nationkey", "s_phone", "s_acctbal", "s_comment"],
           "partsupp": ["ps_partkey", "ps_suppkey", "ps_supplycost"],
           "part": ["p_partkey", "p_mfgr", "p_type", "p_size"]},
    "q7": {"customer": ["c_custkey", "c_nationkey"],
           "orders": ["o_orderkey", "o_custkey"],
           "lineitem": ["l_orderkey", "l_suppkey", "l_extendedprice", "l_discount", "l_shipdate"],
           "supplier": ["s_suppkey", "s_nationkey"],
           "nation": ["n_nationkey", "n_name"]},
    "q8": {"region": ["r_regionkey", "r_name"],
           "nation": ["n_nationkey", "n_name", "n_regionkey"],
           "customer": ["c_custkey", "c_nationkey"],
           "orders": ["o_orderkey", "o_custkey", "o_orderdate"],
           "lineitem": ["l_orderkey", "l_partkey", "l_suppkey", "l_extendedprice", "l_discount"],
           "supplier": ["s_suppkey", "s_nationkey"],
           "part": ["p_partkey", "p_type"]},
    "q9": {"nation": ["n_nationkey", "n_name"],
           "orders": ["o_orderkey", "o_orderdate"],
           "lineitem": ["l_orderkey", "l_partkey", "l_suppkey", "l_quantity", "l_extendedprice", "l_discount"],
           "supplier": ["s_suppkey", "s_nationkey"],
           "part": ["p_partkey", "p_name"],
           "partsupp": ["ps_partkey", "ps_suppkey", "ps_supplycost"]},
    "q13": {"customer": ["c_custkey"],
            "orders": ["o_orderkey", "o_custkey", "o_comment"]},
    "q16": {"supplier": ["s_suppkey", "s_comment"],
            "partsupp": ["ps_partkey", "ps_suppkey"],
            "part": ["p_partkey", "p_brand", "p_type", "p_size"]},
    "q21": {"nation": ["n_nationkey", "n_name"],
            "supplier": ["s_suppkey", "s_name", "s_nationkey"],
            "lineitem": ["l_orderkey", "l_suppkey", "l_commitdate", "l_receiptdate"],
            "orders": ["o_orderkey", "o_orderstatus"]},
    "q22": {"customer": ["c_custkey", "c_phone", "c_acctbal"],
            "orders": ["o_custkey"]},
}


def query(name: str, frames: dict, **params):
    """The lazy query ``name`` over ``frames`` (table name -> frame), with
    the query's own ``params`` (Q11's ``fraction``, Q20's ``color``)."""
    return globals()[name](*(frames[t] for t in QUERY_COLUMNS[name]), **params)


def run_params(name: str, scale: float) -> dict:
    """The parameters the SF-scaled runs on the card give query ``name``:
    Q11's FRACTION as the TPC-H specification scales it (0.0001 / scale;
    the default 0.0001 finds no part at SF10), Q20's color "part" (every
    generated part name starts with it, none with the default "forest"),
    Q9's color "color3" (one part in 7; no generated name holds "green")
    and Q13's words "comment" and "7" (the regex matches the 27% of order
    comments whose number holds a 7, which Q13 drops; no comment holds
    "special")."""
    return {
        "q9": {"color": "color3"},
        "q11": {"fraction": 0.0001 / scale},
        "q13": {"word1": "comment", "word2": "7"},
        "q20": {"color": "part"},
    }.get(name, {})


def frames_for(name: str, tables: dict) -> dict:
    """The frames query ``name`` reads: each table's frame cut to the
    query's columns, sharing the table's device columns."""
    from polars_tpu_torch.core.frame import DataFrame

    return {t: DataFrame._from_columns([tables[t]._get(c) for c in cols], tables[t].height)
            for t, cols in QUERY_COLUMNS[name].items()}



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


def q3(customer, orders, lineitem):
    import polars_tpu_torch as pl

    d = dtm.date(1995, 3, 15)
    return (
        customer.lazy()
        .filter(pl.col("c_mktsegment") == "BUILDING")
        .join(orders.lazy(), left_on="c_custkey", right_on="o_custkey", validate="1:m")
        .filter(pl.col("o_orderdate") < d)
        .join(lineitem.lazy(), left_on="o_orderkey", right_on="l_orderkey", validate="1:m")
        .filter(pl.col("l_shipdate") > d)
        .group_by("o_orderkey", "o_orderdate", "o_shippriority")
        .agg(revenue=(pl.col("l_extendedprice") * (1 - pl.col("l_discount"))).sum())
        .select(
            pl.col("o_orderkey").alias("l_orderkey"),
            "revenue",
            "o_orderdate",
            "o_shippriority",
        )
        .sort(["revenue", "o_orderdate"], descending=[True, False])
        .head(10)
    )


def q4(orders, lineitem):
    import polars_tpu_torch as pl

    return (
        orders.lazy()
        .filter(
            (pl.col("o_orderdate") >= dtm.date(1993, 7, 1))
            & (pl.col("o_orderdate") < dtm.date(1993, 10, 1))
        )
        .join(
            lineitem.lazy().filter(pl.col("l_commitdate") < pl.col("l_receiptdate")),
            left_on="o_orderkey",
            right_on="l_orderkey",
            how="semi",
        )
        .group_by("o_orderpriority")
        .agg(order_count=pl.len())
        .sort("o_orderpriority")
    )


def q5(customer, orders, lineitem, supplier, nation, region):
    import polars_tpu_torch as pl

    return (
        region.lazy()
        .filter(pl.col("r_name") == "ASIA")
        .join(nation.lazy(), left_on="r_regionkey", right_on="n_regionkey", validate="1:m")
        .join(customer.lazy(), left_on="n_nationkey", right_on="c_nationkey", validate="1:m")
        .join(orders.lazy(), left_on="c_custkey", right_on="o_custkey", validate="1:m")
        .filter(
            (pl.col("o_orderdate") >= dtm.date(1994, 1, 1))
            & (pl.col("o_orderdate") < dtm.date(1995, 1, 1))
        )
        .join(lineitem.lazy(), left_on="o_orderkey", right_on="l_orderkey", validate="1:m")
        .join(
            supplier.lazy(),
            left_on=["l_suppkey", "n_nationkey"],
            right_on=["s_suppkey", "s_nationkey"],
            validate="m:1",
        )
        .group_by("n_name")
        .agg(revenue=(pl.col("l_extendedprice") * (1 - pl.col("l_discount"))).sum())
        .sort("revenue", descending=True)
    )


def q6(lineitem):
    import polars_tpu_torch as pl

    return (
        lineitem.lazy()
        .filter(
            (pl.col("l_shipdate") >= dtm.date(1994, 1, 1))
            & (pl.col("l_shipdate") < dtm.date(1995, 1, 1))
            & (pl.col("l_discount").is_between(0.05, 0.07))
            & (pl.col("l_quantity") < 24)
        )
        .select(revenue=(pl.col("l_extendedprice") * pl.col("l_discount")).sum())
    )


def q10(customer, orders, lineitem, nation):
    import polars_tpu_torch as pl

    return (
        customer.lazy()
        .join(orders.lazy(), left_on="c_custkey", right_on="o_custkey", validate="1:m")
        .filter(
            (pl.col("o_orderdate") >= dtm.date(1993, 10, 1))
            & (pl.col("o_orderdate") < dtm.date(1994, 1, 1))
        )
        .join(lineitem.lazy(), left_on="o_orderkey", right_on="l_orderkey", validate="1:m")
        .filter(pl.col("l_returnflag") == "R")
        .join(nation.lazy(), left_on="c_nationkey", right_on="n_nationkey", validate="m:1")
        .group_by(
            "c_custkey", "c_name", "c_acctbal", "c_phone", "n_name", "c_address", "c_comment"
        )
        .agg(revenue=(pl.col("l_extendedprice") * (1 - pl.col("l_discount"))).sum())
        .select(
            "c_custkey", "c_name", "revenue", "c_acctbal", "n_name", "c_address",
            "c_phone", "c_comment",
        )
        .sort(["revenue", "c_custkey"], descending=[True, False])
        .head(20)
    )


def q12(orders, lineitem):
    import polars_tpu_torch as pl

    return (
        lineitem.lazy()
        .filter(
            pl.col("l_shipmode").is_in(["MAIL", "SHIP"])
            & (pl.col("l_commitdate") < pl.col("l_receiptdate"))
            & (pl.col("l_shipdate") < pl.col("l_commitdate"))
            & (pl.col("l_receiptdate") >= dtm.date(1994, 1, 1))
            & (pl.col("l_receiptdate") < dtm.date(1995, 1, 1))
        )
        .join(orders.lazy(), left_on="l_orderkey", right_on="o_orderkey", validate="m:1")
        .group_by("l_shipmode")
        .agg(
            high_line_count=(
                pl.col("o_orderpriority").is_in(["1-URGENT", "2-HIGH"]).cast(pl.Int64)
            ).sum(),
            low_line_count=(
                (~pl.col("o_orderpriority").is_in(["1-URGENT", "2-HIGH"])).cast(pl.Int64)
            ).sum(),
        )
        .sort("l_shipmode")
    )


def q14(lineitem, part):
    import polars_tpu_torch as pl

    return (
        lineitem.lazy()
        .filter(
            (pl.col("l_shipdate") >= dtm.date(1995, 9, 1))
            & (pl.col("l_shipdate") < dtm.date(1995, 10, 1))
        )
        .join(part.lazy(), left_on="l_partkey", right_on="p_partkey", validate="m:1")
        .select(
            promo_revenue=(
                100.0
                * pl.when(pl.col("p_type").str.starts_with("PROMO"))
                .then(pl.col("l_extendedprice") * (1 - pl.col("l_discount")))
                .otherwise(0.0)
                .sum()
                / (pl.col("l_extendedprice") * (1 - pl.col("l_discount"))).sum()
            )
        )
    )


def q19(lineitem, part):
    import polars_tpu_torch as pl

    j = lineitem.lazy().join(part.lazy(), left_on="l_partkey", right_on="p_partkey", validate="m:1")
    cond = (
        (
            (pl.col("p_container").is_in(["SM CASE"]))
            & pl.col("l_quantity").is_between(1, 11)
            & (pl.col("p_size") <= 5)
        )
        | (
            (pl.col("p_container").is_in(["MED BAG"]))
            & pl.col("l_quantity").is_between(10, 20)
            & (pl.col("p_size") <= 10)
        )
        | (
            (pl.col("p_container").is_in(["LG BOX"]))
            & pl.col("l_quantity").is_between(20, 30)
            & (pl.col("p_size") <= 15)
        )
    )
    return (
        j.filter(
            cond
            & pl.col("l_shipmode").is_in(["AIR", "REG AIR"])
            & (pl.col("l_shipinstruct") == "DELIVER IN PERSON")
        )
        .select(revenue=(pl.col("l_extendedprice") * (1 - pl.col("l_discount"))).sum())
    )


def q18(customer, orders, lineitem, threshold=300):
    import polars_tpu_torch as pl

    big_orders = (
        lineitem.lazy()
        .group_by("l_orderkey")
        .agg(sum_qty=pl.col("l_quantity").sum())
        .filter(pl.col("sum_qty") > threshold)
    )
    return (
        orders.lazy()
        .join(big_orders, left_on="o_orderkey", right_on="l_orderkey", how="semi", validate="m:1")
        .join(customer.lazy(), left_on="o_custkey", right_on="c_custkey", validate="m:1")
        .join(
            lineitem.lazy().group_by("l_orderkey").agg(col_qty=pl.col("l_quantity").sum()),
            left_on="o_orderkey",
            right_on="l_orderkey",
            validate="m:1",
        )
        .select("c_name", pl.col("o_custkey").alias("c_custkey"), "o_orderkey", "o_orderdate", "o_totalprice", "col_qty")
        .sort(["o_totalprice", "o_orderdate"], descending=[True, False])
        .head(100)
    )


def q11(nation, supplier, partsupp, nation_name="GERMANY", fraction=0.0001):
    import polars_tpu_torch as pl

    base = (
        partsupp.lazy()
        .join(supplier.lazy(), left_on="ps_suppkey", right_on="s_suppkey", validate="m:1")
        .join(nation.lazy().filter(pl.col("n_name") == nation_name),
              left_on="s_nationkey", right_on="n_nationkey", validate="m:1")
        .with_columns((pl.col("ps_supplycost") * pl.col("ps_availqty")).alias("value"))
    )
    return (
        base.group_by("ps_partkey")
        .agg(value=pl.col("value").sum())
        .join(base.select(pl.col("value").sum().alias("__total") * fraction), how="cross")
        .filter(pl.col("value") > pl.col("__total"))
        .select("ps_partkey", "value")
        .sort(["value", "ps_partkey"], descending=[True, False])
    )


def q15(lineitem, supplier, start=dtm.date(1996, 1, 1)):
    import polars_tpu_torch as pl

    end = dtm.date(1996, 4, 1)
    revenue = (
        lineitem.lazy()
        .filter((pl.col("l_shipdate") >= start) & (pl.col("l_shipdate") < end))
        .group_by(pl.col("l_suppkey").alias("supplier_no"))
        .agg(total_revenue=(pl.col("l_extendedprice") * (1 - pl.col("l_discount"))).sum())
    )
    return (
        revenue.join(
            revenue.select(pl.col("total_revenue").max().alias("__max")), how="cross"
        )
        .filter(pl.col("total_revenue") == pl.col("__max"))
        .join(supplier.lazy(), left_on="supplier_no", right_on="s_suppkey")
        .select("supplier_no", "s_name", "s_address", "s_phone", "total_revenue")
        .sort("supplier_no")
    )


def q17(lineitem, part, brand="Brand#11", container="SM CASE"):
    import polars_tpu_torch as pl

    eligible = (
        part.lazy()
        .filter((pl.col("p_brand") == brand) & (pl.col("p_container") == container))
        .join(lineitem.lazy(), left_on="p_partkey", right_on="l_partkey", validate="1:m")
    )
    avg_qty = eligible.group_by("p_partkey").agg(
        (0.2 * pl.col("l_quantity").mean()).alias("__limit")
    )
    return (
        eligible.join(avg_qty, on="p_partkey", validate="m:1")
        .filter(pl.col("l_quantity") < pl.col("__limit"))
        .select((pl.col("l_extendedprice").sum() / 7.0).alias("avg_yearly"))
    )


def q20(nation, supplier, partsupp, part, lineitem, color="forest",
        start=dtm.date(1994, 1, 1), nation_name="CANADA"):
    import polars_tpu_torch as pl

    end = dtm.date(1995, 1, 1)
    shipped = (
        lineitem.lazy()
        .filter((pl.col("l_shipdate") >= start) & (pl.col("l_shipdate") < end))
        .group_by("l_partkey", "l_suppkey")
        .agg((0.5 * pl.col("l_quantity").sum()).alias("__half"))
    )
    qualifying_ps = (
        partsupp.lazy()
        .join(part.lazy().filter(pl.col("p_name").str.starts_with(color)),
              left_on="ps_partkey", right_on="p_partkey", how="semi", validate="m:1")
        .join(shipped, left_on=["ps_partkey", "ps_suppkey"], right_on=["l_partkey", "l_suppkey"], validate="m:1")
        .filter(pl.col("ps_availqty") > pl.col("__half"))
    )
    return (
        supplier.lazy()
        .join(qualifying_ps, left_on="s_suppkey", right_on="ps_suppkey", how="semi")
        .join(nation.lazy().filter(pl.col("n_name") == nation_name),
              left_on="s_nationkey", right_on="n_nationkey", validate="m:1")
        .select("s_name", "s_address")
        .sort("s_name")
    )


def q2(region, nation, supplier, partsupp, part, size=15, type_suffix="BRASS", region_name="EUROPE"):
    import polars_tpu_torch as pl

    eligible = (
        part.lazy()
        .filter((pl.col("p_size") == size) & pl.col("p_type").str.ends_with(type_suffix))
        .join(partsupp.lazy(), left_on="p_partkey", right_on="ps_partkey", validate="1:m")
        .join(supplier.lazy(), left_on="ps_suppkey", right_on="s_suppkey", validate="m:1")
        .join(nation.lazy(), left_on="s_nationkey", right_on="n_nationkey", validate="m:1")
        .join(region.lazy().filter(pl.col("r_name") == region_name),
              left_on="n_regionkey", right_on="r_regionkey", validate="m:1")
    )
    min_cost = eligible.group_by("p_partkey").agg(pl.col("ps_supplycost").min().alias("__min_cost"))
    return (
        eligible.join(min_cost, on="p_partkey", validate="m:1")
        .filter(pl.col("ps_supplycost") == pl.col("__min_cost"))
        .select(
            "s_acctbal", "s_name", "n_name", "p_partkey", "p_mfgr",
            "s_address", "s_phone", "s_comment",
        )
        .sort(["s_acctbal", "n_name", "s_name", "p_partkey"], descending=[True, False, False, False])
        .head(100)
    )


def q7(customer, orders, lineitem, supplier, nation, n1="FRANCE", n2="GERMANY"):
    import polars_tpu_torch as pl

    na = nation.lazy().filter(pl.col("n_name").is_in([n1, n2]))
    return (
        lineitem.lazy()
        .filter(
            (pl.col("l_shipdate") >= dtm.date(1995, 1, 1))
            & (pl.col("l_shipdate") <= dtm.date(1996, 12, 31))
        )
        .join(orders.lazy(), left_on="l_orderkey", right_on="o_orderkey", validate="m:1")
        .join(customer.lazy(), left_on="o_custkey", right_on="c_custkey", validate="m:1")
        .join(na.select(pl.col("n_nationkey"), pl.col("n_name").alias("cust_nation")),
              left_on="c_nationkey", right_on="n_nationkey")
        .join(supplier.lazy(), left_on="l_suppkey", right_on="s_suppkey", validate="m:1")
        .join(na.select(pl.col("n_nationkey"), pl.col("n_name").alias("supp_nation")),
              left_on="s_nationkey", right_on="n_nationkey")
        .filter(
            ((pl.col("supp_nation") == n1) & (pl.col("cust_nation") == n2))
            | ((pl.col("supp_nation") == n2) & (pl.col("cust_nation") == n1))
        )
        .with_columns(
            pl.col("l_shipdate").dt.year().alias("l_year"),
            (pl.col("l_extendedprice") * (1 - pl.col("l_discount"))).alias("volume"),
        )
        .group_by("supp_nation", "cust_nation", "l_year")
        .agg(revenue=pl.col("volume").sum())
        .sort(["supp_nation", "cust_nation", "l_year"])
    )


def q8(region, nation, customer, orders, lineitem, supplier, part,
       nation_name="BRAZIL", region_name="AMERICA", ptype="ECONOMY ANODIZED STEEL"):
    import polars_tpu_torch as pl

    return (
        part.lazy()
        .filter(pl.col("p_type") == ptype)
        .join(lineitem.lazy(), left_on="p_partkey", right_on="l_partkey", validate="1:m")
        .join(supplier.lazy(), left_on="l_suppkey", right_on="s_suppkey", validate="m:1")
        .join(orders.lazy(), left_on="l_orderkey", right_on="o_orderkey", validate="m:1")
        .filter(
            (pl.col("o_orderdate") >= dtm.date(1995, 1, 1))
            & (pl.col("o_orderdate") <= dtm.date(1996, 12, 31))
        )
        .join(customer.lazy(), left_on="o_custkey", right_on="c_custkey", validate="m:1")
        .join(nation.lazy().select(pl.col("n_nationkey"), pl.col("n_regionkey")),
              left_on="c_nationkey", right_on="n_nationkey", validate="m:1")
        .join(region.lazy().filter(pl.col("r_name") == region_name),
              left_on="n_regionkey", right_on="r_regionkey", validate="m:1")
        .join(nation.lazy().select(pl.col("n_nationkey"), pl.col("n_name").alias("supp_nation")),
              left_on="s_nationkey", right_on="n_nationkey", validate="m:1")
        .with_columns(
            pl.col("o_orderdate").dt.year().alias("o_year"),
            (pl.col("l_extendedprice") * (1 - pl.col("l_discount"))).alias("volume"),
        )
        .group_by("o_year")
        .agg(
            (
                pl.when(pl.col("supp_nation") == nation_name)
                .then(pl.col("volume"))
                .otherwise(0.0)
                .sum()
                / pl.col("volume").sum()
            ).alias("mkt_share")
        )
        .sort("o_year")
    )


def q9(nation, orders, lineitem, supplier, part, partsupp, color="green"):
    import polars_tpu_torch as pl

    return (
        part.lazy()
        .filter(pl.col("p_name").str.contains(color))
        .join(lineitem.lazy(), left_on="p_partkey", right_on="l_partkey", validate="1:m")
        .join(supplier.lazy(), left_on="l_suppkey", right_on="s_suppkey", validate="m:1")
        .join(
            partsupp.lazy(),
            left_on=["p_partkey", "l_suppkey"],
            right_on=["ps_partkey", "ps_suppkey"],
            validate="m:1",
        )
        .join(orders.lazy(), left_on="l_orderkey", right_on="o_orderkey", validate="m:1")
        .join(nation.lazy(), left_on="s_nationkey", right_on="n_nationkey", validate="m:1")
        .with_columns(
            pl.col("o_orderdate").dt.year().alias("o_year"),
            (
                pl.col("l_extendedprice") * (1 - pl.col("l_discount"))
                - pl.col("ps_supplycost") * pl.col("l_quantity")
            ).alias("amount"),
        )
        .group_by(pl.col("n_name").alias("nation"), "o_year")
        .agg(sum_profit=pl.col("amount").sum())
        .sort(["nation", "o_year"], descending=[False, True])
    )


def q13(customer, orders, word1="special", word2="requests"):
    import polars_tpu_torch as pl

    o = orders.lazy().filter(
        ~pl.col("o_comment").str.contains(f"{word1}.*{word2}")
    )
    return (
        customer.lazy()
        .join(o, left_on="c_custkey", right_on="o_custkey", how="left")
        .group_by("c_custkey")
        .agg(c_count=pl.col("o_orderkey").count())
        .group_by("c_count")
        .agg(custdist=pl.len())
        .sort(["custdist", "c_count"], descending=[True, True])
    )


def q16(supplier, partsupp, part, brand="Brand#44", ptype="STANDARD", sizes=(49, 14, 23, 45, 19, 3, 36, 9)):
    import polars_tpu_torch as pl

    bad_supp = supplier.lazy().filter(
        pl.col("s_comment").str.contains("Customer.*Complaints")
    )
    return (
        part.lazy()
        .filter(
            (pl.col("p_brand") != brand)
            & ~pl.col("p_type").str.starts_with(ptype)
            & pl.col("p_size").is_in(list(sizes))
        )
        .join(partsupp.lazy(), left_on="p_partkey", right_on="ps_partkey", validate="1:m")
        .join(bad_supp, left_on="ps_suppkey", right_on="s_suppkey", how="anti", validate="m:1")
        .group_by("p_brand", "p_type", "p_size")
        .agg(supplier_cnt=pl.col("ps_suppkey").n_unique())
        .sort(["supplier_cnt", "p_brand", "p_type", "p_size"], descending=[True, False, False, False])
    )


def q21(nation, supplier, lineitem, orders, nation_name="SAUDI ARABIA"):
    import polars_tpu_torch as pl

    late = pl.col("l_receiptdate") > pl.col("l_commitdate")
    li = lineitem.lazy().select("l_orderkey", "l_suppkey", late.alias("__late"))
    n_supp = li.group_by("l_orderkey").agg(
        pl.col("l_suppkey").n_unique().alias("__n_supp"),
    )
    late_supp = (
        li.filter(pl.col("__late"))
        .group_by("l_orderkey")
        .agg(
            pl.col("l_suppkey").n_unique().alias("__n_late"),
            pl.col("l_suppkey").first().alias("__late_supp"),
        )
    )
    return (
        lineitem.lazy()
        .filter(late)
        .join(orders.lazy().filter(pl.col("o_orderstatus") == "F"),
              left_on="l_orderkey", right_on="o_orderkey", validate="m:1")
        .join(n_supp, on="l_orderkey", validate="m:1")
        .join(late_supp, on="l_orderkey", validate="m:1")
        .filter((pl.col("__n_supp") > 1) & (pl.col("__n_late") == 1))
        .join(supplier.lazy(), left_on="l_suppkey", right_on="s_suppkey", validate="m:1")
        .join(nation.lazy().filter(pl.col("n_name") == nation_name),
              left_on="s_nationkey", right_on="n_nationkey", validate="m:1")
        .group_by("s_name")
        .agg(numwait=pl.len())
        .sort(["numwait", "s_name"], descending=[True, False])
        .head(100)
    )


def q22(customer, orders, codes=("13", "31", "23", "29", "30", "18", "17")):
    import polars_tpu_torch as pl

    cust = customer.lazy().with_columns(pl.col("c_phone").str.slice(0, 2).alias("cntrycode"))
    eligible = cust.filter(pl.col("cntrycode").is_in(list(codes)))
    avg_bal = eligible.filter(pl.col("c_acctbal") > 0.0).select(
        pl.col("c_acctbal").mean().alias("__avg")
    )
    return (
        eligible.join(avg_bal, how="cross")
        .filter(pl.col("c_acctbal") > pl.col("__avg"))
        .join(orders.lazy(), left_on="c_custkey", right_on="o_custkey", how="anti")
        .group_by("cntrycode")
        .agg(numcust=pl.len(), totacctbal=pl.col("c_acctbal").sum())
        .sort("cntrycode")
    )

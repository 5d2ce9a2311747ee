"""PDS-H Q2, Q5-Q22 through both packages (Q1, Q3 and Q4 have their own
files).

One dataset, made from a numpy seed by ``generate_pdsh``, goes through
``polars_tpu`` (JAX on the CPU) and ``polars_tpu_torch`` (``device="cpu"``).
Keys, dates, strings and counts must be equal; floats agree to rtol 1e-9
(the two engines sum in different orders). Each query reads only its own
columns (``pdsh.QUERY_COLUMNS``). Q11 and Q15 cross-join a one-row
aggregate, and Q15 joins its one row to the suppliers without ``validate``:
host-sized joins between segments. Q20 runs with ``color="part"``: the
generator's part names never start with the default "forest". Q9 and Q13
take their ``run_params``: no generated part name holds "green", no order
comment "special...requests"; with "color3" and "comment.*7" the string
filters keep part of the rows and drop the rest. At this size the 30
suppliers hold none of SAUDI ARABIA (Q21's nation) or BRAZIL (Q8's), and
no part of size 15 and type BRASS has a supplier in EUROPE (Q2's), so Q21
and Q8 run for JORDAN and Q2 for ASIA. Every customer has an order here (ten each on average), so
Q22's anti join would keep none: it reads the first tenth of the orders.
Q16's pattern "Customer.*Complaints" matches no generated supplier comment
("supplier comment N") and cannot be passed in, so its anti join removes no
supplier; its regex still runs over every comment.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import polars_tpu as plj
import polars_tpu_torch as plt
from polars_tpu.testing import pdsh as pdsh_jax
from polars_tpu_torch.testing import pdsh as pdsh_torch

QUERIES = ["q5", "q6", "q10", "q11", "q12", "q14", "q15", "q17", "q18", "q19", "q20",
           "q2", "q7", "q8", "q9", "q13", "q16", "q21", "q22"]
PARAMS = {"q20": {"color": "part"}, "q9": {"color": "color3"}, "q13": {"word1": "comment", "word2": "7"},
          "q2": {"region_name": "ASIA"}, "q8": {"nation_name": "JORDAN"}, "q21": {"nation_name": "JORDAN"}}


def _assert_frames_match(got, want, *, rtol=1e-9):
    assert [(n, repr(d)) for n, d in got.schema.items()] == [(n, repr(d)) for n, d in want.schema.items()]
    g, w = got.to_dict(as_series=False), want.to_dict(as_series=False)
    for name, wcol in w.items():
        if isinstance(want.schema[name], plj.datatypes.FloatType):
            assert [v is None for v in g[name]] == [v is None for v in wcol], name
            gv = np.asarray([np.nan if v is None else v for v in g[name]], np.float64)
            wv = np.asarray([np.nan if v is None else v for v in wcol], np.float64)
            np.testing.assert_allclose(gv, wv, rtol=rtol, equal_nan=True, err_msg=name)
        else:
            assert g[name] == wcol, name


@pytest.fixture(scope="module")
def frames():
    """Every table at SF 0.003 (seed 7, the data of tests/test_pdsh.py), in
    both packages; the port's frames on the CPU."""
    raw = pdsh_jax.generate_pdsh(0.003, seed=7)
    # Q22's orders: the first tenth, so that some customers have none
    tenth = {c: v[: len(v) // 10] for c, v in raw["orders"].items()}
    want = {t: plj.DataFrame(cols) for t, cols in raw.items()}
    got = {t: plt.DataFrame(cols, device="cpu") for t, cols in raw.items()}
    want["orders_tenth"], got["orders_tenth"] = plj.DataFrame(tenth), plt.DataFrame(tenth, device="cpu")
    return want, got


def _frames_of(q: str, frames: dict) -> dict:
    """The tables query ``q`` reads: Q22's orders are their first tenth."""
    return {t: frames["orders_tenth" if (q, t) == ("q22", "orders") else t] for t in pdsh_torch.QUERY_COLUMNS[q]}


@pytest.mark.parametrize("q", QUERIES)
def test_query_matches_polars_tpu(frames, q):
    fj, ft = (_frames_of(q, f) for f in frames)
    want = getattr(pdsh_jax, q)(*fj.values(), **PARAMS.get(q, {})).collect()
    got = pdsh_torch.query(q, ft, **PARAMS.get(q, {})).collect()
    _assert_frames_match(got, want)
    # the result is not trivial at this size: groups present, sums non-zero
    assert want.height >= {"q5": 2, "q10": 20, "q11": 100, "q12": 2, "q18": 5, "q20": 2, "q2": 3, "q7": 4, "q8": 2,
                           "q9": 100, "q13": 10, "q16": 50, "q21": 3, "q22": 5}.get(q, 1)
    for name, d in want.schema.items():
        if isinstance(d, plj.datatypes.FloatType) or name.endswith(("_count", "_cnt", "dist", "numwait", "numcust")):
            assert all(v for v in want[name].to_list()), name


@pytest.mark.parametrize("q", QUERIES)
def test_query_on_its_own_columns(frames, q):
    """The query over frames of only the columns ``QUERY_COLUMNS`` lists
    (``frames_for``, as the card's runs cut them) gives the same frame as over
    whole tables."""
    ft = _frames_of(q, frames[1])
    cut = pdsh_torch.frames_for(q, ft)
    assert {t: f.columns for t, f in cut.items()} == pdsh_torch.QUERY_COLUMNS[q]
    params = PARAMS.get(q, {})
    _assert_frames_match(pdsh_torch.query(q, cut, **params).collect(), pdsh_torch.query(q, ft, **params).collect(),
                         rtol=0)


# what each query hands K1 (capacity, column dtypes; None = a count) and K2
# (rows, columns), in call order, at this size: dense group-bys count their
# key slots and then sum, sorted group-bys (capacity = the rows) and
# one-row selects (capacity 1) only sum; a float max counts its rows and its
# NaNs. A host-sized join's input and output segments end in K2 like any
# other: Q11's inputs (the group-by, the one-row total) and the filter over
# the cross join's 146 rows (the parts with a supplier in GERMANY at this
# size); Q15's two inputs of the cross join, the filter over it (the 30
# suppliers) and the select after its join with the suppliers (a join on
# exact keys launches no kernel).
def _expected_calls(q: str, ft: dict) -> list:
    n_line, n_ps, n_ord = ft["lineitem"].height, ft["partsupp"].height, ft["orders"].height
    f64, i64 = torch.float64, torch.int64
    return {
        # Q2: the sorted group-by of the min costs counts its rows, its
        # min is a scatter; the segment's eight output columns
        "q2": [("K1", n_ps, [None]), ("K2", n_ps, 8)],
        # Q7: its two joins with the two nations lack validate, so they run
        # between segments: the filtered lineitem (31 columns of three
        # whole tables), each nation select, the 352 rows between the two
        # joins (38 columns); then the three-key sorted group-by
        "q7": [("K2", n_line, 31), ("K2", 25, 2), ("K2", 352, 38), ("K2", 25, 2), ("K1", 41, [f64]), ("K2", 41, 4)],
        # Q8: both sums of the ratio in one call (the sorted group-by by year)
        "q8": [("K1", n_line, [f64, f64]), ("K2", n_line, 2)],
        "q9": [("K1", n_line, [f64]), ("K2", n_line, 3)],
        # Q13: the filtered orders end a segment before the left join; the
        # count of a nullable column sums its validity, the second
        # group-by counts its rows
        "q13": [("K2", n_ord, 9), ("K1", 3323, [i64]), ("K1", 3323, [None]), ("K2", 3323, 2)],
        # Q16 and Q21: n_unique counts the boundaries of its sort
        "q16": [("K1", n_ps, [None]), ("K2", n_ps, 4)],
        "q21": [("K1", n_line, [None]), ("K1", n_line, [None]), ("K1", 31, [None]), ("K2", 31, 2)],
        # Q22: the eligible customers, the one-row mean (sum and count), the
        # cross join's input, then the dense group-by (len, sum)
        "q22": [("K2", ft["customer"].height, 9), ("K1", 1, [f64]), ("K1", 1, [None]), ("K2", 1, 2),
                ("K1", 26, [None]), ("K1", 26, [f64]), ("K2", 26, 3)],
        "q11": [("K1", n_ps, [f64]), ("K2", n_ps, 2), ("K1", 1, [f64]), ("K2", 1, 1), ("K2", 146, 2)],
        "q15": [("K1", n_line, [f64]), ("K2", n_line, 2), ("K1", n_line, [f64]), ("K1", 1, [None]), ("K1", 1, [None]),
                ("K2", 1, 2), ("K2", ft["supplier"].height, 4), ("K2", 1, 5)],
        "q17": [("K1", n_line, [f64]), ("K1", n_line, [None]), ("K1", 1, [f64]), ("K2", 1, 1)],
        "q20": [("K1", n_line, [f64]), ("K2", ft["supplier"].height, 2)],
        "q5": [("K1", 26, [None]), ("K1", 26, [f64]), ("K2", 26, 2)],
        "q6": [("K1", 1, [f64]), ("K2", 1, 1)],
        "q10": [("K1", n_line, [f64]), ("K2", n_line, 8)],
        "q12": [("K1", 8, [None]), ("K1", 8, [i64, i64]), ("K2", 8, 3)],
        "q14": [("K1", 1, [f64, f64]), ("K2", 1, 1)],
        "q18": [("K1", n_line, [f64]), ("K1", n_line, [f64]), ("K2", ft["orders"].height, 6)],
        "q19": [("K1", 1, [f64]), ("K2", 1, 1)],
    }[q]


# what the optimized plan hands K1 and K2 where it differs from the plan as
# written: projection pushdown leaves fewer columns to compact (Q7's
# filtered lineitem 31 -> 7, the 352 rows between its joins 38 -> 9; Q13's
# orders 9 -> 3; Q22's customers 9 -> 4); common-subplan elimination runs
# Q15's `revenue` group-by once (its second K1 call goes) and caches a
# small filter used twice (Q2's region, Q7's two nations, Q11's nation,
# Q17's parts), which then ends a segment of its own (one K2 call) and is
# read by both users; Q7's two nation selects over that cache are each a
# segment over its 2 rows; collapse_joins turns Q15's filtered cross join
# into an inner join on the maximum, whose one-row inputs end in K2 and
# whose output joins the suppliers (no K2 over the 30 suppliers).
def _expected_calls_optimized(q: str, ft: dict) -> list:
    n_line, f64, i64 = ft["lineitem"].height, torch.float64, torch.int64
    calls = {
        "q2": [("K2", 5, 2), *_expected_calls(q, ft)],
        "q7": [("K2", n_line, 7), ("K2", 25, 2), ("K2", 2, 2), ("K2", 352, 9), ("K2", 2, 2), ("K1", 41, [f64]),
               ("K2", 41, 4)],
        "q11": [("K2", 25, 2), *_expected_calls(q, ft)],
        "q13": [("K2", ft["orders"].height, 3), ("K1", 3323, [i64]), ("K1", 3323, [None]), ("K2", 3323, 2)],
        "q15": [("K1", n_line, [f64]), ("K2", n_line, 2), ("K1", 1, [None]), ("K1", 1, [None]), ("K2", 1, 2),
                ("K2", 1, 3), ("K2", 1, 5)],
        "q17": [("K2", ft["part"].height, 3), *_expected_calls(q, ft)],
        "q22": [("K2", ft["customer"].height, 4), *_expected_calls(q, ft)[1:]],
    }
    return calls[q] if q in calls else _expected_calls(q, ft)


@pytest.mark.parametrize("q", QUERIES)
def test_query_kernel_calls(frames, monkeypatch, q):
    """Each query's sums and counts go through K1 (a one-row select's too,
    as one group of capacity 1) and each segment's result through one K2
    compaction: the plan as written (``no_optimization=True``) and the
    optimized plan, each with its own calls."""
    from polars_tpu_torch.engine import executors as X
    from polars_tpu_torch.engine import groupby as G
    from polars_tpu_torch.engine import join as J
    from polars_tpu_torch.kernels.compact import compact_scatter
    from polars_tpu_torch.kernels.groupagg import groupagg_sums

    calls = []

    def k1(gids, cols, mask, cap):
        calls.append(("K1", cap, [None if c is None else c.dtype for c in cols]))
        return groupagg_sums(gids, cols, mask, cap)

    def k2(cols, mask, offs, count):
        calls.append(("K2", mask.shape[0], len(cols)))
        return compact_scatter(cols, mask, offs, count)

    monkeypatch.setattr(X, "groupagg_sums", k1)
    monkeypatch.setattr(G, "groupagg_sums", k1)
    monkeypatch.setattr(X, "compact_scatter", k2)
    monkeypatch.setattr(J, "compact_scatter", k2)
    query = pdsh_torch.query(q, _frames_of(q, frames[1]), **PARAMS.get(q, {}))
    query.collect(no_optimization=True)
    assert calls == _expected_calls(q, frames[1])
    calls.clear()
    query.collect()
    assert calls == _expected_calls_optimized(q, frames[1])

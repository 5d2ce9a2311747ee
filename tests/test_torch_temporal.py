"""The calendar fields of a Date column (``Expr.dt``), through both packages
and against Python's ``datetime``.

Dates run from 1600 to 2400, with the century leap-year rules (1700, 1800,
1900 and 2100 are common years; 1600, 2000 and 2400 leap years), the
turns of years where the ISO week and year differ from the calendar's, the
ends of February, and nulls. One select computes every field in each
package (one JAX program); each field is then one case, held to
``polars_tpu`` exactly and to ``datetime``.
"""

from __future__ import annotations

import datetime as dtm

import numpy as np
import pytest

import polars_tpu as plj
import polars_tpu_torch as plt
from polars_tpu_torch.kernels import temporal as T

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

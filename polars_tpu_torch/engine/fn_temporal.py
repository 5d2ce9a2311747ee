"""Field extractors of Date columns (the port of
``polars_tpu/engine/fn_temporal.py``, trimmed to the calendar fields of a
Date: ``dt.year``, ``month``, ``day``, ``quarter``, ``weekday``, ``week``,
``iso_year``, ``ordinal_day``, ``leap_year`` and ``days_in_month``, with the
reference's output dtypes). The civil-calendar math is
``kernels/temporal.py``; a null row keeps its validity.
"""

from __future__ import annotations

import torch

from polars_tpu_torch import datatypes as dt
from polars_tpu_torch.engine.common import Val
from polars_tpu_torch.engine.registry import register
from polars_tpu_torch.errors import InvalidOperationError
from polars_tpu_torch.kernels import temporal as T
from polars_tpu_torch.kernels.fastmath import floordiv_any


def _days_of(v: Val) -> torch.Tensor:
    """Epoch days of a Date column (Datetime columns are not ported yet)."""
    if isinstance(v.dtype, dt.Date):
        return v.values.to(torch.int64)
    if v.dtype.is_temporal():
        raise NotImplementedError(
            f"dt fields of {v.dtype!r} are not ported yet (port queue: temporal breadth and asof/range joins)"
        )
    raise InvalidOperationError(f"expected Date/Datetime, got {v.dtype!r}")


def _simple(name: str, out_dt: dt.DataType, fn) -> None:
    @register(f"dt.{name}", out_dt)
    def _(ctx, args, opts):
        v = args[0]
        return Val(fn(_days_of(v)), v.validity, out_dt, None, v.domain)


def _year(days):
    return T.civil_from_days(days)[0]


def _month(days):
    return T.civil_from_days(days)[1]


_simple("year", dt.Int32(), _year)
_simple("month", dt.Int8(), _month)
_simple("day", dt.Int8(), lambda d: T.civil_from_days(d)[2])
_simple("quarter", dt.Int8(), lambda d: (floordiv_any(_month(d).to(torch.int32) - 1, 3) + 1).to(torch.int8))
_simple("weekday", dt.Int8(), T.weekday_from_days)
_simple("week", dt.Int8(), T.iso_week)
_simple("iso_year", dt.Int32(), T.iso_year)
_simple("ordinal_day", dt.Int16(), T.ordinal_day)
_simple("leap_year", dt.Boolean(), lambda d: T.is_leap_year(_year(d)))
_simple("days_in_month", dt.Int8(), lambda d: T.days_in_month(*T.civil_from_days(d)[:2]))

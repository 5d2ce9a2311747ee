"""Top-level functions outside ``functions/lazy.py`` (the port of
``polars_tpu/functions/parity.py``, trimmed to ``business_day_count``,
``arctan2`` and ``arctan2d``)."""

from __future__ import annotations

import datetime as _dt
from typing import Any

from polars_tpu_torch.expr.expr import Expr, parse_into_expr
from polars_tpu_torch.plan import exprs as E

_EPOCH = _dt.date(1970, 1, 1)


def business_day_count(start: Any, end: Any, week_mask: Any = None, holidays: Any = None) -> Expr:
    """Business days in [start, end) (``week_mask`` Monday first; holidays
    as dates or epoch days)."""
    mask = tuple(bool(x) for x in (week_mask if week_mask is not None else (1, 1, 1, 1, 1, 0, 0)))
    hol = tuple(sorted(_to_days(h) for h in (holidays or ())))
    return Expr(E.EFunction("business_day_count", (parse_into_expr(start), parse_into_expr(end)),
                            (("holidays", hol), ("week_mask", mask))))


def _to_days(d: Any) -> int:
    if isinstance(d, _dt.datetime):
        d = d.date()
    return (d - _EPOCH).days if isinstance(d, _dt.date) else int(d)


def arctan2(y: Any, x: Any) -> Expr:
    """The angle of the point (x, y) in radians (a string is a column)."""
    return Expr(E.EFunction("arctan2", (parse_into_expr(y), parse_into_expr(x))))


def arctan2d(y: Any, x: Any) -> Expr:
    """The angle of the point (x, y) in degrees."""
    return Expr(E.EFunction("arctan2", (parse_into_expr(y), parse_into_expr(x)), (("degrees", True),)))

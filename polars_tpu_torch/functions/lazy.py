"""Lazy top-level functions (the port of ``polars_tpu/functions/lazy.py``,
trimmed to ``col``, ``lit``, ``len``, ``when``/``then``/``otherwise``,
``coalesce``, the temporal constructors ``date``, ``datetime`` and
``duration``, and the eager ``date_range`` and ``datetime_range``)."""

from __future__ import annotations

import datetime as _pydt
from typing import Any

import numpy as np

from polars_tpu_torch import datatypes as dt
from polars_tpu_torch.errors import InvalidOperationError
from polars_tpu_torch.expr.expr import Expr, parse_into_expr, series_literal, temporal_literal
from polars_tpu_torch.plan import exprs as E


def col(name: str) -> Expr:
    """Reference to one column by name."""
    if not isinstance(name, str) or name == "*":
        raise NotImplementedError("col() of several columns, wildcards or dtypes is not ported yet")
    return Expr(E.EColumn(name))


def lit(value: Any, dtype: Any = None) -> Expr:
    """A literal: a scalar, or a list, tuple or 1-D array as a literal Series."""
    if isinstance(value, Expr):
        return value
    if isinstance(value, (_pydt.date, _pydt.timedelta)):
        if dtype is None:
            return Expr(temporal_literal(value))
        if isinstance(value, _pydt.date):  # an ISO string (an aware one in UTC), parsed into ``dtype``
            if isinstance(value, _pydt.datetime) and value.tzinfo is not None:
                value = value.astimezone(_pydt.timezone.utc)
            return Expr(E.ELiteral(value.isoformat(), dt.parse_into_dtype(dtype)))
    if isinstance(value, (list, tuple, np.ndarray)):
        node = series_literal(value)
        return Expr(node if dtype is None else E.ECast(node, dt.parse_into_dtype(dtype), True))
    if isinstance(value, np.generic):
        value = value.item()
        if dtype is None:
            dtype = dt.numpy_to_dtype(np.asarray(value).dtype)
    return Expr(E.ELiteral(value, dt.parse_into_dtype(dtype) if dtype is not None else None))


def coalesce(*exprs: Any) -> Expr:
    """The first non-null value of the expressions, row by row (a plain
    string is a column name)."""
    nodes = [parse_into_expr(e) for e in exprs]
    if not nodes:
        raise InvalidOperationError("coalesce needs at least one expression")
    return Expr(E.EFunction("coalesce", tuple(nodes)))


def len() -> Expr:  # noqa: A001
    """Row count (per group inside an aggregation)."""
    return Expr(E.ELen())


# -- when/then/otherwise --------------------------------------------------------


class When:
    __slots__ = ("_condition",)

    def __init__(self, condition: E.ENode) -> None:
        self._condition = condition

    def then(self, statement: Any) -> Then:
        return Then([(self._condition, parse_into_expr(statement))])


class Then(Expr):
    """A when/then chain; without ``otherwise`` the rest is null."""

    __slots__ = ("_branches",)

    def __init__(self, branches: list[tuple[E.ENode, E.ENode]]) -> None:
        self._branches = branches
        super().__init__(self._build(E.ELiteral(None)))

    def _build(self, otherwise: E.ENode) -> E.ENode:
        node = otherwise
        for cond, stmt in reversed(self._branches):
            node = E.ETernary(cond, stmt, node)
        return node

    def when(self, *predicates: Any, **constraints: Any) -> ChainedWhen:
        return ChainedWhen(self._branches, _when_condition(predicates, constraints))

    def otherwise(self, statement: Any) -> Expr:
        return Expr(self._build(parse_into_expr(statement)))


class ChainedWhen:
    __slots__ = ("_branches", "_condition")

    def __init__(self, branches: list, condition: E.ENode) -> None:
        self._branches = branches
        self._condition = condition

    def then(self, statement: Any) -> Then:
        return Then([*self._branches, (self._condition, parse_into_expr(statement))])


def _when_condition(predicates: tuple, constraints: dict) -> E.ENode:
    conds: list[E.ENode] = [parse_into_expr(p) for p in predicates]
    for name, value in constraints.items():
        conds.append(E.EBinary(E.EColumn(name), "==", parse_into_expr(value, str_as_lit=True)))
    if not conds:
        raise ValueError("when() requires at least one predicate")
    node = conds[0]
    for c in conds[1:]:
        node = E.EBinary(node, "&", c)
    return node


def when(*predicates: Any, **constraints: Any) -> When:
    """Start a when/then/otherwise chain."""
    return When(_when_condition(predicates, constraints))


# -- temporal constructors ------------------------------------------------------------


def _fn(name: str, inputs, **options: Any) -> Expr:
    nodes = tuple(parse_into_expr(v, str_as_lit=True) for v in inputs)
    return Expr(E.EFunction(name, nodes, tuple(sorted(options.items()))))


def date(year: Any, month: Any, day: Any) -> Expr:
    """A Date from year, month and day expressions or values."""
    return _fn("make_date", (year, month, day)).alias("date")


def datetime(year: Any, month: Any, day: Any, hour: Any = 0, minute: Any = 0, second: Any = 0,
             microsecond: Any = 0, *, time_unit: str = "us", time_zone: str | None = None) -> Expr:
    """A Datetime from its parts (expressions or values); with
    ``time_zone``, the parts are the wall clock of that zone, as Polars
    reads them (the JAX package drops the zone)."""
    e = _fn("make_datetime", (year, month, day, hour, minute, second, microsecond), time_unit=time_unit)
    if time_zone is not None:
        e = e.dt.replace_time_zone(time_zone)
    return e.alias("datetime")


def duration(*, weeks: Any = None, days: Any = None, hours: Any = None, minutes: Any = None, seconds: Any = None,
             milliseconds: Any = None, microseconds: Any = None, nanoseconds: Any = None,
             time_unit: str = "us") -> Expr:
    """A Duration, the sum of the given parts (expressions or values)."""
    parts = {"weeks": weeks, "days": days, "hours": hours, "minutes": minutes, "seconds": seconds,
             "milliseconds": milliseconds, "microseconds": microseconds, "nanoseconds": nanoseconds}
    used = [(k, v) for k, v in parts.items() if v is not None]
    return _fn("make_duration", [v for _, v in used], units=tuple(k for k, _ in used),
               time_unit=time_unit).alias("duration")


def date_range(start: Any, end: Any, interval: str = "1d", *, closed: str = "both", eager: bool = False):
    """The Dates from ``start`` to ``end`` by ``interval``, as a Series
    named "literal" (only the eager form is ported)."""
    return _temporal_range(start, end, interval, closed, dt.Date(), eager)


def datetime_range(start: Any, end: Any, interval: str = "1d", *, closed: str = "both", time_unit: str = "us",
                   time_zone: str | None = None, eager: bool = False):
    """The Datetimes from ``start`` to ``end`` by ``interval``, as a Series
    named "literal" (only the eager form is ported). With ``time_zone`` (or
    aware bounds) the range is of that zone, as Polars makes it: naive
    bounds are its wall clock, days, weeks, months and years step the wall
    clock, and shorter intervals step the instants (the JAX package returns
    naive values)."""
    from polars_tpu_torch.kernels.timezone import zone, zone_name

    tz = time_zone
    for b in (start, end):
        if tz is None and isinstance(b, _pydt.datetime) and b.tzinfo is not None:
            tz = zone_name(b.tzinfo)
    if tz is None or not eager:
        return _temporal_range(start, end, interval, closed, dt.Datetime(time_unit), eager)
    from polars_tpu_torch.core.series import Series
    from polars_tpu_torch.engine.fn_temporal import _parse_every

    z = zone(tz)

    def wall(b):  # a bound as a naive wall time of the zone
        if isinstance(b, str):
            b = _pydt.datetime.fromisoformat(b)
        if not isinstance(b, _pydt.datetime):
            b = _pydt.datetime(b.year, b.month, b.day)
        return b.astimezone(z).replace(tzinfo=None) if b.tzinfo is not None else b

    lo, hi = wall(start), wall(end)
    if _parse_every(interval)[1] in ("d", "w", "mo", "q", "y"):
        values = [v.replace(tzinfo=z) for v in temporal_range_values(lo, hi, interval, closed)]
    else:  # physical steps, between UTC instants
        def utc(w):
            return w.replace(tzinfo=z).astimezone(_pydt.timezone.utc).replace(tzinfo=None)

        values = [v.replace(tzinfo=_pydt.timezone.utc).astimezone(z)
                  for v in temporal_range_values(utc(lo), utc(hi), interval, closed)]
    return Series("literal", values, dt.Datetime(time_unit, tz))


def _temporal_range(start, end, interval: str, closed: str, dtype: dt.DataType, eager: bool):
    if not eager:
        raise NotImplementedError(
            "date_range/datetime_range as a lazy expression is not ported yet (port queue: expression breadth)")
    from polars_tpu_torch.core.series import Series

    return Series("literal", temporal_range_values(start, end, interval, closed), dtype)


def temporal_range_values(start: Any, end: Any, interval: str, closed: str) -> list:
    """The Python dates or datetimes from ``start`` through ``end`` by
    ``interval``, honouring ``closed`` (the JAX package's
    ``engine/run._temporal_range``); a month step keeps the day of the
    month."""
    from polars_tpu_torch.engine.fn_temporal import _parse_every

    n, unit = _parse_every(interval)
    sub_day = unit in ("h", "m", "s", "ms", "us")

    def parse(x):
        if isinstance(x, str):
            x = _pydt.datetime.fromisoformat(x) if len(x) > 10 or "T" in x else _pydt.date.fromisoformat(x)
        if sub_day and not isinstance(x, _pydt.datetime):
            x = _pydt.datetime(x.year, x.month, x.day)
        return x

    start, end = parse(start), parse(end)
    fixed = {"d": "days", "w": "weeks", "h": "hours", "m": "minutes", "s": "seconds", "ms": "milliseconds",
             "us": "microseconds"}
    out, cur = [], start
    while cur <= end if closed in ("both", "right") else cur < end:
        prev = cur
        out.append(cur)
        if unit in fixed:
            cur = cur + _pydt.timedelta(**{fixed[unit]: n})
        elif unit == "mo":
            months = cur.month - 1 + n
            cur = cur.replace(year=cur.year + months // 12, month=months % 12 + 1)
        elif unit == "y":
            cur = cur.replace(year=cur.year + n)
        else:
            raise InvalidOperationError(f"range interval {unit!r}")
        if cur == prev:
            raise InvalidOperationError(f"interval {interval!r} makes no progress over {type(prev).__name__} bounds")
    if closed in ("right", "none") and out and out[0] == start:
        out = out[1:]
    return out

"""Lazy top-level functions (the port of ``polars_tpu/functions/lazy.py``,
trimmed to ``col`` (of names, dtypes or the wildcard), ``nth``, ``first``,
``last``, ``all``, ``exclude``, ``lit``, ``len``, ``count``, the column-wise
aggregate shortcuts, ``corr`` and ``cov``, ``select``,
``when``/``then``/``otherwise``, ``coalesce``, the horizontal functions
with ``fold`` and ``reduce``, the generators ``int_range`` and ``repeat``,
the temporal constructors ``date``, ``datetime`` and ``duration``, and the
eager ``date_range`` and ``datetime_range``)."""

from __future__ import annotations

import builtins
import datetime as _pydt
from collections.abc import Iterable
from typing import Any

import numpy as np

from polars_tpu_torch import datatypes as dt
from polars_tpu_torch.errors import InvalidOperationError
from polars_tpu_torch.expr.expr import Expr, parse_into_expr, parse_into_expr_list, series_literal, temporal_literal
from polars_tpu_torch.plan import exprs as E


def element() -> Expr:
    """The column an expression of ``cumulative_eval`` runs over (the
    column named "")."""
    return Expr(E.EColumn(""))


def col(name: Any, *more_names: Any) -> Expr:
    """One column by name; several by names (or an iterable of them), every
    column by ``"*"``, or every column of the given dtypes."""
    names: list[Any] = [name, *more_names]
    if builtins.len(names) == 1:
        n = names[0]
        if isinstance(n, str):
            return Expr(E.EColumns(())) if n == "*" else Expr(E.EColumn(n))
        if isinstance(n, (dt.DataType, dt.DataTypeClass)):
            return Expr(E.EDtypeColumns((dt.parse_into_dtype(n),)))
        if isinstance(n, Iterable):
            names = list(n)
    if builtins.all(isinstance(n, str) for n in names):
        return Expr(E.EColumns(tuple(names)))
    if builtins.all(isinstance(n, (dt.DataType, dt.DataTypeClass)) for n in names):
        return Expr(E.EDtypeColumns(tuple(dt.parse_into_dtype(n) for n in names)))
    raise TypeError("col() accepts strings or datatypes, not a mix")


def nth(*indices: int) -> Expr:
    """The columns at the given positions (negative from the end)."""
    return Expr(E.ESelector("nth", tuple(indices)))


def all(*names: str, ignore_nulls: bool = True) -> Expr:  # noqa: A001
    """Every column; with names, ``all`` of those Boolean columns."""
    if not names:
        return Expr(E.EColumns(()))
    return col(*names).all(ignore_nulls=ignore_nulls)


def any(*names: str, ignore_nulls: bool = True) -> Expr:  # noqa: A001
    return col(*names).any(ignore_nulls=ignore_nulls)


def exclude(*names: Any) -> Expr:
    """Every column but ``names``."""
    return Expr(E.EColumns(())).exclude(*names)


def sum(*names: Any) -> Expr:  # noqa: A001
    return col(*names).sum()


def min(*names: Any) -> Expr:  # noqa: A001
    return col(*names).min()


def max(*names: Any) -> Expr:  # noqa: A001
    return col(*names).max()


def mean(*names: Any) -> Expr:
    return col(*names).mean()


def median(*names: Any) -> Expr:
    return col(*names).median()


def std(column: str, ddof: int = 1) -> Expr:
    return col(column).std(ddof=ddof)


def var(column: str, ddof: int = 1) -> Expr:
    return col(column).var(ddof=ddof)


def quantile(column: str, quantile: float, interpolation: str = "nearest") -> Expr:
    return col(column).quantile(quantile, interpolation)


def n_unique(*columns: str) -> Expr:
    return col(*columns).n_unique()


def count(*columns: str) -> Expr:
    """The non-null values of ``columns``; without them the row count,
    named "count"."""
    if not columns:
        return Expr(E.ELen()).alias("count")
    return col(*columns).count()


def first(column: str | None = None) -> Expr:
    """The first value of ``column``; without one, the first column."""
    return Expr(E.ESelector("nth", (0,))) if column is None else col(column).first()


def last(column: str | None = None) -> Expr:
    """The last value of ``column``; without one, the last column."""
    return Expr(E.ESelector("nth", (-1,))) if column is None else col(column).last()


def select(*exprs: Any, **named_exprs: Any):
    """The expressions evaluated over an empty frame (literals, ranges)."""
    from polars_tpu_torch.core.frame import DataFrame

    return DataFrame({}).select(*exprs, **named_exprs)


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
    from polars_tpu_torch.core.series import Series

    if isinstance(value, Series):  # a literal Series of its own length (one value broadcasts)
        node = parse_into_expr(value)
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
    if not eager:  # a generator of its own length, named as its start; its bounds read once (engine/hostops.generate)
        return _fn("temporal_range", [start, end], interval=interval, closed=closed, dtype=dtype)
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


def _per_row(name: str, alias: str, inputs: list, eager: bool, **options: Any):
    """A List of a range per row (``engine/fn_generators.py``); eager: over
    a frame of no columns, as a Series."""
    e = _fn(name, [parse_into_expr(i) for i in inputs], **options).alias(alias)
    return _eager_series(e, alias) if eager else e


def int_ranges(start: Any = 0, end: Any = None, step: Any = 1, *, dtype: Any = None, eager: bool = False):
    """Per row, the integers from ``start`` up to ``end`` (excluded) by
    ``step``, as a List."""
    if end is None:
        start, end = 0, start
    return _per_row("int_ranges", "int_range", [start, end, step], eager,
                    dtype=None if dtype is None else dt.parse_into_dtype(dtype))


def date_ranges(start: Any, end: Any, interval: str = "1d", *, closed: str = "both", eager: bool = False):
    """Per row, the Dates from ``start`` to ``end`` by ``interval``."""
    return _per_row("date_ranges", "date_range", [start, end], eager, interval=interval, closed=closed)


def datetime_ranges(start: Any, end: Any, interval: str = "1d", *, closed: str = "both", time_unit: str = "us",
                    time_zone: str | None = None, eager: bool = False):
    """Per row, the Datetimes from ``start`` to ``end`` by ``interval`` (in
    ``time_zone``'s wall clock where one is given)."""
    return _per_row("datetime_ranges", "datetime_range", [start, end], eager, interval=interval, closed=closed,
                    time_unit=time_unit, time_zone=time_zone)


def time_ranges(start: Any = None, end: Any = None, interval: str = "1h", *, closed: str = "both",
                eager: bool = False):
    """Per row, the Times from ``start`` to ``end`` by ``interval``."""
    return _per_row("time_ranges", "time_range", [start, end], eager, interval=interval, closed=closed)


def linear_spaces(start: Any, end: Any, num_samples: Any, *, closed: str = "both", as_array: bool = False,
                  eager: bool = False):
    """Per row, ``num_samples`` evenly spaced floats from ``start`` to
    ``end``."""
    return _per_row("linear_spaces", "linear_space", [start, end, num_samples], eager, closed=closed)


def arg_where(condition: Any, *, eager: bool = False):
    """The positions where ``condition`` is true (UInt32): a filter of the
    row positions, compacted by K2 in the segment."""
    from polars_tpu_torch.core.series import Series

    if isinstance(condition, Series):
        out = condition.arg_true()
        return out if eager else lit(out)
    e = (condition if isinstance(condition, Expr) else Expr(parse_into_expr(condition))).arg_true()
    return _eager_series(e, "literal") if eager else e


def concat_arr(exprs: Any, *more_exprs: Any) -> Expr:
    """The values of the expressions side by side, a fixed-width Array."""
    from polars_tpu_torch.expr.expr import _flat

    nodes = [parse_into_expr(e) for e in _flat((exprs, *more_exprs))]
    return concat_list([Expr(n) for n in nodes]).list.to_array(builtins.len(nodes))


def arg_sort_by(exprs: Any, *more_exprs: Any, descending: Any = False) -> Expr:
    """The row positions that sort the frame by the keys (UInt32), nulls
    first."""
    from polars_tpu_torch.expr.expr import _flat, parse_into_expr_list

    nodes = tuple(parse_into_expr_list(_flat((exprs, *more_exprs))))
    k = builtins.len(nodes)
    desc = tuple(descending) if isinstance(descending, (list, tuple)) else (descending,) * k
    return Expr(E.EFunction("arg_sort_by", nodes, (("descending", tuple(map(bool, desc))),)))


# -- aggregate shortcuts -----------------------------------------------------------------------


def approx_n_unique(*columns: str) -> Expr:
    return col(*columns).n_unique()


def cum_sum(*columns: str) -> Expr:
    return col(*columns).cum_sum()


def cum_count(*columns: str, reverse: bool = False) -> Expr:
    """The running count of non-null values of each column (one output
    column per input, as Polars' ``pl.col(*columns).cum_count()``)."""
    return col(*columns).cum_count(reverse=reverse)


def implode(*columns: str) -> Expr:
    return col(*columns).implode()


def struct(*exprs: Any, **named_exprs: Any) -> Expr:
    """A Struct column of the expressions, one field each (named by their
    output names)."""
    nodes = tuple(parse_into_expr_list(list(exprs), named_exprs))
    names = tuple(E.output_name(n) or f"field_{i}" for i, n in enumerate(nodes))
    return Expr(E.EFunction("as_struct", nodes, (("names", names),))).alias(names[0] if nodes else "struct")


def field(name: str) -> Expr:
    """A field of the struct in ``struct.with_fields``."""
    return col(name)


def concat_list(exprs: Any, *more_exprs: Any) -> Expr:
    """The expressions' values, row by row, as one List (a value that is not
    a list counts as a list of one)."""
    nodes = tuple(parse_into_expr_list(exprs if isinstance(exprs, (list, tuple)) else [exprs]))
    nodes += tuple(parse_into_expr_list(list(more_exprs)))
    return Expr(E.EFunction("concat_list", nodes)).alias(E.output_name(nodes[0]) or "literal")


def head(column: str, n: int = 10) -> Expr:
    return col(column).head(n)


def tail(column: str, n: int = 10) -> Expr:
    return col(column).tail(n)


def corr(a: Any, b: Any, *, method: str = "pearson", ddof: int = 1) -> Expr:
    """The correlation of two columns (per group): Pearson's, or Spearman's
    (Pearson's of the average ranks), over the rows where both are
    non-null."""
    if method not in ("pearson", "spearman"):
        raise InvalidOperationError(f"corr: unknown method {method!r}")
    pair = E.EFunction("pack_pair", (parse_into_expr(a), parse_into_expr(b)))
    return Expr(E.EAgg(pair, "corr", (("method", method),)))


def cov(a: Any, b: Any, *, ddof: int = 1) -> Expr:
    """The covariance of two columns (per group) over the rows where both
    are non-null."""
    pair = E.EFunction("pack_pair", (parse_into_expr(a), parse_into_expr(b)))
    return Expr(E.EAgg(pair, "cov", (("ddof", ddof),)))


# -- horizontal ops (selectors splice into their inputs: plan/schema_resolve.splice_horizontal) ----


def concat_str(exprs: Any, *more_exprs: Any, separator: str = "", ignore_nulls: bool = False) -> Expr:
    """The inputs' text joined by ``separator`` per row: null where an input
    is null, or, with ``ignore_nulls``, the rest joined (a host function,
    ``engine/hostops.concat_str_column``)."""
    flat = []
    for x in (exprs, *more_exprs):
        flat.extend(x if isinstance(x, (list, tuple)) else [x])
    nodes = tuple(parse_into_expr(x) for x in flat)
    return Expr(E.EFunction("concat_str", nodes, (("separator", separator), ("ignore_nulls", ignore_nulls))))


def format(f_string: str, *args: Any) -> Expr:  # noqa: A001
    """``f_string`` with each ``{}`` replaced by the next argument's text."""
    parts = f_string.split("{}")
    if builtins.len(parts) - 1 != builtins.len(args):
        raise ValueError("number of placeholders should equal the number of arguments")
    exprs: list = []
    for i, p in enumerate(parts):
        if p:
            exprs.append(lit(p))
        if i < builtins.len(args):
            exprs.append(args[i])
    return concat_str(exprs, separator="").alias("literal")


def _horizontal(name: str, exprs: tuple) -> Expr:
    from polars_tpu_torch.expr.expr import _flat, parse_into_expr_list

    nodes = tuple(parse_into_expr_list(_flat(exprs)))
    if not nodes:
        raise InvalidOperationError(f"{name} needs at least one expression")
    return Expr(E.EFunction(name, nodes))


def all_horizontal(*exprs: Any) -> Expr:
    """Kleene ``&`` across the columns, row by row."""
    return _horizontal("all_horizontal", exprs)


def any_horizontal(*exprs: Any) -> Expr:
    """Kleene ``|`` across the columns, row by row."""
    return _horizontal("any_horizontal", exprs)


def sum_horizontal(*exprs: Any, ignore_nulls: bool = True) -> Expr:
    """The sum across the columns, nulls adding nothing."""
    return _horizontal("sum_horizontal", exprs)


def mean_horizontal(*exprs: Any, ignore_nulls: bool = True) -> Expr:
    """The mean of the non-null values across the columns (null where all
    are null)."""
    return _horizontal("mean_horizontal", exprs)


def min_horizontal(*exprs: Any) -> Expr:
    return _horizontal("min_horizontal", exprs)


def max_horizontal(*exprs: Any) -> Expr:
    return _horizontal("max_horizontal", exprs)


def fold(acc: Any, function: Any, exprs: Any) -> Expr:
    """``function(acc, x)`` over the expressions left to right. Composed
    when the expression enters a plan, after its selectors are spliced in
    (``plan/schema_resolve.splice_horizontal``), so that the plan holds the
    composed expression and never the callable."""
    from polars_tpu_torch.expr.expr import _flat, parse_into_expr_list

    nodes = tuple(parse_into_expr_list(_flat((exprs,))))
    return Expr(E.EFunction("fold", (parse_into_expr(acc, str_as_lit=True), *nodes), (("function", function),)))


def reduce(function: Any, exprs: Any) -> Expr:
    """``fold`` with the first expression as the accumulator."""
    from polars_tpu_torch.expr.expr import _flat, parse_into_expr_list

    nodes = tuple(parse_into_expr_list(_flat((exprs,))))
    if not nodes:
        raise InvalidOperationError("reduce needs at least one expression")
    return Expr(E.EFunction("reduce", nodes, (("function", function),)))


# -- generators (host functions, engine/hostops.generate) ----------------------------------------


def _eager_series(e: Expr, name: str):
    return select(e.alias(name)).to_series(0)


def int_range(start: Any = 0, end: Any = None, step: int = 1, *, dtype: Any = None, eager: bool = False):
    """The integers from ``start`` up to ``end`` by ``step`` (bounds are
    values or one-value expressions such as ``pl.len()``)."""
    if end is None:
        start, end = 0, start
    e = Expr(E.EFunction("int_range", (parse_into_expr(start, str_as_lit=True), parse_into_expr(end, str_as_lit=True)),
                         (("dtype", dt.Int64() if dtype is None else dt.parse_into_dtype(dtype)), ("step", step))))
    return _eager_series(e, "int_range") if eager else e


def arange(start: Any = 0, end: Any = None, step: int = 1, *, dtype: Any = None, eager: bool = False):
    return int_range(start, end, step, dtype=dtype, eager=eager)


def repeat(value: Any, n: Any, *, dtype: Any = None, eager: bool = False):
    """``value`` ``n`` times (``n`` a value or a one-value expression)."""
    e = Expr(E.EFunction("repeat_value", (parse_into_expr(value, str_as_lit=True), parse_into_expr(n, str_as_lit=True)),
                         (("dtype", None if dtype is None else dt.parse_into_dtype(dtype)),))).alias("repeat")
    return _eager_series(e, "repeat") if eager else e


def ones(n: int, dtype: Any = None, *, eager: bool = True):
    return repeat(1, n, dtype=dtype or dt.Float64(), eager=eager)


def zeros(n: int, dtype: Any = None, *, eager: bool = True):
    return repeat(0, n, dtype=dtype or dt.Float64(), eager=eager)

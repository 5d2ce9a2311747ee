"""The fluent ``Expr`` wrapper over the expression AST (the port of
``polars_tpu/expr/expr.py``, trimmed to the operations the ported queries
evaluate: arithmetic, comparison, boolean ``&``/``|``/``~``, casts, ``is_in``,
``is_between``, the null functions (``is_null``, ``fill_null`` with a value,
``fill_nan``, ``coalesce``, the NaN and finiteness tests), the ``.str`` and
``.dt`` namespaces, aliasing and the sum,
mean, min, max, count, len, first, last and n_unique aggregations). Nothing
executes until a plan is collected.
"""

from __future__ import annotations

import datetime as _pydt
from typing import Any, Iterable

import numpy as np

from polars_tpu_torch import datatypes as dt
from polars_tpu_torch.errors import InvalidOperationError
from polars_tpu_torch.kernels.timezone import zone_name
from polars_tpu_torch.plan import exprs as E
from polars_tpu_torch.utils.tokens import next_token


def series_literal(values: Any) -> E.ESeriesLit:
    """A list, tuple or 1-D array as a literal Series node. Its column is
    built on the CPU (it is a handful of values); evaluation moves it to the
    frame's device."""
    from polars_tpu_torch.core.column import Column

    vals = values if isinstance(values, np.ndarray) else list(values)
    return E.ESeriesLit(column=Column.from_values("literal", vals, device="cpu"), ident=next_token())


def temporal_literal(value: Any) -> E.ELiteral:
    """A Python date, datetime or timedelta as a literal: a Date, a
    ``Datetime("us")`` (from its ISO string; an aware datetime is its UTC
    instant, with an explicit offset, in a Datetime of its zone) or a
    ``Duration("us")``."""
    if isinstance(value, _pydt.datetime) and value.tzinfo is not None:
        utc = value.astimezone(_pydt.timezone.utc)
        return E.ELiteral(utc.isoformat(), dt.Datetime("us", zone_name(value.tzinfo)))
    if isinstance(value, _pydt.datetime):
        return E.ELiteral(value.isoformat(), dt.Datetime("us"))
    if isinstance(value, _pydt.date):
        return E.ELiteral(value.isoformat(), dt.Date())
    return E.ELiteral((value.days * 86_400 + value.seconds) * 1_000_000 + value.microseconds, dt.Duration("us"))


def _opts(**kwargs: Any) -> tuple[tuple[str, Any], ...]:
    return tuple(sorted(kwargs.items()))


def parse_into_expr(value: Any, *, str_as_lit: bool = False) -> E.ENode:
    """Coerce user input into an AST node (py-polars parse_into_expression)."""
    if isinstance(value, Expr):
        return value._node
    if isinstance(value, E.ENode):
        return value
    if isinstance(value, str) and not str_as_lit:
        return E.EColumn(value)
    if isinstance(value, (_pydt.date, _pydt.timedelta)):
        return temporal_literal(value)
    if isinstance(value, np.generic):
        return E.ELiteral(value.item(), dt.numpy_to_dtype(value.dtype))
    if isinstance(value, (list, tuple, np.ndarray)):
        return series_literal(value)
    return E.ELiteral(value)


def parse_into_expr_list(exprs: Any, named: dict[str, Any] | None = None) -> list[E.ENode]:
    items = [exprs] if isinstance(exprs, (Expr, str, E.ENode)) or not isinstance(exprs, Iterable) else list(exprs)
    flat: list[Any] = []
    for it in items:
        if isinstance(it, (list, tuple)):
            flat.extend(it)
        else:
            flat.append(it)
    out = [parse_into_expr(it) for it in flat]
    for name, v in (named or {}).items():
        out.append(E.EAlias(parse_into_expr(v), name))
    return out


class Expr:
    __slots__ = ("_node",)

    def __init__(self, node: E.ENode) -> None:
        self._node = node

    def __repr__(self) -> str:
        return f"<Expr [{self._node!r}]>"

    def _fn(self, name: str, *inputs: Any, **options: Any) -> Expr:
        nodes = (self._node, *(parse_into_expr(i, str_as_lit=True) for i in inputs))
        return Expr(E.EFunction(name, nodes, _opts(**options)))

    def alias(self, name: str) -> Expr:
        return Expr(E.EAlias(self._node, name))

    def cast(self, dtype: Any, *, strict: bool = True) -> Expr:
        return Expr(E.ECast(self._node, dt.parse_into_dtype(dtype), strict))

    # -- binary ops -----------------------------------------------------------

    def _bin(self, op: str, other: Any, *, swap: bool = False) -> Expr:
        rhs = parse_into_expr(other, str_as_lit=True)
        left, right = (rhs, self._node) if swap else (self._node, rhs)
        return Expr(E.EBinary(left, op, right))

    def __add__(self, other: Any) -> Expr:
        return self._bin("+", other)

    def __radd__(self, other: Any) -> Expr:
        return self._bin("+", other, swap=True)

    def __sub__(self, other: Any) -> Expr:
        return self._bin("-", other)

    def __rsub__(self, other: Any) -> Expr:
        return self._bin("-", other, swap=True)

    def __mul__(self, other: Any) -> Expr:
        return self._bin("*", other)

    def __rmul__(self, other: Any) -> Expr:
        return self._bin("*", other, swap=True)

    def __truediv__(self, other: Any) -> Expr:
        return self._bin("/", other)

    def __rtruediv__(self, other: Any) -> Expr:
        return self._bin("/", other, swap=True)

    def __floordiv__(self, other: Any) -> Expr:
        return self._bin("//", other)

    def __mod__(self, other: Any) -> Expr:
        return self._bin("%", other)

    def __eq__(self, other: Any) -> Expr:  # type: ignore[override]
        return self._bin("==", other)

    def __ne__(self, other: Any) -> Expr:  # type: ignore[override]
        return self._bin("!=", other)

    def __lt__(self, other: Any) -> Expr:
        return self._bin("<", other)

    def __le__(self, other: Any) -> Expr:
        return self._bin("<=", other)

    def __gt__(self, other: Any) -> Expr:
        return self._bin(">", other)

    def __ge__(self, other: Any) -> Expr:
        return self._bin(">=", other)

    def __and__(self, other: Any) -> Expr:
        return self._bin("&", other)

    def __rand__(self, other: Any) -> Expr:
        return self._bin("&", other, swap=True)

    def __or__(self, other: Any) -> Expr:
        return self._bin("|", other)

    def __ror__(self, other: Any) -> Expr:
        return self._bin("|", other, swap=True)

    def __invert__(self) -> Expr:
        return self._fn("not")

    __hash__ = None  # == builds an expression, so Expr is not hashable

    # -- membership / range ---------------------------------------------------

    def is_in(self, other: Any, *, nulls_equal: bool = False) -> Expr:
        return self._fn("is_in", other, nulls_equal=nulls_equal)

    def is_between(self, lower_bound: Any, upper_bound: Any, closed: str = "both") -> Expr:
        if closed not in ("both", "left", "right", "none"):
            raise ValueError(f"`closed` must be one of 'both', 'left', 'right', 'none', got {closed!r}")
        return self._fn("is_between", lower_bound, upper_bound, closed=closed)

    # -- null handling ----------------------------------------------------------

    def is_null(self) -> Expr:
        return self._fn("is_null")

    def is_not_null(self) -> Expr:
        return self._fn("is_not_null")

    def is_nan(self) -> Expr:
        return self._fn("is_nan")

    def is_not_nan(self) -> Expr:
        return self._fn("is_not_nan")

    def is_finite(self) -> Expr:
        return self._fn("is_finite")

    def is_infinite(self) -> Expr:
        return self._fn("is_infinite")

    def fill_null(self, value: Any = None, strategy: str | None = None) -> Expr:
        """Nulls replaced by ``value`` (a literal or an expression; a plain
        string is a literal). A ``strategy`` fills from neighbouring rows,
        which needs the positional functions of a later slice."""
        if strategy is not None:
            raise NotImplementedError(
                f"fill_null(strategy={strategy!r}) is not ported yet (port queue: expression breadth)")
        if value is None:
            raise InvalidOperationError("must specify either a fill value or a strategy")
        return self._fn("fill_null", value)

    def fill_nan(self, value: Any) -> Expr:
        return self._fn("fill_nan", value)

    def coalesce(self, *others: Any) -> Expr:
        from polars_tpu_torch.functions.lazy import coalesce

        return coalesce(self, *others)

    # -- namespaces -----------------------------------------------------------

    @property
    def str(self):
        from polars_tpu_torch.expr.string import ExprStringNamespace

        return ExprStringNamespace(self)

    @property
    def dt(self):
        from polars_tpu_torch.expr.datetime import ExprDateTimeNamespace

        return ExprDateTimeNamespace(self)

    # -- aggregations ---------------------------------------------------------

    def _agg(self, kind: str) -> Expr:
        return Expr(E.EAgg(self._node, kind))

    def sum(self) -> Expr:
        return self._agg("sum")

    def mean(self) -> Expr:
        return self._agg("mean")

    def min(self) -> Expr:
        return self._agg("min")

    def max(self) -> Expr:
        return self._agg("max")

    def count(self) -> Expr:
        return self._agg("count")

    def len(self) -> Expr:
        return self._agg("len")

    def first(self) -> Expr:
        return self._agg("first")

    def last(self) -> Expr:
        return self._agg("last")

    def n_unique(self) -> Expr:
        return self._agg("n_unique")

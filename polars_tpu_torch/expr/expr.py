"""The fluent ``Expr`` wrapper over the expression AST (the port of
``polars_tpu/expr/expr.py``, trimmed to the operations this slice evaluates:
arithmetic, comparison, boolean ``&``/``|``, aliasing and the sum, mean, min,
max, count and len aggregations). Nothing executes until a plan is collected.
"""

from __future__ import annotations

import datetime as _pydt
from typing import Any, Iterable

import numpy as np

from polars_tpu_torch import datatypes as dt
from polars_tpu_torch.plan import exprs as E


def parse_into_expr(value: Any, *, str_as_lit: bool = False) -> E.ENode:
    """Coerce user input into an AST node (py-polars parse_into_expression)."""
    if isinstance(value, Expr):
        return value._node
    if isinstance(value, E.ENode):
        return value
    if isinstance(value, str) and not str_as_lit:
        return E.EColumn(value)
    if isinstance(value, _pydt.datetime):
        raise NotImplementedError("Datetime literals are not ported yet (port queue: rest of PDS-H)")
    if isinstance(value, _pydt.date):
        return E.ELiteral(value.isoformat(), dt.Date())
    if isinstance(value, np.generic):
        return E.ELiteral(value.item(), dt.numpy_to_dtype(value.dtype))
    if isinstance(value, (list, tuple, np.ndarray)):
        raise NotImplementedError("Series literals are not ported yet (port queue: expression breadth)")
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

    def alias(self, name: str) -> Expr:
        return Expr(E.EAlias(self._node, name))

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

    __hash__ = None  # == builds an expression, so Expr is not hashable

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

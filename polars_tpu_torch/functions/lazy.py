"""Lazy top-level functions (the port of ``polars_tpu/functions/lazy.py``,
trimmed to ``col``, ``lit``, ``len`` and ``when``/``then``/``otherwise``)."""

from __future__ import annotations

import datetime as _pydt
from typing import Any

import numpy as np

from polars_tpu_torch import datatypes as dt
from polars_tpu_torch.expr.expr import Expr, parse_into_expr, series_literal
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
    if isinstance(value, _pydt.datetime):
        raise NotImplementedError(
            "Datetime literals are not ported yet"
            " (port queue: temporal breadth and asof/range joins)")
    if isinstance(value, _pydt.date) and dtype is None:
        return Expr(E.ELiteral(value.isoformat(), dt.Date()))
    if isinstance(value, (list, tuple, np.ndarray)):
        node = series_literal(value)
        return Expr(node if dtype is None else E.ECast(node, dt.parse_into_dtype(dtype), True))
    if isinstance(value, np.generic):
        value = value.item()
        if dtype is None:
            dtype = dt.numpy_to_dtype(np.asarray(value).dtype)
    return Expr(E.ELiteral(value, dt.parse_into_dtype(dtype) if dtype is not None else None))


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

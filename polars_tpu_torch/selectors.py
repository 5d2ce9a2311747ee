"""Column selectors (the port of ``polars_tpu/selectors.py``; reference:
py-polars selectors.py). Each is an ``ESelector`` node that the plan
expands against its input schema when the expression enters a plan
(``plan/schema_resolve.expand_exprs``)."""

from __future__ import annotations

import builtins as _builtins  # `list`/`object` below shadow the builtins
from typing import Any

from polars_tpu_torch.expr.expr import Expr
from polars_tpu_torch.plan import exprs as E


class SelectorExpr(Expr):
    """An Expr whose node is a selector; supports set algebra operators."""

    def _sel(self) -> E.ENode:
        return self._node

    def __or__(self, other: Any) -> Expr:
        if isinstance(other, SelectorExpr):
            return SelectorExpr(E.ESelector("set", (), op="union", left=self._node, right=other._node))
        return super().__or__(other)

    def __and__(self, other: Any) -> Expr:
        if isinstance(other, SelectorExpr):
            return SelectorExpr(E.ESelector("set", (), op="intersection", left=self._node, right=other._node))
        return super().__and__(other)

    def __sub__(self, other: Any) -> Expr:
        if isinstance(other, SelectorExpr):
            return SelectorExpr(E.ESelector("set", (), op="difference", left=self._node, right=other._node))
        return super().__sub__(other)

    def __invert__(self) -> Expr:
        return SelectorExpr(E.ESelector("set", (), op="complement", left=self._node))

    def as_expr(self) -> Expr:
        return Expr(self._node)


def _mk(kind: str, *args: Any) -> SelectorExpr:
    return SelectorExpr(E.ESelector(kind, tuple(args)))


def all() -> SelectorExpr:  # noqa: A001
    return _mk("all")


def numeric() -> SelectorExpr:
    return _mk("numeric")


def integer() -> SelectorExpr:
    return _mk("integer")


def signed_integer() -> SelectorExpr:
    return _mk("signed_integer")


def unsigned_integer() -> SelectorExpr:
    return _mk("unsigned_integer")


def float() -> SelectorExpr:  # noqa: A001
    return _mk("float")


def string(*, include_categorical: bool = False) -> SelectorExpr:
    if include_categorical:
        return SelectorExpr(
            E.ESelector("set", (), op="union",
                        left=E.ESelector("string"), right=E.ESelector("categorical"))
        )
    return _mk("string")


def boolean() -> SelectorExpr:
    return _mk("boolean")


def temporal() -> SelectorExpr:
    return _mk("temporal")


def date() -> SelectorExpr:
    return _mk("date")


def datetime(time_unit: Any = None, time_zone: Any = None) -> SelectorExpr:
    return _mk("datetime")


def duration(time_unit: Any = None) -> SelectorExpr:
    return _mk("duration")


def time() -> SelectorExpr:
    return _mk("time")


def categorical() -> SelectorExpr:
    return _mk("categorical")


def binary() -> SelectorExpr:
    return _mk("binary")


def decimal() -> SelectorExpr:
    return _mk("decimal")


def enum() -> SelectorExpr:
    return _mk("enum")


def list(inner: Any = None) -> SelectorExpr:  # noqa: A001
    return _mk("list")


def array(inner: Any = None, *, width: Any = None) -> SelectorExpr:
    return _mk("array")


def struct() -> SelectorExpr:
    return _mk("struct")


def nested() -> SelectorExpr:
    return _mk("nested")


def by_name(*names: str, require_all: bool = True) -> SelectorExpr:
    flat: list[str] = []
    for n in names:
        if isinstance(n, str):
            flat.append(n)
        else:
            flat.extend(n)
    return _mk("by_name", *flat)


def by_dtype(*dtypes: Any) -> SelectorExpr:
    flat: list[Any] = []
    for d in dtypes:
        if isinstance(d, (_builtins.list, tuple)):
            flat.extend(d)
        else:
            flat.append(d)
    return _mk("by_dtype", *flat)


def by_index(*indices: int) -> SelectorExpr:
    return _mk("nth", *indices)


def matches(pattern: str) -> SelectorExpr:
    return _mk("matches", pattern)


def starts_with(*prefix: str) -> SelectorExpr:
    return _mk("starts_with", *prefix)


def ends_with(*suffix: str) -> SelectorExpr:
    return _mk("ends_with", *suffix)


def contains(*substring: str) -> SelectorExpr:
    return _mk("contains", *substring)


def first() -> SelectorExpr:
    return _mk("nth", 0)


def last() -> SelectorExpr:
    return _mk("nth", -1)


def alpha(ascii_only: bool = False, *, ignore_spaces: bool = False) -> SelectorExpr:
    return _mk("matches", r"^[A-Za-z]+$" if not ignore_spaces else r"^[A-Za-z ]+$")


def alphanumeric(ascii_only: bool = False, *, ignore_spaces: bool = False) -> SelectorExpr:
    return _mk("matches", r"^[A-Za-z0-9]+$" if not ignore_spaces else r"^[A-Za-z0-9 ]+$")


def digit(ascii_only: bool = False) -> SelectorExpr:
    return _mk("matches", r"^[0-9]+$")


def exclude(*names: str) -> SelectorExpr:
    return ~by_name(*names, require_all=False)


def expand_selector(target: Any, selector: Expr) -> tuple[str, ...]:
    from polars_tpu_torch.plan.schema_resolve import selector_columns

    schema = target.schema if hasattr(target, "schema") else target
    from polars_tpu_torch.core.schema import Schema

    if not isinstance(schema, Schema):
        schema = Schema(schema)
    return tuple(selector_columns(selector._node, schema))


def is_selector(obj: Any) -> bool:
    return isinstance(obj, SelectorExpr)


# reference exposes the selector class as `Selector`
Selector = SelectorExpr

"""String expression namespace (the port of ``polars_tpu/expr/string.py``,
trimmed to ``starts_with``, ``ends_with``, ``contains`` and ``slice``). Ops
run once per dictionary value on the host and map through the codes on the
device (see ``engine/fn_strings.py``)."""

from __future__ import annotations

from typing import TYPE_CHECKING, Any

if TYPE_CHECKING:
    from polars_tpu_torch.expr.expr import Expr


class ExprStringNamespace:
    __slots__ = ("_expr",)

    def __init__(self, expr: Expr) -> None:
        self._expr = expr

    def _fn(self, name: str, *inputs: Any, **options: Any) -> Expr:
        return self._expr._fn(f"str.{name}", *inputs, **options)

    def starts_with(self, prefix: Any) -> Expr:
        if not isinstance(prefix, str) and prefix is not None:
            return self._fn("starts_with", prefix)  # expression right-hand side
        return self._fn("starts_with", prefix=prefix)

    def ends_with(self, suffix: Any) -> Expr:
        if not isinstance(suffix, str) and suffix is not None:
            return self._fn("ends_with", suffix)
        return self._fn("ends_with", suffix=suffix)

    def contains(self, pattern: str, *, literal: bool = False, strict: bool = True) -> Expr:
        return self._fn("contains", pattern=pattern, literal=literal, strict=strict)

    def slice(self, offset: int, length: int | None = None) -> Expr:
        return self._fn("slice", offset=offset, length=length)

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        raise NotImplementedError(f"str.{name} is not ported yet (port queue: expression breadth)")

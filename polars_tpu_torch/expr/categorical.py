"""Categorical expression namespace (the port of
``polars_tpu/expr/categorical.py``). A Categorical is a dictionary-coded
String whose codes are its physical values; its string functions are the
``str`` ones over the dictionary."""

from __future__ import annotations

from typing import TYPE_CHECKING

if TYPE_CHECKING:
    from polars_tpu_torch.expr.expr import Expr


class ExprCatNamespace:
    __slots__ = ("_expr",)

    def __init__(self, expr: Expr) -> None:
        self._expr = expr

    def get_categories(self) -> Expr:
        """The dictionary's values, one row each (a host function)."""
        return self._expr._fn("cat.get_categories")

    def to_local(self) -> Expr:
        return self._expr

    def set_ordering(self, ordering: str) -> Expr:
        return self._expr

    def starts_with(self, prefix: str) -> Expr:
        return self._expr._fn("str.starts_with", prefix=prefix)

    def ends_with(self, suffix: str) -> Expr:
        return self._expr._fn("str.ends_with", suffix=suffix)

    def len_bytes(self) -> Expr:
        return self._expr._fn("str.len_bytes")

    def len_chars(self) -> Expr:
        return self._expr._fn("str.len_chars")

    def slice(self, offset: int, length: int | None = None) -> Expr:
        return self._expr._fn("str.slice", offset=offset, length=length)

    def physical(self) -> Expr:
        return self._expr._fn("to_physical")

    def to(self, dtype, *, strict: bool = True) -> Expr:
        return self._expr.cast(dtype, strict=strict)

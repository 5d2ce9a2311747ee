"""Binary expression namespace (the port of ``polars_tpu/expr/binary.py``).
A Binary column is dictionary-coded like a String, with ``bytes`` values;
each function runs once per dictionary value on the host
(``engine/fn_strings.py``)."""

from __future__ import annotations

from typing import TYPE_CHECKING, Any

if TYPE_CHECKING:
    from polars_tpu_torch.expr.expr import Expr


class ExprBinaryNamespace:
    __slots__ = ("_expr",)

    def __init__(self, expr: Expr) -> None:
        self._expr = expr

    def _fn(self, name: str, **options: Any) -> Expr:
        return self._expr._fn(f"bin.{name}", **options)

    def contains(self, literal: Any) -> Expr:
        return self._fn("contains", literal=literal)

    def starts_with(self, prefix: Any) -> Expr:
        return self._fn("starts_with", prefix=prefix)

    def ends_with(self, suffix: Any) -> Expr:
        return self._fn("ends_with", suffix=suffix)

    def size(self) -> Expr:
        return self._fn("size")

    def encode(self, encoding: str) -> Expr:
        return self._fn("encode", encoding=encoding)

    def decode(self, encoding: str, *, strict: bool = True) -> Expr:
        return self._fn("decode", encoding=encoding, strict=strict)

    def slice(self, offset: int, length: int | None = None) -> Expr:
        return self._fn("slice", offset=offset, length=length)

    def head(self, n: int = 5) -> Expr:
        return self._fn("slice", offset=0, length=n)

    def tail(self, n: int = 5) -> Expr:
        return self._fn("slice", offset=-n, length=None)

    def get(self, index: int) -> Expr:
        return self._fn("get", index=index)

    def reinterpret(self, *, dtype: Any, endianness: str = "little") -> Expr:
        return self._fn("reinterpret", dtype=dtype, endianness=endianness)

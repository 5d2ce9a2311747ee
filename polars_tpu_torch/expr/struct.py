"""The ``struct`` expression namespace (the port of
``polars_tpu/expr/struct.py``). ``field("*")`` and ``unnest`` give one
column per field; they expand when the expression enters a plan
(``plan/schema_resolve.expand_exprs``)."""

from __future__ import annotations

from typing import TYPE_CHECKING, Any

from polars_tpu_torch.plan import exprs as E

if TYPE_CHECKING:
    from polars_tpu_torch.expr.expr import Expr


class ExprStructNamespace:
    __slots__ = ("_expr",)

    def __init__(self, expr: Expr) -> None:
        self._expr = expr

    def field(self, name: str | list[str], *more_names: str) -> Expr:
        from polars_tpu_torch.expr.expr import Expr as _Expr

        names = list(name) if isinstance(name, (list, tuple)) else [name]
        names.extend(more_names)
        if len(names) > 1 or "*" in names:
            return _Expr(E.EFunction("struct.multifield", (self._expr._node,), (("names", tuple(names)),)))
        return _Expr(E.EFunction("struct.field", (self._expr._node,), (("name", names[0]),))).alias(names[0])

    def __getitem__(self, item: str) -> Expr:
        return self.field(item)

    def unnest(self) -> Expr:
        from polars_tpu_torch.expr.expr import Expr as _Expr

        return _Expr(E.EFunction("struct.multifield", (self._expr._node,), (("names", ("*",)),)))

    def rename_fields(self, names: list[str]) -> Expr:
        return self._expr._fn("struct.rename_fields", names=tuple(names))

    def drop(self, names: Any, *, strict: bool = True) -> Expr:
        return self._expr._fn("struct.drop", names=(names,) if isinstance(names, str) else tuple(names))

    def with_fields(self, *exprs: Any, **named_exprs: Any) -> Expr:
        """Fields added or replaced, each an expression over the struct's
        fields (``pl.field``)."""
        from polars_tpu_torch.expr.expr import parse_into_expr

        nodes = [parse_into_expr(e) for e in exprs]
        nodes += [E.EAlias(parse_into_expr(e), n) for n, e in named_exprs.items()]
        return self._expr._fn("struct.with_fields", exprs=tuple(nodes))

    def json_encode(self) -> Expr:
        return self._expr._fn("struct.json_encode")

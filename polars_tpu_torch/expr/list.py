"""The ``list`` and ``arr`` expression namespaces (the port of
``polars_tpu/expr/list.py``; the JAX package's ``arr`` namespace is this
one too, ``expr/expr.py:1148-1170``). Each method is a registered function
of ``engine/fn_nested.py``."""

from __future__ import annotations

from typing import TYPE_CHECKING, Any

if TYPE_CHECKING:
    from polars_tpu_torch.expr.expr import Expr


class ExprListNamespace:
    __slots__ = ("_expr",)

    def __init__(self, expr: Expr) -> None:
        self._expr = expr

    def _fn(self, name: str, *inputs: Any, **options: Any) -> Expr:
        return self._expr._fn(f"list.{name}", *inputs, **options)

    # -- one value per list ---------------------------------------------------

    def len(self) -> Expr:
        return self._fn("len")

    def sum(self) -> Expr:
        return self._fn("sum")

    def mean(self) -> Expr:
        return self._fn("mean")

    def min(self) -> Expr:
        return self._fn("min")

    def max(self) -> Expr:
        return self._fn("max")

    def median(self) -> Expr:
        return self._fn("median")

    def var(self, ddof: int = 1) -> Expr:
        return self._fn("var", ddof=ddof)

    def std(self, ddof: int = 1) -> Expr:
        return self._fn("std", ddof=ddof)

    def n_unique(self) -> Expr:
        return self._fn("n_unique")

    def arg_min(self) -> Expr:
        return self._fn("arg_min")

    def arg_max(self) -> Expr:
        return self._fn("arg_max")

    def any(self) -> Expr:
        return self._fn("any")

    def all(self) -> Expr:
        return self._fn("all")

    def count_matches(self, element: Any) -> Expr:
        return self._fn("count_matches", element)

    def contains(self, item: Any) -> Expr:
        return self._fn("contains", item)

    def get(self, index: Any, *, null_on_oob: bool = False) -> Expr:
        """The element at ``index`` (negative from the end); out of bounds
        fails the query unless ``null_on_oob``."""
        if isinstance(index, int):
            return self._fn("get", index=index, null_on_oob=null_on_oob)
        return self._fn("get", index, null_on_oob=null_on_oob)

    def first(self) -> Expr:
        return self.get(0, null_on_oob=True)

    def last(self) -> Expr:
        return self.get(-1, null_on_oob=True)

    def item(self, *, allow_empty: bool = False) -> Expr:
        return self._fn("item", allow_empty=allow_empty)

    def join(self, separator: str, *, ignore_nulls: bool = True) -> Expr:
        return self._fn("join", separator=separator, ignore_nulls=ignore_nulls)

    # -- new lists ------------------------------------------------------------

    def sort(self, *, descending: bool = False, nulls_last: bool = False) -> Expr:
        return self._fn("sort", descending=descending, nulls_last=nulls_last)

    def reverse(self) -> Expr:
        return self._fn("reverse")

    def unique(self, *, maintain_order: bool = False) -> Expr:
        return self._fn("unique", maintain_order=maintain_order)

    def slice(self, offset: int, length: int | None = None) -> Expr:
        return self._fn("slice", offset=offset, length=length)

    def head(self, n: int = 5) -> Expr:
        return self._fn("head", n=n)

    def tail(self, n: int = 5) -> Expr:
        return self._fn("tail", n=n)

    def shift(self, n: int = 1) -> Expr:
        return self._fn("shift", n=n)

    def diff(self, n: int = 1, null_behavior: str = "ignore") -> Expr:
        return self._fn("diff", n=n, null_behavior=null_behavior)

    def gather_every(self, n: int, offset: int = 0) -> Expr:
        return self._fn("gather_every", n=n, offset=offset)

    def drop_nulls(self) -> Expr:
        return self._fn("drop_nulls")

    def gather(self, indices: Any, *, null_on_oob: bool = False) -> Expr:
        if isinstance(indices, (list, tuple, range)):
            return self._fn("gather", indices=tuple(int(i) for i in indices), null_on_oob=null_on_oob)
        return self._fn("gather", indices, null_on_oob=null_on_oob)

    def sample(self, n: Any = None, *, fraction: Any = None, with_replacement: bool = False,
               shuffle: bool = False, seed: int | None = None) -> Expr:
        return self._fn("sample", n=n, fraction=fraction, with_replacement=with_replacement, shuffle=shuffle,
                        seed=seed)

    def eval(self, expr: Any, *, parallel: bool = False) -> Expr:
        """``expr`` over each list's elements (``pl.element()``)."""
        from polars_tpu_torch.expr.expr import parse_into_expr

        return self._fn("eval", expr=parse_into_expr(expr))

    def agg(self, expr: Any) -> Expr:
        return self.eval(expr)

    def filter(self, predicate: Any) -> Expr:
        """The elements where ``predicate`` (over ``pl.element()``) holds."""
        from polars_tpu_torch.expr.expr import parse_into_expr

        return self._fn("filter", expr=parse_into_expr(predicate))

    def concat(self, other: Any) -> Expr:
        others = other if isinstance(other, (list, tuple)) else [other]
        return self._fn("concat", *(self._other(o) for o in others))

    def _other(self, other: Any) -> Any:
        """A name is a column; a plain collection a one-row List literal."""
        from polars_tpu_torch.expr.expr import Expr as _Expr
        from polars_tpu_torch.functions.lazy import col, lit

        if isinstance(other, str):
            return col(other)
        if isinstance(other, _Expr):
            return other
        if isinstance(other, (set, frozenset, list, tuple)):
            from polars_tpu_torch.core.series import Series

            return lit(Series("literal", [list(other)]))
        return other

    def set_union(self, other: Any) -> Expr:
        return self._fn("set_union", self._other(other))

    def union(self, other: Any) -> Expr:
        return self.set_union(other)

    def set_intersection(self, other: Any) -> Expr:
        return self._fn("set_intersection", self._other(other))

    def set_difference(self, other: Any) -> Expr:
        return self._fn("set_difference", self._other(other))

    def set_symmetric_difference(self, other: Any) -> Expr:
        return self._fn("set_symmetric_difference", self._other(other))

    def explode(self) -> Expr:
        return self._expr._fn("explode")

    # -- other dtypes ----------------------------------------------------------

    def to_array(self, width: int) -> Expr:
        return self._fn("to_array", width=width)

    def to_list(self) -> Expr:
        return self._fn("to_list")

    def to_struct(self, n_field_strategy: str = "first_non_null", fields: Any = None,
                  upper_bound: int = 0) -> Expr:
        if callable(fields):
            fields = tuple(fields(i) for i in range(int(upper_bound)))
        return self._fn("to_struct", fields=None if fields is None else tuple(fields), upper_bound=upper_bound)

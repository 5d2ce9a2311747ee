"""LazyFrame: the lazy query builder (the port of
``polars_tpu/lazyframe.py``, trimmed to ``filter``, ``select``,
``with_columns``, ``group_by().agg``, ``sort``, ``join`` (every ``how``),
``slice``/``head``/``limit`` and ``collect``).

``collect`` runs the plan as written: the port has no optimizer yet, and no
rewrite in the JAX package's optimizer changes what Q1, Q3 or Q4 compute
(inside one fused segment a filter is a row mask above or below a join alike).
"""

from __future__ import annotations

import itertools
from collections.abc import Sequence
from typing import Any

from polars_tpu_torch.core.frame import DataFrame
from polars_tpu_torch.core.schema import Schema
from polars_tpu_torch.errors import InvalidOperationError
from polars_tpu_torch.expr.expr import parse_into_expr_list
from polars_tpu_torch.plan import exprs as E
from polars_tpu_torch.plan import logical as L
from polars_tpu_torch.plan.schema_resolve import node_schema

# process-monotonic scan identities (id() can be reused after GC)
_NEXT_IDENT = itertools.count(1)


class LazyFrame:
    __slots__ = ("_node",)

    @classmethod
    def _from_node(cls, node: L.LNode) -> LazyFrame:
        lf = cls.__new__(cls)
        lf._node = node
        return lf

    @classmethod
    def _from_df(cls, df: DataFrame) -> LazyFrame:
        return cls._from_node(L.LDataFrameScan(df=df, ident=next(_NEXT_IDENT)))

    def _wrap(self, node: L.LNode) -> LazyFrame:
        return LazyFrame._from_node(node)

    @property
    def schema(self) -> Schema:
        return node_schema(self._node)

    def collect_schema(self) -> Schema:
        return node_schema(self._node)

    @property
    def columns(self) -> list[str]:
        return self.schema.names()

    def collect(self) -> DataFrame:
        from polars_tpu_torch.engine.run import execute_plan

        return execute_plan(self._node)

    def lazy(self) -> LazyFrame:
        return self

    def filter(self, *predicates: Any) -> LazyFrame:
        nodes = parse_into_expr_list(list(predicates))
        if not nodes:
            return self
        pred = nodes[0]
        for p in nodes[1:]:
            pred = E.EBinary(pred, "&", p)
        return self._wrap(L.LFilter(self._node, pred))

    def select(self, *exprs: Any, **named_exprs: Any) -> LazyFrame:
        return self._wrap(L.LSelect(self._node, tuple(parse_into_expr_list(list(exprs), named_exprs))))

    def with_columns(self, *exprs: Any, **named_exprs: Any) -> LazyFrame:
        return self._wrap(L.LWithColumns(self._node, tuple(parse_into_expr_list(list(exprs), named_exprs))))

    def sort(
        self,
        by: Any,
        *more_by: Any,
        descending: bool | Sequence[bool] = False,
        nulls_last: bool | Sequence[bool] = False,
        maintain_order: bool = False,
    ) -> LazyFrame:
        by_nodes = tuple(parse_into_expr_list([by, *more_by]))
        k = len(by_nodes)
        desc = tuple(descending) if isinstance(descending, (list, tuple)) else (descending,) * k
        nl = tuple(nulls_last) if isinstance(nulls_last, (list, tuple)) else (nulls_last,) * k
        return self._wrap(L.LSort(self._node, by_nodes, desc, nl, maintain_order))

    def group_by(self, *by: Any, maintain_order: bool = False) -> LazyGroupBy:
        return LazyGroupBy(self, tuple(parse_into_expr_list(list(by))), maintain_order)

    def slice(self, offset: int, length: int | None = None) -> LazyFrame:
        return self._wrap(L.LSlice(self._node, offset, length))

    def head(self, n: int = 5) -> LazyFrame:
        return self.slice(0, n)

    def limit(self, n: int = 5) -> LazyFrame:
        return self.head(n)

    def join(
        self,
        other: LazyFrame,
        on: Any = None,
        how: str = "inner",
        *,
        left_on: Any = None,
        right_on: Any = None,
        suffix: str = "_right",
        validate: str = "m:m",
        nulls_equal: bool = False,
        coalesce: bool | None = None,
        maintain_order: str | None = None,
        join_nulls: bool | None = None,
    ) -> LazyFrame:
        """Equi-join with ``other``: ``how`` is inner, left, right, full (or
        its alias outer), semi, anti or cross (which takes no keys).
        ``validate`` declares the key cardinality (m:m, m:1, 1:m, 1:1) and is
        checked; ``join_nulls`` is the older name of ``nulls_equal``."""
        if join_nulls is not None:
            nulls_equal = join_nulls
        if how == "outer":
            how = "full"
        if how not in ("inner", "left", "right", "full", "semi", "anti", "cross"):
            raise InvalidOperationError(f"unknown join strategy {how!r}")
        if how == "cross":
            lo = ro = ()
        elif on is not None:
            lo = ro = tuple(parse_into_expr_list([on]))
        elif left_on is not None and right_on is not None:
            lo = tuple(parse_into_expr_list([left_on]))
            ro = tuple(parse_into_expr_list([right_on]))
        else:
            raise InvalidOperationError("join requires `on` or `left_on`+`right_on`")
        return self._wrap(
            L.LJoin(self._node, other._node, lo, ro, how, suffix, nulls_equal, coalesce,
                    maintain_order or "none", validate)
        )

    def join_where(self, other: LazyFrame, *predicates: Any, suffix: str = "_right") -> LazyFrame:
        raise NotImplementedError("join_where (range joins) is not ported yet (port queue: join_where and join_asof)")

    def join_asof(self, other: LazyFrame, **kwargs: Any) -> LazyFrame:
        raise NotImplementedError("join_asof is not ported yet (port queue: join_where and join_asof)")


class LazyGroupBy:
    __slots__ = ("_lf", "_keys", "_maintain_order")

    def __init__(self, lf: LazyFrame, keys: tuple[E.ENode, ...], maintain_order: bool) -> None:
        self._lf = lf
        self._keys = keys
        self._maintain_order = maintain_order

    def agg(self, *aggs: Any, **named_aggs: Any) -> LazyFrame:
        nodes = tuple(parse_into_expr_list(list(aggs), named_aggs))
        return self._lf._wrap(L.LGroupBy(self._lf._node, self._keys, nodes, self._maintain_order))

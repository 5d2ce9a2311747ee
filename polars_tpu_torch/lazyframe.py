"""LazyFrame: the lazy query builder (the port of
``polars_tpu/lazyframe.py``, trimmed to ``filter``, ``select``,
``with_columns``, ``group_by().agg``, ``sort`` and ``collect``).

``collect`` runs the plan as written: the port has no optimizer yet, and no
rewrite in the JAX package's optimizer changes what Q1 computes.
"""

from __future__ import annotations

import itertools
from collections.abc import Sequence
from typing import Any

from polars_tpu_torch.core.frame import DataFrame
from polars_tpu_torch.core.schema import Schema
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


class LazyGroupBy:
    __slots__ = ("_lf", "_keys", "_maintain_order")

    def __init__(self, lf: LazyFrame, keys: tuple[E.ENode, ...], maintain_order: bool) -> None:
        self._lf = lf
        self._keys = keys
        self._maintain_order = maintain_order

    def agg(self, *aggs: Any, **named_aggs: Any) -> LazyFrame:
        nodes = tuple(parse_into_expr_list(list(aggs), named_aggs))
        return self._lf._wrap(L.LGroupBy(self._lf._node, self._keys, nodes, self._maintain_order))

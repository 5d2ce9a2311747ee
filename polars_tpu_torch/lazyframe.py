"""LazyFrame: the lazy query builder (the port of
``polars_tpu/lazyframe.py``, trimmed to ``filter``, ``select``,
``with_columns``, ``group_by().agg``, ``sort``, ``join`` (every ``how``),
``join_where``, ``join_asof``, ``slice``/``head``/``limit``, ``unique``,
``rename``, ``drop``, ``with_row_index``, ``cache``, ``explain`` and
``collect``).

``collect`` runs the optimized plan (``plan/optimizer``), as ``polars_tpu``
does; ``collect(no_optimization=True)`` runs the plan as written, and
``optimizations=QueryOptFlags(...)`` turns single passes off.
"""

from __future__ import annotations

from collections.abc import Callable, Mapping, Sequence
from typing import Any

from polars_tpu_torch.core.frame import DataFrame
from polars_tpu_torch.core.schema import Schema
from polars_tpu_torch.errors import InvalidOperationError
from polars_tpu_torch.expr.expr import parse_into_expr_list
from polars_tpu_torch.plan import exprs as E
from polars_tpu_torch.plan import logical as L
from polars_tpu_torch.plan.schema_resolve import node_schema
from polars_tpu_torch.utils.tokens import next_token


class LazyFrame:
    __slots__ = ("_node",)

    @classmethod
    def _from_node(cls, node: L.LNode) -> LazyFrame:
        lf = cls.__new__(cls)
        lf._node = node
        return lf

    @classmethod
    def _from_df(cls, df: DataFrame) -> LazyFrame:
        return cls._from_node(L.LDataFrameScan(df=df, ident=next_token()))

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

    def _plan(self, optimized: bool, optimizations: Any) -> L.LNode:
        from polars_tpu_torch.plan.optimizer import optimize

        return optimize(self._node, optimizations) if optimized else self._node

    def explain(self, *, optimized: bool = True, optimizations: Any = None) -> str:
        """The plan as text, one node a line, its inputs indented below it:
        the optimized plan unless ``optimized=False``."""
        from polars_tpu_torch.plan.fmt import explain_plan

        return explain_plan(self._plan(optimized, optimizations))

    def collect(self, *, no_optimization: bool = False, optimizations: Any = None) -> DataFrame:
        """Run the plan: optimized (every pass of ``optimizations``, a
        ``QueryOptFlags``, or all of them) unless ``no_optimization``. Common
        subplans run once per collect."""
        from polars_tpu_torch.engine.run import execute_plan, plan_cache_scope

        node = self._plan(not no_optimization, optimizations)
        with plan_cache_scope():
            return execute_plan(node)

    def lazy(self) -> LazyFrame:
        return self

    def cache(self) -> LazyFrame:
        """The frame itself: common-subplan elimination finds repeated
        subplans on its own."""
        return self

    def drop(self, *columns: Any, strict: bool = True) -> LazyFrame:
        names = tuple(n for c in columns for n in ([c] if isinstance(c, str) else c))
        return self._wrap(L.LDrop(self._node, names, strict))

    def rename(self, mapping: Mapping[str, str] | Callable[[str], str], *, strict: bool = True) -> LazyFrame:
        """Rename columns by a mapping of old to new names, or by a function
        of the old name."""
        if callable(mapping):
            mapping = {n: mapping(n) for n in self.columns}
        return self._wrap(L.LRename(self._node, tuple(mapping.items()), strict))

    def with_row_index(self, name: str = "index", offset: int = 0) -> LazyFrame:
        """A first column ``name`` of UInt32 row numbers from ``offset``."""
        return self._wrap(L.LWithRowIndex(self._node, name, offset))

    def unique(self, subset: Any = None, *, keep: str = "any", maintain_order: bool = False) -> LazyFrame:
        """One row per distinct value of the ``subset`` columns (every column
        when None): ``keep`` the first, the last, any (here the first) or
        none of each value's rows. The rows keep their order either way."""
        if keep not in ("any", "first", "last", "none"):
            raise InvalidOperationError(f"unknown keep strategy {keep!r}")
        names = None
        if subset is not None:
            names = (subset,) if isinstance(subset, str) else tuple(subset)
        return self._wrap(L.LDistinct(self._node, names, keep, maintain_order))

    @staticmethod
    def _concat(frames: list[LazyFrame], how: str = "vertical") -> LazyFrame:
        if how in ("vertical", "vertical_relaxed"):
            return LazyFrame._from_node(L.LUnion(tuple(f._node for f in frames)))
        if how == "horizontal":
            return LazyFrame._from_node(L.LHConcat(tuple(f._node for f in frames)))
        raise NotImplementedError(f"concat how={how!r} is not ported yet (port queue: expression breadth)")

    def filter(self, *predicates: Any) -> LazyFrame:
        nodes = parse_into_expr_list(list(predicates))
        if not nodes:
            return self
        pred = nodes[0]
        for p in nodes[1:]:
            pred = E.EBinary(pred, "&", p)
        return self._wrap(L.LFilter(self._node, pred))

    def drop_nulls(self, subset: Any = None) -> LazyFrame:
        """The rows with no null in ``subset`` (a name or a list of names).
        Without a subset every column counts, which needs the wildcard
        ``col("*")`` of a later slice."""
        if subset is None:
            raise NotImplementedError(
                "drop_nulls() without a subset is not ported yet (port queue: expression breadth)")
        names = [subset] if isinstance(subset, str) else list(subset)
        return self.filter(*[E.EFunction("is_not_null", (E.EColumn(n),)) for n in names])

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
        """Join on predicates between the two sides: equalities make an
        inner join, the first inequality otherwise a range join; the other
        predicates filter its output."""
        preds = tuple(parse_into_expr_list(list(predicates)))
        return self._wrap(L.LJoinWhere(self._node, other._node, preds, suffix))

    def join_asof(
        self,
        other: LazyFrame,
        *,
        on: Any = None,
        left_on: Any = None,
        right_on: Any = None,
        by: Any = None,
        by_left: Any = None,
        by_right: Any = None,
        strategy: str = "backward",
        tolerance: Any = None,
        suffix: str = "_right",
    ) -> LazyFrame:
        """Each left row with the right row whose ``on`` key is nearest
        (``strategy`` backward, forward or nearest), within ``tolerance`` (a
        number, a duration string such as "1s" or a timedelta), among the
        rows of equal ``by`` keys; a null key matches nothing."""
        if strategy not in ("backward", "forward", "nearest"):
            raise InvalidOperationError(f"unknown asof strategy {strategy!r}")
        lo = parse_into_expr_list([on if on is not None else left_on])[0]
        ro = parse_into_expr_list([on if on is not None else right_on])[0]
        bl = tuple(parse_into_expr_list([by if by is not None else by_left])) if (by or by_left) else ()
        br = tuple(parse_into_expr_list([by if by is not None else by_right])) if (by or by_right) else ()
        return self._wrap(L.LAsofJoin(self._node, other._node, lo, ro, bl, br, strategy, tolerance, suffix))


class LazyGroupBy:
    __slots__ = ("_lf", "_keys", "_maintain_order")

    def __init__(self, lf: LazyFrame, keys: tuple[E.ENode, ...], maintain_order: bool) -> None:
        self._lf = lf
        self._keys = keys
        self._maintain_order = maintain_order

    def agg(self, *aggs: Any, **named_aggs: Any) -> LazyFrame:
        nodes = tuple(parse_into_expr_list(list(aggs), named_aggs))
        return self._lf._wrap(L.LGroupBy(self._lf._node, self._keys, nodes, self._maintain_order))

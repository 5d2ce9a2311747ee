"""LazyFrame: the lazy query builder (the port of
``polars_tpu/lazyframe.py``, trimmed to ``filter``/``remove``, ``select``,
``with_columns`` (and their ``_seq`` forms), ``group_by().agg``, ``sort``,
``top_k``/``bottom_k``, ``join`` (every ``how``), ``join_where``,
``join_asof``, ``slice``/``head``/``tail``/``limit``/``first``/``last``,
``reverse``, ``gather_every``, ``unique``, ``rename``, ``drop``, ``cast``,
``fill_null``/``fill_nan``, ``drop_nulls``/``drop_nans``,
``with_row_index``, ``clear``, ``pipe``, the frame aggregates, ``cache``,
``explain`` and ``collect``).

An expression with a wildcard, a selector or a ``name`` wrapper is expanded
against the input's schema as it enters the plan (``_exprs``), so the plan
holds plain columns and aliases.

``collect`` runs the optimized plan (``plan/optimizer``), as ``polars_tpu``
does; ``collect(no_optimization=True)`` runs the plan as written, and
``optimizations=QueryOptFlags(...)`` turns single passes off.
"""

from __future__ import annotations

from collections.abc import Callable, Mapping, Sequence
from typing import Any

from polars_tpu_torch import datatypes as dt
from polars_tpu_torch.core.frame import DataFrame, flatten_names
from polars_tpu_torch.core.schema import Schema
from polars_tpu_torch.errors import InvalidOperationError
from polars_tpu_torch.expr.expr import Expr, parse_into_expr, parse_into_expr_list
from polars_tpu_torch.plan import exprs as E
from polars_tpu_torch.plan import logical as L
from polars_tpu_torch.plan.schema_resolve import expand_exprs, needs_expansion, node_schema
from polars_tpu_torch.utils.tokens import next_token


def _and_all(nodes: list[E.ENode]) -> E.ENode:
    pred = nodes[0]
    for p in nodes[1:]:
        pred = E.EBinary(pred, "&", p)
    return pred


class LazyFrame:
    __slots__ = ("_node",)

    def __init__(self, data: Any = None, schema: Any = None, *, device=None, **kwargs: Any) -> None:
        """A lazy frame over ``DataFrame(data, schema, ...)``."""
        self._node = L.LDataFrameScan(df=DataFrame(data, schema, device=device, **kwargs), ident=next_token())

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

    def _exprs(self, nodes: list[E.ENode], schema: Schema | None = None) -> tuple[E.ENode, ...]:
        """``nodes`` with their wildcards, selectors and name wrappers
        expanded against ``schema`` (the frame's own by default)."""
        if not any(needs_expansion(n) for n in nodes):
            return tuple(nodes)
        return expand_exprs(tuple(nodes), self.schema if schema is None else schema)

    @property
    def schema(self) -> Schema:
        return node_schema(self._node)

    def collect_schema(self) -> Schema:
        return node_schema(self._node)

    @property
    def columns(self) -> list[str]:
        return self.schema.names()

    @property
    def width(self) -> int:
        return len(self.schema)

    @property
    def dtypes(self) -> list:
        return self.schema.dtypes()

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

    def filter(self, *predicates: Any, **constraints: Any) -> LazyFrame:
        """The rows where every predicate is true (``name=value`` tests a
        column's equality)."""
        nodes = list(self._exprs(parse_into_expr_list(list(predicates))))
        for name, value in constraints.items():
            nodes.append(E.EBinary(E.EColumn(name), "==", parse_into_expr(value, str_as_lit=True)))
        if not nodes:
            return self
        return self._wrap(L.LFilter(self._node, _and_all(nodes)))

    def remove(self, *predicates: Any, **constraints: Any) -> LazyFrame:
        """The rows where not every predicate is true."""
        nodes = list(self._exprs(parse_into_expr_list(list(predicates))))
        for name, value in constraints.items():
            nodes.append(E.EBinary(E.EColumn(name), "==", parse_into_expr(value, str_as_lit=True)))
        if not nodes:
            return self
        return self._wrap(L.LFilter(self._node, E.EFunction("not", (_and_all(nodes),))))

    def drop_nulls(self, subset: Any = None) -> LazyFrame:
        """The rows with no null in ``subset`` (a name or names; every column
        without one)."""
        names = self.columns if subset is None else flatten_names([subset])
        if not names:
            return self
        return self._wrap(L.LFilter(self._node, _and_all([E.EFunction("is_not_null", (E.EColumn(n),))
                                                          for n in names])))

    def drop_nans(self, subset: Any = None) -> LazyFrame:
        """The rows with no NaN in ``subset`` (every float column without
        one)."""
        if subset is None:
            names = [n for n, d in self.schema.items() if d.is_float()]
        else:
            names = flatten_names([subset])
        if not names:
            return self
        return self._wrap(L.LFilter(self._node, _and_all([E.EFunction("is_not_nan", (E.EColumn(n),))
                                                          for n in names])))

    def select(self, *exprs: Any, **named_exprs: Any) -> LazyFrame:
        nodes = self._exprs(parse_into_expr_list(list(exprs), named_exprs))
        if not nodes:  # no expression: an empty frame
            empty = DataFrame._from_columns([], 0, device=self._device())
            return self._wrap(L.LDataFrameScan(df=empty, ident=next_token()))
        return self._wrap(L.LSelect(self._node, nodes))

    def select_seq(self, *exprs: Any, **named_exprs: Any) -> LazyFrame:
        return self.select(*exprs, **named_exprs)

    def with_columns(self, *exprs: Any, **named_exprs: Any) -> LazyFrame:
        return self._wrap(L.LWithColumns(self._node, self._exprs(parse_into_expr_list(list(exprs), named_exprs))))

    def with_columns_seq(self, *exprs: Any, **named_exprs: Any) -> LazyFrame:
        return self.with_columns(*exprs, **named_exprs)

    def _device(self):
        """The device of the plan's first frame."""
        node = self._node
        while not isinstance(node, L.LDataFrameScan):
            node = node.inputs()[0]
        return node.df.device

    def cast(self, dtypes: Any, *, strict: bool = True) -> LazyFrame:
        """Columns cast by a mapping of names (or of dtypes, every column of
        that dtype) to dtypes, or every column to one dtype."""
        if isinstance(dtypes, Mapping):
            exprs = []
            for k, d in dtypes.items():
                e = Expr(E.EDtypeColumns((dt.parse_into_dtype(k),))) if not isinstance(k, str) else Expr(E.EColumn(k))
                exprs.append(e.cast(d, strict=strict))
            return self.with_columns(exprs)
        return self.select(Expr(E.EColumns(())).cast(dtypes, strict=strict))

    def fill_null(self, value: Any = None, strategy: str | None = None, limit: int | None = None) -> LazyFrame:
        """Nulls of every column replaced by ``value``."""
        return self.with_columns(Expr(E.EColumns(())).fill_null(value, strategy))

    def fill_nan(self, value: Any) -> LazyFrame:
        """NaNs of every float column replaced by ``value``."""
        return self.with_columns(Expr(E.EDtypeColumns((dt.Float64(), dt.Float32()))).fill_nan(value))

    def reverse(self) -> LazyFrame:
        """The rows in reverse order (a row index sorted descending)."""
        n = "__rev_idx"
        return self.with_row_index(n).sort(n, descending=True).drop(n)

    def gather_every(self, n: int, offset: int = 0) -> LazyFrame:
        """Every ``n``-th row from ``offset``."""
        idx = E.EColumn("__ge_idx")
        keep = E.EBinary(E.EBinary(E.EBinary(idx, "-", E.ELiteral(offset)), "%", E.ELiteral(n)), "==", E.ELiteral(0))
        pred = E.EBinary(keep, "&", E.EBinary(idx, ">=", E.ELiteral(offset)))
        return self._wrap(L.LFilter(self.with_row_index("__ge_idx")._node, pred)).drop("__ge_idx")

    def clear(self, n: int = 0) -> LazyFrame:
        """An empty frame of the same schema (``n`` rows of nulls)."""
        return DataFrame._empty(self.schema, n, self._device()).lazy()

    def pipe(self, function: Callable, *args: Any, **kwargs: Any):
        return function(self, *args, **kwargs)

    def fetch(self, n_rows: int = 500) -> DataFrame:
        return self.head(n_rows).collect()

    # -- frame aggregates -------------------------------------------------------

    def _agg_all(self, method: str, **kwargs: Any) -> LazyFrame:
        return self.select([getattr(Expr(E.EColumn(n)), method)(**kwargs) for n in self.columns])

    def sum(self) -> LazyFrame:
        return self._agg_all("sum")

    def mean(self) -> LazyFrame:
        return self._agg_all("mean")

    def min(self) -> LazyFrame:
        return self._agg_all("min")

    def max(self) -> LazyFrame:
        return self._agg_all("max")

    def median(self) -> LazyFrame:
        return self._agg_all("median")

    def std(self, ddof: int = 1) -> LazyFrame:
        return self._agg_all("std", ddof=ddof)

    def var(self, ddof: int = 1) -> LazyFrame:
        return self._agg_all("var", ddof=ddof)

    def quantile(self, quantile: float, interpolation: str = "nearest") -> LazyFrame:
        return self._agg_all("quantile", quantile=quantile, interpolation=interpolation)

    def count(self) -> LazyFrame:
        return self._agg_all("count")

    def null_count(self) -> LazyFrame:
        return self._agg_all("null_count")

    def sort(
        self,
        by: Any,
        *more_by: Any,
        descending: bool | Sequence[bool] = False,
        nulls_last: bool | Sequence[bool] = False,
        maintain_order: bool = False,
    ) -> LazyFrame:
        by_nodes = self._exprs(parse_into_expr_list([by, *more_by]))
        k = len(by_nodes)
        desc = tuple(descending) if isinstance(descending, (list, tuple)) else (descending,) * k
        nl = tuple(nulls_last) if isinstance(nulls_last, (list, tuple)) else (nulls_last,) * k
        return self._wrap(L.LSort(self._node, by_nodes, desc, nl, maintain_order))

    def top_k(self, k: int, *, by: Any, reverse: Any = False) -> LazyFrame:
        """The ``k`` rows of the largest ``by`` (smallest with ``reverse``),
        nulls last."""
        return self._k_rows(k, by, reverse, largest=True)

    def bottom_k(self, k: int, *, by: Any, reverse: Any = False) -> LazyFrame:
        """The ``k`` rows of the smallest ``by`` (largest with ``reverse``),
        nulls last."""
        return self._k_rows(k, by, reverse, largest=False)

    def _k_rows(self, k: int, by: Any, reverse: Any, *, largest: bool) -> LazyFrame:
        by_nodes = self._exprs(parse_into_expr_list([by]))
        rev = tuple(reverse) if isinstance(reverse, (list, tuple)) else (reverse,) * len(by_nodes)
        desc = tuple(r != largest for r in rev)
        return self._wrap(L.LSort(self._node, by_nodes, desc, (True,) * len(by_nodes), False, k))

    def group_by(self, *by: Any, maintain_order: bool = False, **named_by: Any) -> LazyGroupBy:
        keys = self._exprs(parse_into_expr_list(list(by), named_by))
        return LazyGroupBy(self, keys, maintain_order)

    def slice(self, offset: int, length: int | None = None) -> LazyFrame:
        return self._wrap(L.LSlice(self._node, offset, length))

    def head(self, n: int = 5) -> LazyFrame:
        return self.slice(0, n)

    def tail(self, n: int = 5) -> LazyFrame:
        return self.slice(-n, n)

    def limit(self, n: int = 5) -> LazyFrame:
        return self.head(n)

    def first(self) -> LazyFrame:
        return self.head(1)

    def last(self) -> LazyFrame:
        return self.tail(1)

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
        """One row per group; a wildcard or selector matches the columns
        other than the keys, as in Polars."""
        nodes = parse_into_expr_list(list(aggs), named_aggs)
        keys = {E.output_name(k) for k in self._keys}
        schema = Schema([(n, d) for n, d in self._lf.schema.items() if n not in keys]) if any(
            needs_expansion(n) for n in nodes) else None
        return self._lf._wrap(L.LGroupBy(self._lf._node, self._keys, self._lf._exprs(nodes, schema),
                                         self._maintain_order))

    def _agg_all(self, method: str, **kwargs: Any) -> LazyFrame:
        return self.agg(getattr(Expr(E.EColumns(())), method)(**kwargs))

    def sum(self) -> LazyFrame:
        return self._agg_all("sum")

    def mean(self) -> LazyFrame:
        return self._agg_all("mean")

    def min(self) -> LazyFrame:
        return self._agg_all("min")

    def max(self) -> LazyFrame:
        return self._agg_all("max")

    def median(self) -> LazyFrame:
        return self._agg_all("median")

    def first(self) -> LazyFrame:
        return self._agg_all("first")

    def last(self) -> LazyFrame:
        return self._agg_all("last")

    def n_unique(self) -> LazyFrame:
        return self._agg_all("n_unique")

    def len(self, name: str = "len") -> LazyFrame:
        return self.agg(E.EAlias(E.ELen(), name))

    def head(self, n: int = 5) -> LazyFrame:
        """The first ``n`` rows of each group, in row order (a window's
        running count over the keys)."""
        return self._lf.filter(self._position(reverse=False) <= n)

    def tail(self, n: int = 5) -> LazyFrame:
        """The last ``n`` rows of each group, in row order."""
        return self._lf.filter(self._position(reverse=True) <= n)

    def _position(self, *, reverse: bool) -> Expr:
        from polars_tpu_torch.functions.lazy import lit

        return lit(True).cum_count(reverse=reverse).over([Expr(k) for k in self._keys])

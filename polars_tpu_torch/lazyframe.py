"""LazyFrame: the lazy query builder (the port of
``polars_tpu/lazyframe.py``, trimmed to ``filter``/``remove``, ``select``,
``with_columns`` (and their ``_seq`` forms), ``group_by().agg``, ``sort``,
``top_k``/``bottom_k``, ``join`` (every ``how``), ``join_where``,
``join_asof``, ``slice``/``head``/``tail``/``limit``/``first``/``last``,
``reverse``, ``gather_every``, ``unique``, ``rename``, ``drop``, ``cast``,
``fill_null``/``fill_nan``, ``drop_nulls``/``drop_nans``,
``with_row_index``, ``clear``, ``pipe``, the frame aggregates, ``cache``,
``explain``, ``collect``, and the dynamic and rolling group-bys,
``group_by_dynamic`` and ``rolling``).

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


def flatten_names_or_exprs(items: Any) -> list:
    """Names and expressions from nested lists and tuples of them."""
    out: list = []
    for it in items:
        out.extend(flatten_names_or_exprs(it) if isinstance(it, (list, tuple)) else [it])
    return out


def _and_all(nodes: list[E.ENode]) -> E.ENode:
    pred = nodes[0]
    for p in nodes[1:]:
        pred = E.EBinary(pred, "&", p)
    return pred


def _modes_as_rows(nodes: tuple[E.ENode, ...]) -> tuple[E.ENode, ...]:
    """A select's ``mode()`` is a column of the modes (the aggregation's one
    List, exploded), as in Polars; in a group-by it stays a List per group."""
    def fix(e: E.ENode) -> E.ENode:
        if isinstance(e, E.EAlias):
            inner = fix(e.input)
            return e if inner is e.input else E.EAlias(inner, e.name)
        if isinstance(e, E.EAgg) and e.kind == "mode":
            return E.EFunction("explode", (e,))
        return e

    return tuple(fix(e) for e in nodes)


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

    def _names_of(self, items: Any) -> list[str]:
        """Column names from names, expressions and selectors."""
        names = []
        for it in flatten_names_or_exprs(items):
            if isinstance(it, str):
                names.append(it)
            else:
                names.extend(E.output_name(n) for n in self._exprs([parse_into_expr(it)._node]))
        return names

    def explode(self, columns: Any, *more_columns: Any) -> LazyFrame:
        """Each row once per element of its lists in ``columns`` (the lists
        of a row have one length), those columns holding the elements; a
        null or empty list gives one row with a null."""
        return self._wrap(L.LExplode(self._node, tuple(self._names_of((columns, *more_columns)))))

    def unnest(self, columns: Any, *more_columns: Any) -> LazyFrame:
        """Each Struct column of ``columns`` replaced, in its place, by one
        column per field."""
        from polars_tpu_torch.functions.lazy import col

        names = set(self._names_of((columns, *more_columns)))
        exprs = []
        for n, d in self.schema.items():
            if n in names:
                if not isinstance(d, dt.Struct):
                    raise InvalidOperationError(f"unnest needs a Struct column, {n!r} is {d!r}")
                exprs.extend(col(n).struct.field(f.name) for f in d.fields)
            else:
                exprs.append(col(n))
        return self.select(exprs)

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
        """One plan of the frames: ``vertical``/``vertical_relaxed`` (each
        column in the supertype of its pieces), ``diagonal`` (the union of
        the columns in order of first appearance, a column a frame lacks
        null; equal dtypes, or their supertype with ``diagonal_relaxed``),
        ``horizontal`` (side by side) or ``align``/``align_full``/
        ``align_left``/``align_right`` (joined on their common columns,
        coalesced, sorted by them)."""
        from polars_tpu_torch.functions.lazy import col, lit

        if how in ("vertical", "vertical_relaxed"):
            return LazyFrame._from_node(L.LUnion(tuple(f._node for f in frames)))
        if how == "horizontal":
            return LazyFrame._from_node(L.LHConcat(tuple(f._node for f in frames)))
        if how in ("diagonal", "diagonal_relaxed"):
            from polars_tpu_torch.errors import SchemaError
            from polars_tpu_torch.plan.schema_resolve import supertype

            schemas = [f.collect_schema() for f in frames]
            dtypes: dict[str, Any] = {}
            for s in schemas:
                for n, d in s.items():
                    if n in dtypes and dtypes[n] != d:
                        if how == "diagonal":
                            raise SchemaError(f"type {d!r} of column {n!r} differs from {dtypes[n]!r} in a "
                                              "diagonal concat")
                        d = supertype(dtypes[n], d)
                    dtypes[n] = d
            parts = [f.select([(col(n) if s.get(n) == d else col(n).cast(d)) if n in s
                               else lit(None).cast(d).alias(n) for n, d in dtypes.items()])
                     for f, s in zip(frames, schemas)]
            return LazyFrame._from_node(L.LUnion(tuple(p._node for p in parts)))
        if how in ("align", "align_full", "align_left", "align_right", "align_inner"):
            names = [f.collect_schema().names() for f in frames]
            common = [n for n in names[0] if all(n in other for other in names[1:])]
            if not common:
                raise InvalidOperationError("'align' strategy requires at least one common column")
            join_how = "full" if how in ("align", "align_full") else how.split("_")[1]
            out = frames[0]
            for f in frames[1:]:
                out = out.join(f, on=common, how=join_how, coalesce=True)
            return out.sort(common)
        raise InvalidOperationError(f"unknown concat strategy {how!r}")

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
        nodes = _modes_as_rows(self._exprs(parse_into_expr_list(list(exprs), named_exprs)))
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
        """The device of the plan's first frame (a file scan reads onto the
        default device)."""
        node = self._node
        while not isinstance(node, (L.LDataFrameScan, L.LScan)):
            node = node.inputs()[0]
        if isinstance(node, L.LScan):
            from polars_tpu_torch.config import resolve_device

            return resolve_device(None)
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

    def show(self, limit: int | None = 5, **kwargs: Any) -> None:
        print(self.limit(limit).collect() if limit is not None else self.collect())

    def clone(self) -> LazyFrame:
        return LazyFrame._from_node(self._node)

    def with_column(self, expr: Any) -> LazyFrame:
        return self.with_columns(expr)

    def with_row_count(self, name: str = "row_nr", offset: int = 0) -> LazyFrame:
        return self.with_row_index(name, offset)

    def set_sorted(self, column: Any, *more_columns: Any, descending: bool = False) -> LazyFrame:
        """The frame (a sortedness hint, which this engine does not use)."""
        return self

    def shift(self, n: int = 1, *, fill_value: Any = None) -> LazyFrame:
        from polars_tpu_torch.functions.lazy import all as pl_all

        return self.select(pl_all().shift(n, fill_value=fill_value))

    def interpolate(self) -> LazyFrame:
        from polars_tpu_torch.functions.lazy import all as pl_all

        return self.select(pl_all().interpolate())

    def approx_n_unique(self) -> LazyFrame:
        """Each column's distinct count (exact here)."""
        from polars_tpu_torch.functions.lazy import all as pl_all

        return self.select(pl_all().n_unique())

    def gather(self, indices: Any) -> LazyFrame:
        """The rows at ``indices`` (a gather of every column)."""
        from polars_tpu_torch.functions.lazy import all as pl_all

        idx = indices.to_list() if hasattr(indices, "to_list") else list(indices)
        return self.select(pl_all().gather(idx))

    def describe(self, percentiles: Any = (0.25, 0.5, 0.75)) -> DataFrame:
        return self.collect().describe()

    def collect_batches(self, *, chunk_size: int | None = None, maintain_order: bool = True, **kwargs: Any):
        """The result in frames of ``chunk_size`` rows (collected once; the
        streaming engine is ROADMAP item 6)."""
        out = self.collect()
        step = chunk_size or max(out.height, 1)
        return iter([out.slice(off, step) for off in range(0, out.height, step)] or [out])

    def collect_async(self, **kwargs: Any):
        """A future of ``collect`` run on a worker thread."""
        import concurrent.futures

        pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        future = pool.submit(self.collect, **kwargs)
        pool.shutdown(wait=False)
        return future

    def update(self, other: LazyFrame, on: Any = None, how: str = "left", *, left_on: Any = None,
               right_on: Any = None, include_nulls: bool = False) -> LazyFrame:
        """The rows' values overwritten by ``other``'s where the ``on`` keys
        match (its nulls kept out unless ``include_nulls``): a join on the
        keys and a when/then per column."""
        from polars_tpu_torch.functions.lazy import col, lit, when

        if on is None and left_on is None:
            on = [c for c in self.columns if c in set(other.columns)]
        if left_on is not None:
            other = other.rename(dict(zip(flatten_names([right_on]), flatten_names([left_on]))))
            on = left_on
        keys = flatten_names([on])
        upd = [c for c in other.columns if c not in keys and c in self.columns]
        marked = other.select(*keys, *upd).with_columns(lit(True).alias("__upd_hit"))
        joined = self.join(marked, on=keys, how=how, suffix="__upd", coalesce=True)
        hit = col("__upd_hit").fill_null(False)
        exprs = []
        for c in upd:
            u = col(c + "__upd")
            cond = hit if include_nulls else hit & u.is_not_null()
            exprs.append(when(cond).then(u).otherwise(col(c)).alias(c))
        return joined.with_columns(exprs).drop(["__upd_hit"] + [c + "__upd" for c in upd])

    def merge_sorted(self, other: LazyFrame, key: str) -> LazyFrame:
        """Two frames sorted by ``key`` as one sorted frame (a concat and a
        stable sort)."""
        return LazyFrame._concat([self, other]).sort(key, maintain_order=True)

    def match_to_schema(self, schema: Any, *, missing_columns: Any = "raise", missing_struct_fields: Any = "raise",
                        extra_columns: str = "raise", extra_struct_fields: Any = "raise", integer_cast: Any = "forbid",
                        float_cast: Any = "forbid") -> LazyFrame:
        """The frame in ``schema``'s columns and order: a missing column
        inserted as nulls (``missing_columns="insert"``) or an error, an
        extra one an error (or dropped with ``"ignore"``), an integer or
        float column upcast where the policy says ``"upcast"``."""
        from polars_tpu_torch.errors import SchemaError
        from polars_tpu_torch.functions.lazy import col, lit

        target = {k: dt.parse_into_dtype(v) for k, v in dict(schema.items() if hasattr(schema, "items")
                                                             else schema).items()}
        cur = self.collect_schema()
        extra = [n for n in cur.names() if n not in target]
        if extra and extra_columns == "raise":
            raise SchemaError(f"extra columns in `match_to_schema`: {extra}")

        def policy(rules: Any, name: str) -> Any:
            return rules if isinstance(rules, (str, Expr)) else rules.get(name, "raise")

        exprs = []
        for name, d in target.items():
            if name not in cur:
                rule = policy(missing_columns, name)
                if rule == "insert":
                    exprs.append(lit(None).cast(d).alias(name))
                elif isinstance(rule, Expr):
                    exprs.append(rule.cast(d).alias(name))
                else:
                    raise SchemaError(f"missing column in `match_to_schema`: {name!r}")
            elif cur[name] == d:
                exprs.append(col(name))
            elif (cur[name].is_integer() and d.is_integer() and policy(integer_cast, name) == "upcast") or \
                    (cur[name].is_float() and d.is_float() and policy(float_cast, name) == "upcast"):
                exprs.append(col(name).cast(d))
            else:
                raise SchemaError(f"type mismatch for column {name!r} in `match_to_schema`: expected {d!r}, "
                                  f"got {cur[name]!r}")
        return self.select(exprs)

    def pipe_with_schema(self, function: Callable) -> LazyFrame:
        """``function(self, schema)``: a rewrite that reads the resolved
        schema (which resolves without running the plan)."""
        return function(self, self.collect_schema())

    def map_batches(self, function: Callable, *, schema: Any = None, validate_output_schema: bool = True,
                    streamable: bool = False, **kwargs: Any) -> LazyFrame:
        """``function`` of the collected input (a DataFrame on its device), a
        barrier no predicate, projection or slice crosses; ``schema`` is its
        output's (the input's when None, as Polars assumes), and with
        ``validate_output_schema`` an output of another schema raises
        ``SchemaError``."""
        schema_fn = None
        if schema is not None:
            out = Schema(schema) if not isinstance(schema, Schema) else schema
            schema_fn = lambda _in: out  # noqa: E731
        return self._wrap(L.LMapFunction(self._node, function=function, ident=next_token(), schema_fn=schema_fn,
                                         validate=validate_output_schema))

    def inspect(self, fmt: str = "{}") -> LazyFrame:
        """The frame unchanged, printed as it passes."""
        def show(df):
            print(fmt.format(df))
            return df

        return self.map_batches(show)

    def unpivot(self, on: Any = None, *, index: Any = None, variable_name: str = "variable",
                value_name: str = "value") -> LazyFrame:
        """Wide to long: ``index`` repeated once per ``on`` column (every
        other column when None); ``variable_name`` names the column,
        ``value_name`` holds its value."""
        on_t = None if on is None else tuple(self._names_of([on]))
        idx_t = () if index is None else tuple(self._names_of([index]))
        return self._wrap(L.LUnpivot(self._node, on_t, idx_t, variable_name, value_name))

    def melt(self, id_vars: Any = None, value_vars: Any = None, variable_name: str = "variable",
             value_name: str = "value") -> LazyFrame:
        return self.unpivot(value_vars, index=id_vars, variable_name=variable_name, value_name=value_name)

    def pivot(self, on: Any, *, index: Any = None, values: Any = None, aggregate_function: Any = None,
              maintain_order: bool = True, sort_columns: bool = False, separator: str = "_") -> LazyFrame:
        """``DataFrame.pivot`` of the collected input: the output's columns
        are the data's ``on`` values, so the plan collects at this node."""
        return self.collect().pivot(on, index=index, values=values, aggregate_function=aggregate_function,
                                    maintain_order=maintain_order, sort_columns=sort_columns,
                                    separator=separator).lazy()

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

    def group_by_dynamic(self, index_column: Any, *, every: str, period: str | None = None, offset: str | None = None,
                         include_boundaries: bool = False, closed: str = "left", label: str = "left",
                         group_by: Any = None, start_by: str = "window") -> LazyGroupByDynamic:
        """Windows of time (or of an integer index) every ``every``, each
        ``period`` long, per group of ``group_by`` (reference: polars-time
        group_by_dynamic). It lowers to the window's start computed per row
        and a group-by of it; overlapping windows (``period`` longer than
        ``every``) stack ceil(period / every) shifted copies of the rows,
        each filtered to its windows, in one lazy concat."""
        name = E.output_name(parse_into_expr(index_column))
        if not name:
            raise InvalidOperationError("group_by_dynamic needs a named index column")
        gb: tuple = ()
        if group_by is not None:
            gb = tuple(parse_into_expr_list(list(group_by) if isinstance(group_by, (list, tuple)) else [group_by]))
        return LazyGroupByDynamic(self, name, every, period, offset, include_boundaries, closed, label, gb, start_by)

    def rolling(self, index_column: Any, *, period: str, offset: str | None = None, closed: str = "right",
                group_by: Any = None) -> LazyRolling:
        """One window per row, ``(t + offset, t + offset + period]`` (``offset``
        -period by default), per group of ``group_by`` (reference:
        polars-time rolling); ``engine/rolling.rolling_frames`` aggregates
        them."""
        name = E.output_name(parse_into_expr(index_column))
        if not name:
            raise InvalidOperationError("rolling needs a named index column")
        gb = list(group_by) if isinstance(group_by, (list, tuple)) else ([group_by] if group_by is not None else [])
        return LazyRolling(self, name, period, offset, closed,
                           [g if isinstance(g, str) else E.output_name(parse_into_expr(g)) for g in gb])

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


class LazyGroupByDynamic:
    """What ``LazyFrame.group_by_dynamic`` returns (the JAX package's
    ``LazyGroupByDynamic``)."""

    __slots__ = ("_lf", "_index", "_every", "_period", "_offset", "_boundaries", "_closed", "_label", "_group_by",
                 "_start_by")

    def __init__(self, lf, index, every, period, offset, boundaries, closed, label, group_by, start_by) -> None:
        self._lf, self._index, self._every, self._period, self._offset = lf, index, every, period, offset
        self._boundaries, self._closed, self._label, self._group_by = boundaries, closed, label, group_by
        self._start_by = start_by

    def agg(self, *aggs: Any, **named_aggs: Any) -> LazyFrame:
        """A calendar ``every`` (``mo``, ``q``, ``y``) truncates the index to
        tumbling left-closed windows; a fixed one computes each row's window
        start from the grid of ``every`` (from ``offset``, or from the first
        row with ``start_by="datapoint"``), no window before the first row's
        slot. The result is sorted by the groups and the window."""
        import math
        import re

        from polars_tpu_torch.engine.rolling import interval_ticks
        from polars_tpu_torch.functions.lazy import col, lit

        agg_nodes = list(parse_into_expr_list(list(aggs), named_aggs))
        name, every = self._index, self._every
        idx_dtype = self._lf.collect_schema()[name]
        gb_names = [E.output_name(k) for k in self._group_by]
        ws_name = "__dyn_ws"
        calendar = bool(re.search(r"\d+(mo|q|y)", every))
        if calendar:
            if self._period not in (None, every) or self._offset or self._start_by != "window" or \
                    self._closed != "left":
                raise InvalidOperationError(
                    "calendar intervals support only tumbling left-closed windows from the epoch grid")
            lf = self._lf.with_columns(col(name).dt.truncate(every).alias(ws_name))
            upper = col(ws_name).dt.offset_by(every)
        else:
            ev = interval_ticks(every, idx_dtype)
            per = interval_ticks(self._period, idx_dtype) if self._period else ev
            t = col(name).cast(dt.Int64())
            if self._start_by == "datapoint":
                off = t.min()
            elif self._offset:
                sign = -1 if self._offset.startswith("-") else 1
                off = lit(sign * interval_ticks(self._offset.lstrip("-"), idx_dtype), dtype=dt.Int64())
            else:
                off = lit(0, dtype=dt.Int64())
            shifted = t - off
            min_shift = t.min() - off
            if self._closed == "right":
                base = ((shifted - 1) // ev) * ev
                first_ws = ((min_shift - 1) // ev) * ev

                def in_win(ws_e):
                    return (shifted > ws_e) & (shifted <= ws_e + per)
            else:
                base = (shifted // ev) * ev
                first_ws = (min_shift // ev) * ev

                def in_win(ws_e):
                    return (shifted >= ws_e) & (shifted < ws_e + per)
            frames = []
            for r in range(max(1, math.ceil(per / ev))):
                ws_e = base - r * ev
                fr = self._lf.with_columns((ws_e + off).cast(dt.Int64()).alias(ws_name))
                if not (r == 0 and per == ev):  # no window before the first row's slot
                    fr = fr.filter(in_win(ws_e) & (ws_e >= first_ws))
                frames.append(fr)
            lf = frames[0] if len(frames) == 1 else LazyFrame._concat(frames, "vertical")
            upper = (col(ws_name) + per).cast(idx_dtype)
        full_aggs = list(agg_nodes)
        if self._label == "datapoint":
            full_aggs.insert(0, col(name).first().alias("__dyn_label"))
        out = lf.group_by(*gb_names, col(ws_name)).agg(*full_aggs).sort([*gb_names, ws_name])
        ws_col = col(ws_name) if calendar else col(ws_name).cast(idx_dtype)
        posts = []
        if self._label == "left":
            posts.append(ws_col.alias(name))
        elif self._label == "right":
            right = col(ws_name).dt.offset_by(every) if calendar else (col(ws_name) + ev).cast(idx_dtype)
            posts.append(right.alias(name))
        elif self._label == "datapoint":
            posts.append(col("__dyn_label").alias(name))
        if self._boundaries:
            posts += [ws_col.alias("_lower_boundary"), upper.alias("_upper_boundary")]
        out = out.with_columns(posts)
        order = [*gb_names] + (["_lower_boundary", "_upper_boundary"] if self._boundaries else []) + [name]
        order += [n for n in out.collect_schema().names() if n not in (*order, ws_name, "__dyn_label")]
        return out.select(order)


class LazyRolling:
    """What ``LazyFrame.rolling`` returns: column aggregations (sum,
    mean, count, len, min, max, first, last, var, std) over each row's
    window (the JAX package's ``LazyRolling``)."""

    __slots__ = ("_lf", "_index", "_period", "_offset", "_closed", "_gb")

    def __init__(self, lf, index, period, offset, closed, gb) -> None:
        self._lf, self._index, self._period, self._offset, self._closed, self._gb = lf, index, period, offset, \
            closed, gb

    def agg(self, *aggs: Any, **named_aggs: Any) -> LazyFrame:
        """Collects the input, then ``engine/rolling.rolling_frames``."""
        from polars_tpu_torch.engine.rolling import interval_ticks, rolling_frames
        from polars_tpu_torch.plan.schema_resolve import expr_dtype

        nodes = parse_into_expr_list(list(aggs), named_aggs)
        df = self._lf.collect()
        schema = df.schema
        idx_dt = schema[self._index]
        per = interval_ticks(self._period, idx_dt)
        if self._offset is None:
            off = -per
        else:
            off = (-1 if self._offset.startswith("-") else 1) * interval_ticks(self._offset.lstrip("-"), idx_dt)
        specs = []
        for node in nodes:
            out_name = E.output_name(node)
            inner = node
            while isinstance(inner, E.EAlias):
                inner = inner.input
            if isinstance(inner, E.EAgg) and isinstance(inner.input, E.EColumn):
                src, kind = inner.input.name, inner.kind
            elif isinstance(inner, E.ELen):
                src, kind, out_name = self._index, "len", out_name or "len"
            else:
                raise InvalidOperationError("rolling().agg supports simple column aggregations "
                                            "(sum/mean/count/len/min/max/first/last/var/std)")
            if kind in ("count", "len"):
                out_dt = dt.UInt32()
            elif kind in ("first", "last", "min", "max"):
                out_dt = schema[src]
            elif kind == "sum":
                out_dt = expr_dtype(E.EAgg(E.EColumn(src), "sum"), schema)
            else:
                out_dt = dt.Float64()
            specs.append((src, kind, out_name, out_dt, 1, inner.opt("ddof", 1) if isinstance(inner, E.EAgg) else 1))
        return rolling_frames(df, self._index, per, off, self._closed, self._gb, specs).lazy()

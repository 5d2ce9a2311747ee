"""Plan execution entry (the port of ``polars_tpu/engine/run.py``'s
``execute_plan``, ``_execute_node``, ``_exec_join``, ``_exec_join_where``,
``_and_all`` and ``_exec_asof``, and its ``plan_cache_scope``, for in-memory
and file scans (``io/scan_exec.py``), fused segments, host-sized joins, range joins, asof joins, common
subplans and selects that call a host function (``engine/hostops.py``);
every other node kind belongs to a later slice).

A segment's leaves are the nearest non-fusable nodes below it, each run once
(a frame joined with itself is one leaf), on both sides of every join. A join
that sizes its output on the host (``engine/join.py``) runs both inputs as
leaves, and its output is a leaf of the segment above it. A common subplan
(``LCache``) is a leaf too; it runs once per collect, whichever segment
reads it first, and the others read that frame."""

from __future__ import annotations

import contextlib

from polars_tpu_torch.core.frame import DataFrame
from polars_tpu_torch.engine.executors import _is_fusable, run_segment
# a select that calls a host function: a barrier between segments (under
# the JAX package's name, which is looked up at each call)
from polars_tpu_torch.engine.hostops import exec_host_select as _exec_special_select
from polars_tpu_torch.plan import exprs as E
from polars_tpu_torch.plan import logical as L
from polars_tpu_torch.plan.schema_resolve import node_schema

# one memo per collect: LCache node (structural key) -> its frame
_PLAN_CACHES: list[dict] = []


@contextlib.contextmanager
def plan_cache_scope():
    """The memo of one collect's common subplans (``LCache``): each runs
    once, and the memo, with its frames, goes when the collect ends."""
    _PLAN_CACHES.append({})
    try:
        yield
    finally:
        _PLAN_CACHES.pop()


def execute_plan(node: L.LNode) -> DataFrame:
    return _execute_node(node)


def _execute_node(node: L.LNode) -> DataFrame:
    if isinstance(node, L.LCache):
        cache = _PLAN_CACHES[-1] if _PLAN_CACHES else {}
        out = cache.get(node)
        if out is None:
            out = cache[node] = execute_plan(node.input)
        return out

    if isinstance(node, L.LDataFrameScan):
        df = node.df
        if node.projection is not None:
            df = DataFrame._from_columns([df._get(n) for n in node.projection], df.height, device=df.device)
        return df

    if isinstance(node, L.LScan):
        from polars_tpu_torch.io.scan_exec import execute_scan

        return execute_scan(node)

    if _is_fusable(node):
        leaves: list[tuple[L.LNode, DataFrame]] = []
        seen: set[int] = set()

        def collect(n: L.LNode) -> None:
            for i in n.inputs():
                if _is_fusable(i):
                    collect(i)
                elif id(i) not in seen:
                    seen.add(id(i))
                    leaves.append((i, execute_plan(i)))

        collect(node)
        return run_segment(node, leaves)

    if isinstance(node, L.LJoin):
        return _exec_join(node)
    if isinstance(node, L.LJoinWhere):
        return _exec_join_where(node)
    if isinstance(node, L.LAsofJoin):
        return _exec_asof(node)
    if isinstance(node, (L.LSelect, L.LWithColumns)):
        return _exec_special_select(node)
    if isinstance(node, L.LGroupBy):
        from polars_tpu_torch.engine.hostops import exec_host_groupby
        from polars_tpu_torch.engine.udf import exec_groupby_udf, has_udf

        return exec_groupby_udf(node) if has_udf(node) else exec_host_groupby(node)
    if isinstance(node, L.LUnpivot):
        from polars_tpu_torch.engine.reshape import unpivot_frame
        from polars_tpu_torch.plan.schema_resolve import unpivot_columns

        df = execute_plan(node.input)
        on, index = unpivot_columns(node, df.schema)
        return unpivot_frame(df, on, index, node.variable_name, node.value_name)
    if isinstance(node, L.LMapFunction):
        from polars_tpu_torch.engine.udf import map_frame
        from polars_tpu_torch.plan.schema_resolve import node_schema

        return map_frame(node.function, execute_plan(node.input), node_schema(node) if node.validate else None)
    raise NotImplementedError(f"executing {type(node).__name__} is not ported yet")


def _exec_join(node: L.LJoin) -> DataFrame:
    """A host-sized join: both inputs run as leaves; key expressions other
    than plain columns are evaluated by a one-select segment over the leaf
    (its K2 count is one more host read) and joined on as ``__join_key_i``
    columns, which the output drops."""
    from polars_tpu_torch.engine.join import join_frames

    def key_names(df: DataFrame, on: tuple[E.ENode, ...]) -> tuple[DataFrame, list[str]]:
        names = [e.name if isinstance(e, E.EColumn) else f"__join_key_{i}" for i, e in enumerate(on)]
        exprs = tuple(E.EAlias(e, n) for e, n in zip(on, names) if not isinstance(e, E.EColumn))
        if exprs:
            scan = L.LDataFrameScan(df=df, ident=0)
            keys = run_segment(L.LSelect(scan, exprs), [(scan, df)])
            df = DataFrame._from_columns(list(df._columns) + list(keys._columns), df.height, device=df.device)
        return df, names

    left, lnames = key_names(execute_plan(node.input_left), node.left_on)
    right, rnames = key_names(execute_plan(node.input_right), node.right_on)
    out = join_frames(left, right, lnames, rnames, node.how, node.suffix, node.nulls_equal, node.coalesce,
                      node.validate)
    drop = [n for n in out.columns if n.startswith("__join_key_")]
    return out.drop(*drop) if drop else out


def _eval_generator(df: DataFrame, e: E.ENode, schema=None):
    """The column of a host function over ``df`` (``engine/hostops.py``):
    the one way in for every expression that runs on the host between
    segments."""
    from polars_tpu_torch.engine.hostops import host_call

    return host_call(df, e)


def _scan(df: DataFrame) -> L.LDataFrameScan:
    return L.LDataFrameScan(df=df, ident=0)


def _eval_column(df: DataFrame, e: E.ENode):
    """The column an expression gives over ``df``: a column reference is
    the column itself, anything else a one-select segment (one K2 pass and
    its read)."""
    if isinstance(e, E.EColumn):
        return df._get(e.name)
    scan = _scan(df)
    select = L.LSelect(scan, (E.EAlias(e, "__key"),))
    if E.needs_host(e):  # a host function inside: its own barrier first
        return _exec_special_select(select)._get("__key")
    return run_segment(select, [(scan, df)])._get("__key")


def _and_all(preds: tuple[E.ENode, ...]) -> E.ENode:
    node = preds[0]
    for p in preds[1:]:
        node = E.EBinary(node, "&", p)
    return node


def _exec_join_where(node: L.LJoinWhere) -> DataFrame:
    """Equalities between the two sides make an inner join; otherwise the
    first inequality between them drives a range join
    (``join.range_join_frames``), and a cross join where there is none or
    its keys cannot be ordered. The other predicates filter the output as
    one ordinary filter segment (K2 compacts it), a right column the output
    renamed with ``suffix`` read under its new name."""
    from polars_tpu_torch.engine.join import _FLIP_OP, range_join_frames

    lnames = set(node_schema(node.input_left).names())
    rnames = set(node_schema(node.input_right).names())

    def side(e: E.ENode) -> str:
        names = {n.name for n in E.walk(e) if isinstance(n, E.EColumn)}
        if names and names <= lnames and not names & rnames:
            return "left"
        if names and names <= rnames and not names & lnames:
            return "right"
        return "mixed"

    def between(pred: E.ENode, ops) -> tuple[E.ENode, str, E.ENode] | None:
        """(left operand, op as left <op> right, right operand) of a
        comparison of one side with the other."""
        if not (isinstance(pred, E.EBinary) and pred.op in ops):
            return None
        sides = side(pred.left), side(pred.right)
        if sides == ("left", "right"):
            return pred.left, pred.op, pred.right
        if sides == ("right", "left"):
            return pred.right, _FLIP_OP.get(pred.op, pred.op), pred.left
        return None

    def filter_rest(out: DataFrame, preds: list[E.ENode]) -> DataFrame:
        if not preds:
            return out
        cols = set(out.columns)

        def fix(c: E.EColumn) -> E.EColumn:
            return c if c.name in lnames or c.name in cols else E.EColumn(c.name + node.suffix)

        scan = _scan(out)
        return run_segment(L.LFilter(scan, _and_all(tuple(E.map_columns(p, fix) for p in preds))), [(scan, out)])

    equi = [between(p, ("==",)) for p in node.predicates]
    if any(equi):
        join = L.LJoin(node.input_left, node.input_right, tuple(q[0] for q in equi if q),
                       tuple(q[2] for q in equi if q), "inner", node.suffix, False, False)
        return filter_rest(execute_plan(join), [p for p, q in zip(node.predicates, equi) if not q])

    left, right = execute_plan(node.input_left), execute_plan(node.input_right)
    for i, p in enumerate(node.predicates):
        ineq = between(p, tuple(_FLIP_OP))
        if ineq is None:
            continue
        lexpr, op, rexpr = ineq
        out = range_join_frames(left, right, _eval_column(left, lexpr), _eval_column(right, rexpr), op, node.suffix)
        if out is not None:
            return filter_rest(out, [q for j, q in enumerate(node.predicates) if j != i])
        break
    cross = L.LJoin(_scan(left), _scan(right), (), (), "cross", node.suffix)
    return filter_rest(_exec_join(cross), list(node.predicates))


def _exec_asof(node: L.LAsofJoin) -> DataFrame:
    from polars_tpu_torch.engine.join import asof_join_frames

    by_l = [E.output_name(e) for e in node.by_left] or None
    by_r = [E.output_name(e) for e in node.by_right] or None
    return asof_join_frames(execute_plan(node.input_left), execute_plan(node.input_right),
                            E.output_name(node.left_on), E.output_name(node.right_on), node.strategy, node.suffix,
                            node.tolerance, by_l, by_r)

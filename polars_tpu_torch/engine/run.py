"""Plan execution entry (the port of ``polars_tpu/engine/run.py``'s
``execute_plan``, ``_execute_node`` and ``_exec_join``, for in-memory scans,
fused segments and host-sized joins; every other node kind belongs to a
later slice).

A segment's leaves are the nearest non-fusable nodes below it, each run once
(a frame joined with itself is one leaf), on both sides of every join. A join
that sizes its output on the host (``engine/join.py``) runs both inputs as
leaves, and its output is a leaf of the segment above it."""

from __future__ import annotations

from polars_tpu_torch.core.frame import DataFrame
from polars_tpu_torch.engine.executors import _is_fusable, run_segment
from polars_tpu_torch.plan import exprs as E
from polars_tpu_torch.plan import logical as L


def execute_plan(node: L.LNode) -> DataFrame:
    return _execute_node(node)


def _execute_node(node: L.LNode) -> DataFrame:
    if isinstance(node, L.LDataFrameScan):
        df = node.df
        if node.projection is not None:
            df = DataFrame._from_columns([df._get(n) for n in node.projection], df.height, device=df.device)
        return df

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

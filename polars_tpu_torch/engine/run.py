"""Plan execution entry (the port of ``polars_tpu/engine/run.py``'s
``execute_plan`` and ``_execute_node``, for in-memory scans and fused
segments; every other node kind belongs to a later slice)."""

from __future__ import annotations

from polars_tpu_torch.core.frame import DataFrame
from polars_tpu_torch.engine.executors import _is_fusable, run_segment
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

    raise NotImplementedError(f"executing {type(node).__name__} is not ported yet")

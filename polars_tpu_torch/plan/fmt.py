"""Plan pretty-printing for ``LazyFrame.explain`` (the port of
``polars_tpu/plan/fmt.py``'s ``explain_plan``; reference: polars-plan IR
Display). One line per node, its inputs indented below it."""

from __future__ import annotations

from polars_tpu_torch.plan import logical as L


def explain_plan(node: L.LNode, indent: int = 0) -> str:
    pad = "  " * indent
    name = type(node).__name__[1:]
    detail = ""
    if isinstance(node, L.LDataFrameScan):
        detail = f" [{node.df.width} cols, {node.df.height} rows]"
        if node.projection:
            detail += f" π {list(node.projection)}"
    elif isinstance(node, L.LScan):
        # the pushed projection as columns read of the file's, the pushed
        # predicate and row limit
        detail = f" {node.fmt}: {list(node.sources)[:2]}"
        if node.projection is not None:
            try:
                from polars_tpu_torch.io.scan_schema import scan_schema

                total = len(scan_schema(node))
            except Exception:  # noqa: BLE001 (the source may be gone when the plan is shown)
                total = len(node.projection)
            detail += f" π {len(node.projection)}/{total} {list(node.projection)}"
        if node.predicate is not None:
            detail += f" σ {node.predicate!r}"
        if node.n_rows is not None:
            detail += f" n_rows={node.n_rows}"
    elif isinstance(node, (L.LSelect, L.LWithColumns)):
        detail = f" {len(node.expressions)} exprs"
    elif isinstance(node, L.LFilter):
        detail = f" {node.predicate!r}"
    elif isinstance(node, L.LGroupBy):
        detail = f" keys={len(node.keys)} aggs={len(node.aggs)}"
    elif isinstance(node, L.LJoin):
        detail = f" how={node.how}"
    elif isinstance(node, L.LSort):
        detail = f" by={len(node.by)} desc={node.descending}" + (
            f" limit={node.limit}" if node.limit is not None else ""
        )
    elif isinstance(node, L.LSlice):
        detail = f" offset={node.offset} len={node.length}"
    elif isinstance(node, L.LExplode):
        detail = f" {list(node.columns)}"
    elif isinstance(node, L.LUnpivot):
        detail = f" on={None if node.on is None else list(node.on)} index={list(node.index)}"
    elif isinstance(node, L.LMapFunction):
        detail = f" {getattr(node.function, '__name__', 'function')}"
    elif isinstance(node, L.LDistinct):
        detail = f" subset={None if node.subset is None else list(node.subset)} keep={node.keep}"
    lines = [f"{pad}{name}{detail}"]
    for i in node.inputs():
        lines.append(explain_plan(i, indent + 1))
    return "\n".join(lines)

"""COUNT(*) without reading a column (the port of
``polars_tpu/plan/optimizer/count_star.py``; reference:
polars-plan/src/plans/optimizer/count_star.rs): ``select(pl.len())``
straight over an in-memory frame becomes a one-row frame of its height. The
branch that reads a file's row count from its metadata comes with the
Parquet slice."""

from __future__ import annotations

import numpy as np

from polars_tpu_torch import datatypes as dt
from polars_tpu_torch.plan import exprs as E
from polars_tpu_torch.plan import logical as L
from polars_tpu_torch.utils.tokens import obj_token


def _len_name(e: E.ENode) -> str | None:
    name = "len"
    while isinstance(e, E.EAlias):
        name = e.name
        e = e.input
    return name if isinstance(e, E.ELen) else None


def count_star(node: L.LNode) -> L.LNode:
    inputs = node.inputs()
    new_inputs = tuple(count_star(i) for i in inputs)
    if any(a is not b for a, b in zip(new_inputs, inputs)):
        node = L.rebuild(node, new_inputs)
    if not (isinstance(node, L.LSelect) and len(node.expressions) == 1 and isinstance(node.input, L.LDataFrameScan)):
        return node
    name = _len_name(node.expressions[0])
    if name is None:
        return node
    from polars_tpu_torch.core.column import Column
    from polars_tpu_torch.core.frame import DataFrame

    src = node.input.df
    col = Column.from_values(name, np.asarray([src.height], np.uint32), dt.UInt32(), device=src.device)
    df = DataFrame._from_columns([col], 1, device=src.device)
    return L.LDataFrameScan(df=df, ident=obj_token(df))

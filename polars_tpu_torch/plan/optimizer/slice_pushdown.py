"""Slice pushdown (the port of ``polars_tpu/plan/optimizer/slice_pushdown.py``;
reference: plans/optimizer/slice_pushdown_lp.rs): ``sort(...).head(k)``
becomes a top-k sort (``LSort.limit``), and a head moves below projections
that keep the row count. The limit a file scan takes comes with the Parquet
slice."""

from __future__ import annotations

import dataclasses

from polars_tpu_torch.plan import exprs as E
from polars_tpu_torch.plan import logical as L


def push_slices(node: L.LNode) -> L.LNode:
    if isinstance(node, L.LSlice) and node.offset == 0 and node.length is not None:
        inner = node.input
        if isinstance(inner, L.LSort) and inner.limit is None:
            return push_slices(dataclasses.replace(inner, limit=node.length))
        if isinstance(inner, (L.LSelect, L.LWithColumns, L.LRename, L.LDrop)):
            if not any(_length_changing(e) for e in inner.exprs()):
                return push_slices(L.rebuild(inner, (L.LSlice(inner.input, 0, node.length),)))
    new_inputs = tuple(push_slices(i) for i in node.inputs())
    return L.rebuild(node, new_inputs) if new_inputs else node


def _length_changing(e: E.ENode) -> bool:
    return any(isinstance(s, (E.EAgg, E.ELen)) for s in E.walk(e))

"""Slice pushdown (the port of ``polars_tpu/plan/optimizer/slice_pushdown.py``;
reference: plans/optimizer/slice_pushdown_lp.rs): ``sort(...).head(k)``
becomes a top-k sort (``LSort.limit``), and a head moves below projections
whose expressions are all elementwise, where Polars stops too: an
aggregation, a window, a position function (``shift``, ``rank``,
``cum_sum``) or an expression-level sort, filter or slice reads other rows
than its own. (The JAX package's guard, ``_length_changing``, stops only at
aggregations, slices, filters and sorts, so it moves a head below
``rank()``, ``shift(-1)`` or a window: ROADMAP section 3.) A head over a
file scan without a predicate becomes the scan's row limit (``n_rows``)."""

from __future__ import annotations

import dataclasses

from polars_tpu_torch.plan import exprs as E
from polars_tpu_torch.plan import logical as L


def push_slices(node: L.LNode) -> L.LNode:
    if isinstance(node, L.LSlice) and node.offset == 0 and node.length is not None:
        inner = node.input
        if isinstance(inner, L.LScan) and inner.predicate is None:
            n = node.length if inner.n_rows is None else min(inner.n_rows, node.length)
            return L.update(inner, n_rows=n)
        if isinstance(inner, L.LSort) and inner.limit is None:
            return push_slices(dataclasses.replace(inner, limit=node.length))
        if isinstance(inner, (L.LSelect, L.LWithColumns, L.LRename, L.LDrop)):
            if all(E.is_elementwise(e, host_ok=True) for e in inner.exprs()):
                return push_slices(L.rebuild(inner, (L.LSlice(inner.input, 0, node.length),)))
    new_inputs = tuple(push_slices(i) for i in node.inputs())
    return L.rebuild(node, new_inputs) if new_inputs else node


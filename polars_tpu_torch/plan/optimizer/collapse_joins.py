"""A filter over a cross join whose predicate equates a column of each side
becomes an equi join with the rest as a filter (the port of
``polars_tpu/plan/optimizer/collapse_joins.py``; reference:
polars-plan/src/plans/optimizer/collapse_joins.rs).

The equi join keeps the cross join's output schema: it runs with
``coalesce=False``, so both key columns (the right one suffixed where the
names clash) survive, as the filtered cross join would give them.
"""

from __future__ import annotations

import dataclasses

from polars_tpu_torch.plan import exprs as E
from polars_tpu_torch.plan import logical as L
from polars_tpu_torch.plan.optimizer.predicate_pushdown import _join_conjuncts, _split_conjuncts
from polars_tpu_torch.plan.schema_resolve import node_schema


def _side_of(name: str, lnames: set, rnames: set, suffix: str):
    """Which input an output column of the cross join comes from (a right
    name that clashes carries ``suffix``)."""
    if name in lnames:
        return ("l", name)
    if name in rnames:
        return ("r", name)
    if name.endswith(suffix) and name[: -len(suffix)] in rnames:
        return ("r", name[: -len(suffix)])
    return None


def collapse_joins(node: L.LNode) -> L.LNode:
    inputs = node.inputs()
    new_inputs = tuple(collapse_joins(i) for i in inputs)
    if any(a is not b for a, b in zip(new_inputs, inputs)):
        node = L.rebuild(node, new_inputs)
    if not (isinstance(node, L.LFilter) and isinstance(node.input, L.LJoin) and node.input.how == "cross"):
        return node
    j = node.input
    lnames = set(node_schema(j.input_left).names())
    rnames = set(node_schema(j.input_right).names())
    left_keys: list[E.ENode] = []
    right_keys: list[E.ENode] = []
    residual: list[E.ENode] = []
    for c in _split_conjuncts(node.predicate):
        if (
            isinstance(c, E.EBinary)
            and c.op == "=="
            and isinstance(c.left, E.EColumn)
            and isinstance(c.right, E.EColumn)
        ):
            a = _side_of(c.left.name, lnames, rnames, j.suffix)
            b = _side_of(c.right.name, lnames, rnames, j.suffix)
            if a and b and {a[0], b[0]} == {"l", "r"}:
                lc, rc = (a, b) if a[0] == "l" else (b, a)
                left_keys.append(E.EColumn(lc[1]))
                right_keys.append(E.EColumn(rc[1]))
                continue
        residual.append(c)
    if not left_keys:
        return node
    nj = dataclasses.replace(j, left_on=tuple(left_keys), right_on=tuple(right_keys), how="inner", coalesce=False)
    return L.LFilter(nj, _join_conjuncts(residual)) if residual else nj

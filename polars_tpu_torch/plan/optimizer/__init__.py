"""The logical-plan optimizer (the port of ``polars_tpu/plan/optimizer/``;
reference: polars-plan/src/plans/optimizer/mod.rs:85-300).

The passes run in the reference's order: the schema check, expression
simplification, expression CSE, sort collapse and order observation,
predicate pushdown, the cross-join collapse, COUNT(*) from the frame's
height, projection pushdown, slice pushdown, and last common-subplan
elimination (the pushdowns may specialise two copies of a subplan
differently; only copies still equal are cached). Each pass is gated by its
:class:`~polars_tpu_torch.functions.interop.QueryOptFlags` toggle.
"""

from __future__ import annotations

from polars_tpu_torch.plan import logical as L
from polars_tpu_torch.plan.optimizer.collapse_joins import collapse_joins
from polars_tpu_torch.plan.optimizer.count_star import count_star
from polars_tpu_torch.plan.optimizer.cse import collapse_common_subplans, collapse_sorts
from polars_tpu_torch.plan.optimizer.cse_expr import cse_expressions
from polars_tpu_torch.plan.optimizer.order_observe import order_observe
from polars_tpu_torch.plan.optimizer.predicate_pushdown import push_predicates
from polars_tpu_torch.plan.optimizer.projection_pushdown import push_projections
from polars_tpu_torch.plan.optimizer.simplify import simplify_exprs
from polars_tpu_torch.plan.optimizer.slice_pushdown import push_slices
from polars_tpu_torch.plan.schema_resolve import node_schema, schema_memo


def optimize(node: L.LNode, flags=None) -> L.LNode:
    """The optimized plan of ``node``; ``flags`` is a ``QueryOptFlags`` or
    None (every pass on)."""

    def on(name: str) -> bool:
        return flags is None or getattr(flags, name, True)

    with schema_memo():
        if on("type_check"):
            # an unknown column or an untypable expression raises here,
            # before anything runs
            node_schema(node)
        if on("simplify_expression"):
            node = simplify_exprs(node)
        if on("comm_subexpr_elim"):
            node = cse_expressions(node)
        if on("check_order_observe"):
            node = order_observe(collapse_sorts(node))
        if on("predicate_pushdown"):
            node = push_predicates(node)
        if on("collapse_joins"):
            # after predicate pushdown, one-sided conjuncts have sunk into the
            # cross join's inputs; what is left can sink through the equi join
            rewritten = collapse_joins(node)
            if rewritten is not node and on("predicate_pushdown"):
                rewritten = push_predicates(rewritten)
            node = rewritten
        if on("fast_projection"):
            node = count_star(node)
        if on("projection_pushdown"):
            node = push_projections(node)
        if on("slice_pushdown"):
            node = push_slices(node)
        if on("comm_subplan_elim"):
            node = collapse_common_subplans(node)
    return node

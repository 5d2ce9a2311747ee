"""``QueryOptFlags`` (the port of the class in
``polars_tpu/functions/interop.py``; reference: py-polars
lazyframe/opt_flags.py)."""

from __future__ import annotations

_PASSES = (
    "predicate_pushdown", "projection_pushdown", "simplify_expression", "slice_pushdown", "comm_subplan_elim",
    "comm_subexpr_elim", "cluster_with_columns", "collapse_joins", "check_order_observe", "fast_projection",
)


class QueryOptFlags:
    """The optimizer's toggles. ``collect(optimizations=...)`` and
    ``explain(optimizations=...)`` hand them to ``plan.optimizer.optimize``,
    which runs a pass only while its toggle is on: simplify_expression,
    comm_subexpr_elim (aggregates repeated across a sort), check_order_observe
    (sorts nothing observes), predicate_pushdown, collapse_joins (a filtered
    cross join becomes an equi join), fast_projection (COUNT(*) from the
    frame's height), projection_pushdown, slice_pushdown (top-k) and
    comm_subplan_elim (subplans used twice run once). type_check resolves the
    whole plan's schema first. cluster_with_columns and type_coercion are
    accepted and change nothing."""

    def __init__(
        self,
        *,
        predicate_pushdown: bool = True,
        projection_pushdown: bool = True,
        simplify_expression: bool = True,
        slice_pushdown: bool = True,
        comm_subplan_elim: bool = True,
        comm_subexpr_elim: bool = True,
        cluster_with_columns: bool = True,
        collapse_joins: bool = True,
        check_order_observe: bool = True,
        fast_projection: bool = True,
        type_coercion: bool = True,
        type_check: bool = True,
    ) -> None:
        self.predicate_pushdown = predicate_pushdown
        self.projection_pushdown = projection_pushdown
        self.simplify_expression = simplify_expression
        self.slice_pushdown = slice_pushdown
        self.comm_subplan_elim = comm_subplan_elim
        self.comm_subexpr_elim = comm_subexpr_elim
        self.cluster_with_columns = cluster_with_columns
        self.collapse_joins = collapse_joins
        self.check_order_observe = check_order_observe
        self.fast_projection = fast_projection
        self.type_coercion = type_coercion
        self.type_check = type_check

    @classmethod
    def none(cls) -> QueryOptFlags:
        """Every pass off (the schema check stays)."""
        return cls(**{k: False for k in _PASSES})

"""Order observation: remove sorts whose order nothing downstream observes
(the port of ``polars_tpu/plan/optimizer/order_observe.py``; reference:
polars-plan/src/plans/optimizer/mod.rs CHECK_ORDER_OBSERVE).

Two conservative rewrites: a ``group_by(maintain_order=False)`` whose keys
and aggregations ignore row order, and a ``unique(keep="any",
maintain_order=False)``, each over a full sort (no limit). The sort only
permutes the rows those consumers see, so dropping it keeps every value. The
walk looks through select, with_columns and filter nodes whose expressions
are all elementwise, and through rename and drop. A sort with a limit is a
top-k selection and always stays.
"""

from __future__ import annotations

from polars_tpu_torch.plan import exprs as E
from polars_tpu_torch.plan import logical as L

# aggregations whose result does not depend on the order of rows in a group
_ORDER_AGNOSTIC_AGGS = {"sum", "min", "max", "mean", "count", "len", "n_unique"}

_PLAIN_NODES = (E.EColumn, E.ELiteral, E.EBinary, E.ECast, E.EAlias, E.ETernary)


def _expr_order_insensitive(node: E.ENode) -> bool:
    """True if the expression gives the same multiset of values for any row
    permutation of its input: plain nodes, elementwise functions and
    order-agnostic aggregations. A position function (``cum_sum``,
    ``shift``), a window or an expression-level sort keeps the sort below
    it."""
    for n in E.walk(node):
        if isinstance(n, _PLAIN_NODES):
            continue
        if isinstance(n, E.EFunction) and E.fn_elementwise(n.name):
            continue
        if isinstance(n, E.EAgg) and n.kind in _ORDER_AGNOSTIC_AGGS:
            continue
        return False
    return True


def _strip_unobserved_sorts(node: L.LNode) -> L.LNode:
    """Remove full sorts reachable through order-transparent unary nodes."""
    if isinstance(node, L.LSort) and node.limit is None:
        return _strip_unobserved_sorts(node.input)
    if isinstance(node, (L.LFilter, L.LSelect, L.LWithColumns)):
        if all(_expr_order_insensitive(e) for e in node.exprs()):
            inner = _strip_unobserved_sorts(node.input)
            if inner is not node.input:
                return L.rebuild(node, (inner,))
        return node
    if isinstance(node, (L.LRename, L.LDrop)):
        inner = _strip_unobserved_sorts(node.input)
        if inner is not node.input:
            return L.rebuild(node, (inner,))
    return node


def order_observe(node: L.LNode) -> L.LNode:
    node = L.rebuild(node, tuple(order_observe(i) for i in node.inputs()))
    if (
        isinstance(node, L.LGroupBy)
        and not node.maintain_order
        and all(_expr_order_insensitive(k) for k in node.keys)
        and all(_expr_order_insensitive(a) for a in node.aggs)
    ) or (isinstance(node, L.LDistinct) and node.keep == "any" and not node.maintain_order):
        inner = _strip_unobserved_sorts(node.input)
        if inner is not node.input:
            node = L.rebuild(node, (inner,))
    return node

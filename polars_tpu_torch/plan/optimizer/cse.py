"""Common-subplan elimination and sort collapse (the port of
``polars_tpu/plan/optimizer/cse.py``; reference:
polars-plan/src/plans/optimizer/cse/ and the collapse_sorts rewrite).

Structurally equal subplans that are not bare table scans and appear more
than once (Q15's aggregate, joined back to its own maximum) are wrapped in
one :class:`LCache` node, so they run once per collect; an inner sort that
an outer sort re-orders is dropped.
"""

from __future__ import annotations

import dataclasses

from polars_tpu_torch.plan import logical as L
from polars_tpu_torch.utils.tokens import next_token


def _is_trivial(node: L.LNode) -> bool:
    """Subplans not worth caching: bare table references."""
    return isinstance(node, (L.LDataFrameScan, L.LCache))


def _structure(node: L.LNode, sid: dict, intern: dict, nodes: list) -> int:
    """A number per distinct subplan (equal numbers, structurally equal
    subplans), each node keyed once by its own fields and its inputs'
    numbers: hashing every subtree anew would cost the square of the plan's
    depth."""
    got = sid.get(id(node))
    if got is None:
        kids = tuple(_structure(i, sid, intern, nodes) for i in node.inputs())
        own = tuple(getattr(node, f.name) for f in dataclasses.fields(node)
                    if f.compare and not isinstance(getattr(node, f.name), L.LNode))
        got = intern.setdefault((type(node), own, kids), len(intern))
        if got == len(nodes):
            nodes.append(node)
        sid[id(node)] = got
    return got


def collapse_common_subplans(root: L.LNode) -> L.LNode:
    """Wrap each maximal repeated subplan in one LCache node. One LazyFrame
    used twice counts per occurrence: the earlier passes rewrite each branch
    on its own, so structural equality is the key."""
    sid: dict[int, int] = {}
    nodes: list[L.LNode] = []  # the first node of each number
    _structure(root, sid, {}, nodes)
    counts: dict[int, int] = {}
    stack = [root]
    while stack:
        n = stack.pop()
        if not _is_trivial(n):
            counts[sid[id(n)]] = counts.get(sid[id(n)], 0) + 1
        stack.extend(n.inputs())
    repeated = {k for k, c in counts.items() if c > 1}
    # a repeated subplan inside another repeated one is covered by the outer
    maximal = set(repeated)
    for k in repeated:
        stack = list(nodes[k].inputs())
        while stack:
            s = stack.pop()
            maximal.discard(sid[id(s)])
            stack.extend(s.inputs())
    maximal.discard(sid[id(root)])
    if not maximal:
        return root
    cache_for = {k: L.LCache(input=nodes[k], ident=next_token()) for k in sorted(maximal)}
    memo: dict[int, L.LNode] = {}

    def rewrite(node: L.LNode) -> L.LNode:
        hit = cache_for.get(sid[id(node)])
        if hit is not None:
            return hit
        if id(node) not in memo:
            memo[id(node)] = L.rebuild(node, tuple(rewrite(i) for i in node.inputs()))
        return memo[id(node)]

    return rewrite(root)


def collapse_sorts(node: L.LNode) -> L.LNode:
    """Drop an inner full sort that an outer sort re-orders:
    sort(sort(x, a), b) == sort(x, b) when the inner sort has no limit (a
    limited sort is a top-k selection) and the outer one does not keep the
    incoming order of ties (``maintain_order``)."""
    node = L.rebuild(node, tuple(collapse_sorts(i) for i in node.inputs()))
    if isinstance(node, L.LSort) and not node.maintain_order:
        inner = node.input
        while isinstance(inner, L.LSort) and inner.limit is None:
            inner = inner.input
        if inner is not node.input:
            node = L.rebuild(node, (inner,))
    return node

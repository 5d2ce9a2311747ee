"""Expression-level common-subexpression elimination across segment
barriers (the port of ``polars_tpu/plan/optimizer/cse_expr.py``; reference:
polars-plan/src/plans/optimizer/cse/cse_expr.rs).

Within one evaluation context the compiler's memo already evaluates each
structurally equal subtree once. What is left is an aggregate computed in a
``with_columns`` or ``select`` below a barrier (a sort) and repeated
verbatim above it: this pass rewrites the later occurrence to a reference to
the column that already holds it. Window expressions (``over``) join this
pass with the expression-breadth slice.

Validity rules (conservative):
- definitions come from ``with_columns``/``select`` outputs; the walk down
  stops at any node that does not keep every row and column (``with_columns``
  and ``sort`` do; ``filter`` does not: it changes what an aggregate sees);
- a definition dies if its name, or a column it reads, is redefined between
  the definition and the use;
- only row-context expression lists are rewritten (select, with_columns,
  filter, sort keys), never a group-by's aggregations.
"""

from __future__ import annotations

import dataclasses

from polars_tpu_torch.plan import exprs as E
from polars_tpu_torch.plan import logical as L

_MAX_DEPTH = 64


def _expensive(e: E.ENode) -> bool:
    return any(isinstance(s, E.EAgg) for s in E.walk(e))


def _reads(e: E.ENode) -> set[str]:
    return {s.name for s in E.walk(e) if isinstance(s, E.EColumn)}


def _collect_defs(n: L.LNode) -> dict:
    """Expression -> the column that holds it, for definitions still valid
    at the output of ``n``."""
    defs: dict = {}
    shadow: set[str] = set()  # names (re)defined above the definition
    cur = n
    for _ in range(_MAX_DEPTH):
        if isinstance(cur, (L.LWithColumns, L.LSelect)):
            local_outs: set[str] = set()
            for e in cur.exprs():
                name = E.output_name(e)
                if name is None:
                    continue
                local_outs.add(name)
                base = e
                while isinstance(base, E.EAlias):
                    base = base.input
                if _expensive(base) and name not in shadow and not (_reads(base) & shadow):
                    defs.setdefault(base, name)
            shadow |= local_outs
            if isinstance(cur, L.LSelect):
                break  # columns below a projection may be gone
            cur = cur.input
            continue
        if isinstance(cur, L.LSort):
            cur = cur.input
            continue
        break
    return defs


def _replace_expr(node: E.ENode, target: E.ENode, repl: E.ENode) -> E.ENode:
    if node == target:
        return repl
    changes = {}
    for f in dataclasses.fields(node):
        v = getattr(node, f.name)
        if isinstance(v, E.ENode):
            nv = _replace_expr(v, target, repl)
            if nv is not v:
                changes[f.name] = nv
        elif isinstance(v, tuple) and v and all(isinstance(x, E.ENode) for x in v):
            nv = tuple(_replace_expr(x, target, repl) for x in v)
            if any(a is not b for a, b in zip(nv, v)):
                changes[f.name] = nv
    return dataclasses.replace(node, **changes) if changes else node


def _rewrite_exprs(exprs, defs):
    out = []
    changed = False
    for e in exprs:
        ne = e
        for dexpr, name in defs.items():
            # never rewrite a definition of itself
            base = ne
            while isinstance(base, E.EAlias):
                base = base.input
            if base == dexpr and E.output_name(ne) == name:
                continue
            ne = _replace_expr(ne, dexpr, E.EColumn(name))
        changed = changed or (ne is not e)
        out.append(ne)
    return tuple(out), changed


def cse_expressions(node: L.LNode) -> L.LNode:
    inputs = node.inputs()
    new_inputs = tuple(cse_expressions(i) for i in inputs)
    if any(a is not b for a, b in zip(new_inputs, inputs)):
        node = L.rebuild(node, new_inputs)

    if isinstance(node, (L.LSelect, L.LWithColumns, L.LFilter, L.LSort)):
        defs = _collect_defs(node.inputs()[0])
        if defs:
            if isinstance(node, L.LFilter):
                pred, ch = _rewrite_exprs((node.predicate,), defs)
                if ch:
                    node = dataclasses.replace(node, predicate=pred[0])
            elif isinstance(node, L.LSort):
                by, ch = _rewrite_exprs(node.by, defs)
                if ch:
                    node = dataclasses.replace(node, by=by)
            else:
                exprs, ch = _rewrite_exprs(node.exprs(), defs)
                if ch:
                    node = dataclasses.replace(node, expressions=exprs)
    return node

"""Projection pushdown (the port of
``polars_tpu/plan/optimizer/projection_pushdown.py``; reference:
plans/optimizer/projection_pushdown/): the set of columns each node needs
travels down to the in-memory scans, so a segment carries, gathers and
compacts only the columns the query reads. The projection a file scan takes
comes with the Parquet slice. A strict ``drop`` over a pruned input drops
what it still finds (``polars_tpu`` keeps it strict, and then raises for a
column its own pushdown removed), and each input of a vertical concat is
cut to the same columns (in ``polars_tpu`` one that keeps a column for its
own filter breaks the concat)."""

from __future__ import annotations

from polars_tpu_torch.plan import exprs as E
from polars_tpu_torch.plan import logical as L
from polars_tpu_torch.plan.schema_resolve import node_schema


def push_projections(node: L.LNode) -> L.LNode:
    return _push(node, None)


def _exprs_roots(exprs) -> set[str]:
    return {r for e in exprs for r in E.root_column_names(e)}


def _kept(exprs, needed: set[str]) -> tuple[E.ENode, ...]:
    return tuple(e for e in exprs if (E.output_name(e) or "literal") in needed)


def _push(node: L.LNode, needed: set[str] | None) -> L.LNode:
    """``needed=None`` means every column is needed."""
    if isinstance(node, L.LDataFrameScan):
        if needed is not None:
            proj = tuple(c.name for c in node.df._columns if c.name in needed)
            return L.update(node, projection=proj)
        return node

    if isinstance(node, L.LSelect):
        exprs = node.expressions
        if needed is not None:
            exprs = _kept(exprs, needed) or exprs
        return L.update(node, input=_push(node.input, _exprs_roots(exprs)), expressions=exprs)

    if isinstance(node, L.LWithColumns):
        if needed is None:
            return L.update(node, input=_push(node.input, None))
        exprs = _kept(node.expressions, needed)
        in_names = set(node_schema(node.input).names())
        new_input = _push(node.input, {n for n in needed if n in in_names} | _exprs_roots(exprs))
        if not exprs:
            return new_input  # nothing it defines is needed
        return L.update(node, input=new_input, expressions=exprs)

    if isinstance(node, (L.LFilter, L.LSort)):
        child = None if needed is None else (needed | _exprs_roots(node.exprs()))
        return L.update(node, input=_push(node.input, child))

    if isinstance(node, L.LDistinct):
        child = None if needed is None or node.subset is None else (needed | set(node.subset))
        return L.update(node, input=_push(node.input, child))

    if isinstance(node, L.LGroupBy):
        return L.update(node, input=_push(node.input, _exprs_roots((*node.keys, *node.aggs))))

    if isinstance(node, L.LJoin):
        if needed is None:
            lneed = rneed = None
        else:
            lnames = set(node_schema(node.input_left).names())
            rnames = set(node_schema(node.input_right).names())
            lneed = {n for n in needed if n in lnames} | _exprs_roots(node.left_on)
            rneed = set()
            for n in needed:
                if n in rnames:
                    rneed.add(n)
                elif n.endswith(node.suffix) and n[: -len(node.suffix)] in rnames:
                    rneed.add(n[: -len(node.suffix)])
            rneed |= _exprs_roots(node.right_on)
        return L.update(node, input_left=_push(node.input_left, lneed),
                                   input_right=_push(node.input_right, rneed))

    if isinstance(node, L.LRename):
        if needed is None:
            return L.update(node, input=_push(node.input, None))
        inv = {new: old for old, new in node.mapping}
        # mapping entries whose column was pruned away go too
        mapping = tuple((old, new) for old, new in node.mapping if new in needed)
        return L.update(node, input=_push(node.input, {inv.get(n, n) for n in needed}), mapping=mapping)

    if isinstance(node, L.LDrop):
        if needed is None:
            return L.update(node, input=_push(node.input, None))
        # the columns it drops are needed by nothing above, so the input may
        # have lost them: the drop no longer insists on finding them
        return L.update(node, input=_push(node.input, set(needed)), strict=False)

    if isinstance(node, (L.LSlice, L.LWithRowIndex)):
        child = None
        if needed is not None:
            child = {n for n in needed if not (isinstance(node, L.LWithRowIndex) and n == node.name)}
            if isinstance(node, L.LWithRowIndex) and not child:
                # the row count still needs one column
                child = set(node_schema(node.input).names()[:1])
        return L.update(node, input=_push(node.input, child))

    if isinstance(node, L.LUnion):
        if needed is None:
            return L.update(node, inputs_=tuple(_push(i, None) for i in node.inputs_))
        # an input keeps what its own filters read; the pieces must line up
        names = [n for n in node_schema(node).names() if n in needed]
        inputs = []
        for i in node.inputs_:
            pushed = _push(i, set(needed))
            if node_schema(pushed).names() != names:
                pushed = L.LSelect(pushed, tuple(E.EColumn(n) for n in names))
            inputs.append(pushed)
        return L.update(node, inputs_=tuple(inputs))

    if isinstance(node, L.LHConcat):
        return L.update(node, inputs_=tuple(
            _push(i, None if needed is None else needed & set(node_schema(i).names())) for i in node.inputs_))

    # anything else (a cache, range and asof joins) needs every column below it
    new_inputs = tuple(_push(i, None) for i in node.inputs())
    return L.rebuild(node, new_inputs) if new_inputs else node

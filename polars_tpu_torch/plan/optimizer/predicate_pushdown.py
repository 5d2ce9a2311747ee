"""Predicate pushdown (the port of
``polars_tpu/plan/optimizer/predicate_pushdown.py``; reference:
plans/optimizer/predicate_pushdown/, with the left/right classification of
join/mod.rs). File scans, which take the predicate themselves, come with
the Parquet slice.

A predicate moves below ``unique`` only where every column it reads is in
the ``subset`` (with no subset, every column counts), as Polars has it:
``polars_tpu`` moves any predicate below ``keep="any"`` and ``keep="none"``,
which changes which rows count as duplicates. Nor does a predicate move
below ``with_row_index``: ``polars_tpu`` moves those that do not read the
index, which renumbers the rows that pass.
"""

from __future__ import annotations

from polars_tpu_torch.plan import exprs as E
from polars_tpu_torch.plan import logical as L
from polars_tpu_torch.plan.schema_resolve import _rebuild_expr, node_schema


def _split_conjuncts(pred: E.ENode) -> list[E.ENode]:
    if isinstance(pred, E.EBinary) and pred.op == "&":
        return _split_conjuncts(pred.left) + _split_conjuncts(pred.right)
    return [pred]


def _join_conjuncts(preds: list[E.ENode]) -> E.ENode:
    node = preds[0]
    for p in preds[1:]:
        node = E.EBinary(node, "&", p)
    return node


def push_predicates(node: L.LNode) -> L.LNode:
    return _push(node, [])


def _with_filters(node: L.LNode, preds: list[E.ENode]) -> L.LNode:
    if not preds:
        return node
    return L.LFilter(node, _join_conjuncts(preds))


def _split(preds: list[E.ENode], goes_below) -> tuple[list[E.ENode], list[E.ENode]]:
    below = [p for p in preds if goes_below(E.root_column_names(p))]
    return below, [p for p in preds if not goes_below(E.root_column_names(p))]


def _below(node: L.LNode, below: list[E.ENode], stay: list[E.ENode]) -> L.LNode:
    """``node`` over its input with ``below`` pushed into it, ``stay`` above."""
    return _with_filters(L.update(node, input=_push(node.input, below)), stay)


def _push(node: L.LNode, preds: list[E.ENode]) -> L.LNode:
    if isinstance(node, L.LFilter):
        # only elementwise predicates move past other nodes
        conj = _split_conjuncts(node.predicate)
        pushable = [p for p in conj if E.is_elementwise(p)]
        blocked = [p for p in conj if not E.is_elementwise(p)]
        return _with_filters(_push(node.input, preds + pushable), blocked)

    if isinstance(node, L.LDataFrameScan):
        return _with_filters(node, preds)

    if isinstance(node, (L.LSelect, L.LWithColumns)):
        if not all(E.is_elementwise(e) for e in node.expressions):
            # an aggregate in the projection depends on its input rows
            return _below(node, [], preds)
        if isinstance(node, L.LWithColumns):
            defined = {n for n in (E.output_name(e) for e in node.expressions) if n}
            passthrough = set(node_schema(node.input).names()) - defined
            return _below(node, *_split(preds, lambda roots: all(r in passthrough for r in roots)))
        # select: a column passes through if it is a bare or aliased column
        rename_map = {}
        for e in node.expressions:
            base = e
            out_name = E.output_name(e)
            while isinstance(base, E.EAlias):
                base = base.input
            if isinstance(base, E.EColumn) and out_name:
                rename_map[out_name] = base.name
        below, stay = _split(preds, lambda roots: bool(roots) and all(r in rename_map for r in roots))
        below = [_rename_cols(p, {r: rename_map[r] for r in E.root_column_names(p) if rename_map[r] != r})
                 for p in below]
        return _below(node, below, stay)

    if isinstance(node, L.LRename):
        inv = {new: old for old, new in node.mapping}
        return _below(node, [_rename_cols(p, inv) for p in preds], [])

    if isinstance(node, L.LDrop):
        return _below(node, preds, [])

    if isinstance(node, L.LSort):
        # filters commute with a full sort, not with a top-k
        if node.limit is None:
            return L.update(node, input=_push(node.input, preds))
        return _with_filters(_push_none(node), preds)

    if isinstance(node, L.LDistinct):
        if node.keep in ("any", "none"):
            subset = node.subset

            def in_subset(roots) -> bool:
                return subset is None or all(r in subset for r in roots)

            return _below(node, *_split(preds, in_subset))
        return _with_filters(_push_none(node), preds)

    if isinstance(node, L.LGroupBy):
        key_passthrough = {}
        for k in node.keys:
            base = k
            while isinstance(base, E.EAlias):
                base = base.input
            n = E.output_name(k)
            if isinstance(base, E.EColumn) and n:
                key_passthrough[n] = base.name
        below, stay = _split(preds, lambda roots: bool(roots) and all(r in key_passthrough for r in roots))
        below = [_rename_cols(p, {r: key_passthrough[r] for r in E.root_column_names(p) if key_passthrough[r] != r})
                 for p in below]
        return _below(node, below, stay)

    if isinstance(node, L.LJoin):
        left_names = set(node_schema(node.input_left).names())
        right_suffixed = {}
        for rn in node_schema(node.input_right).names():
            right_suffixed[rn + node.suffix if rn in left_names else rn] = rn
        left_ok = node.how in ("inner", "left", "semi", "anti")
        right_ok = node.how in ("inner", "right")
        to_left, to_right, stay = [], [], []
        for p in preds:
            roots = set(E.root_column_names(p))
            if roots and roots <= left_names and left_ok:
                to_left.append(p)
            elif roots and all(r in right_suffixed for r in roots) and right_ok:
                to_right.append(_rename_cols(p, {r: right_suffixed[r] for r in roots if right_suffixed[r] != r}))
            else:
                stay.append(p)
        out = L.update(node, input_left=_push(node.input_left, to_left),
                                  input_right=_push(node.input_right, to_right))
        return _with_filters(out, stay)

    if isinstance(node, L.LUnion):
        return L.update(node, inputs_=tuple(_push(i, list(preds)) for i in node.inputs_))

    # a slice, a row index (a filter below it would renumber the rows), a
    # horizontal concat, a cache and the other joins: stop here
    return _with_filters(_push_none(node), preds)


def _push_none(node: L.LNode) -> L.LNode:
    new_inputs = tuple(_push(i, []) for i in node.inputs())
    return L.rebuild(node, new_inputs) if new_inputs else node


def _rename_cols(node: E.ENode, mapping: dict[str, str]) -> E.ENode:
    if not mapping:
        return node
    if isinstance(node, E.EColumn):
        return E.EColumn(mapping[node.name]) if node.name in mapping else node
    kids = node.children()
    if not kids:
        return node
    new_kids = tuple(_rename_cols(k, mapping) for k in kids)
    if new_kids == kids:
        return node
    return _rebuild_expr(node, new_kids)

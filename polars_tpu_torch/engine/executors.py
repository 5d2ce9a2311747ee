"""Plan execution: one fused segment between barriers (the port of
``polars_tpu/engine/executors.py``: ``TTable``, ``trace_node``,
``_trace_groupby``, ``_batch_aggs`` and ``run_segment``).

A segment is a tree of filter/select/with_columns/group-by/sort/slice nodes
and validated joins over its leaf frames. Filters, slices and semi/anti joins
only narrow a row mask; a 1:m or m:1 join gathers the build side's columns to
the probe rows (``engine/join_traced.py``); group-by outputs stay
capacity-sized with the group count on the device. The segment ends in one
compaction of every output column (kernel K2), whose survivor count is the
segment's single host read-back. The JAX package compiles each segment into
one XLA program and caches it; PyTorch runs eagerly, so the port has no jit
cache and no formulation toggles.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from polars_tpu_torch import datatypes as dt
from polars_tpu_torch.config import DENSE_MAX_CAP
from polars_tpu_torch.core.buffer import Buffer
from polars_tpu_torch.core.column import Column
from polars_tpu_torch.core.frame import DataFrame
from polars_tpu_torch.core.schema import Schema
from polars_tpu_torch.engine import fn_nested as NS
from polars_tpu_torch.engine import groupby as G
from polars_tpu_torch.engine.cast import float_values, wrap_unsigned
from polars_tpu_torch.engine.common import GROUP, ROW, SCALAR, EvalCtx, Val, child_column, col_to_val, reject_series
from polars_tpu_torch.engine.compiler import (
    _agg_domain, _agg_input, _agg_out_dtype, _sub_ctx, align_pieces, decimal_to_float, eval_expr, eval_piece,
    group_of, mean_values,
)
from polars_tpu_torch.engine.join_traced import trace_join
from polars_tpu_torch.engine.sort import apply_perm, sort_perm
from polars_tpu_torch.engine.strings import concat_vals
from polars_tpu_torch.errors import ComputeError, InvalidOperationError, ShapeError
from polars_tpu_torch.kernels.argsort import boundaries_from_words, stable_argsort_words
from polars_tpu_torch.kernels.nested_keys import val_words
from polars_tpu_torch.kernels.compact import compact_count, compact_scatter
from polars_tpu_torch.kernels.groupagg import groupagg_sums
from polars_tpu_torch.plan import exprs as E
from polars_tpu_torch.plan import logical as L
from polars_tpu_torch.plan.schema_resolve import expand_exprs, expr_dtype, node_schema, supertype

# ---------------------------------------------------------------------------
# segment table
# ---------------------------------------------------------------------------


@dataclass
class TTable:
    cols: dict[str, Val]  # all ROW domain, tensors of one length
    rowmask: torch.Tensor

    def schema(self) -> Schema:
        return Schema([(n, v.dtype) for n, v in self.cols.items()])


_FUSABLE = (
    L.LFilter, L.LSelect, L.LWithColumns, L.LSlice, L.LDistinct, L.LSort, L.LGroupBy, L.LRename, L.LDrop,
    L.LWithRowIndex, L.LUnion, L.LHConcat, L.LJoin, L.LExplode,
)


def _join_fusable(node: L.LJoin) -> bool:
    """Joins whose output has a static size run inside the segment: m:1/1:1
    (and inner 1:m, flipped) have at most one build row per probe row, and a
    semi/anti join keeps a subset of the left rows. An unvalidated semi/anti
    join needs an exact key comparison (one non-float key): the matcher
    verifies only the first candidate of a run of equal hashes."""
    if node.validate in ("m:1", "1:1"):
        return node.how in ("inner", "left", "semi", "anti")
    if node.validate == "1:m":
        return node.how == "inner"
    if node.how in ("semi", "anti") and len(node.left_on) == 1 and not node.nulls_equal:
        lt = expr_dtype(node.left_on[0], node_schema(node.input_left))
        rt = expr_dtype(node.right_on[0], node_schema(node.input_right))
        return not lt.is_float() and not rt.is_float()
    return False


def _is_fusable(node: L.LNode) -> bool:
    """A node that runs inside a segment: not a host-sized join, nor a
    select that calls a host function (``engine/hostops.py``)."""
    if isinstance(node, (L.LSelect, L.LWithColumns)):
        return not any(E.needs_host(e) for e in node.expressions)
    if isinstance(node, L.LGroupBy) and any(E.needs_host_agg(e) or any(isinstance(n, E.EAnonymous)
                                                                      for n in E.walk(e)) for e in node.aggs):
        return False
    return isinstance(node, _FUSABLE) and (not isinstance(node, L.LJoin) or _join_fusable(node))


class _TraceCtx:
    """State while running one segment."""

    def __init__(self, leaf_tables: dict[int, TTable]):
        self.leaf_tables = leaf_tables  # id(node) -> TTable
        # validation failures: (bool 0-d tensor, message); a message of None
        # is a join's cardinality check
        self.flags: list = []


def _eval_ctx(tt: TTable, tc: _TraceCtx) -> EvalCtx:
    return EvalCtx(cols=dict(tt.cols), rowmask=tt.rowmask, memo={}, flags=tc.flags)


def _as_rows(v: Val, rows: int) -> Val:
    """A SCALAR value broadcast to ``rows`` rows."""
    if v.domain != SCALAR:
        return v
    return v.with_(values=v.values.expand(rows), validity=None if v.validity is None else v.validity.expand(rows),
                   domain=ROW)


def trace_node(node: L.LNode, tc: _TraceCtx) -> TTable:
    if id(node) in tc.leaf_tables:
        return tc.leaf_tables[id(node)]

    if isinstance(node, L.LJoin):
        tt_l = trace_node(node.input_left, tc)
        tt_r = trace_node(node.input_right, tc)

        def eval_key(e, tt):
            return eval_expr(expand_exprs((e,), tt.schema())[0], _eval_ctx(tt, tc))

        cols, rowmask, bad = trace_join(node, tt_l, tt_r, eval_key)
        tc.flags.append((bad, None))
        return TTable(cols, rowmask)

    if isinstance(node, L.LSlice):
        tt = trace_node(node.input, tc)
        rank = torch.cumsum(tt.rowmask, 0, dtype=torch.int64)  # 1-based among the rows kept
        total = rank[-1:] if rank.shape[0] else torch.zeros(1, dtype=torch.int64, device=rank.device)
        if node.offset < 0:
            start = (total + node.offset).clamp(min=0)
        else:
            start = total.clamp(max=node.offset)
        stop = total if node.length is None else torch.minimum(start + node.length, total)
        return TTable(tt.cols, tt.rowmask & (rank > start) & (rank <= stop))

    if isinstance(node, L.LFilter):
        tt = trace_node(node.input, tc)
        ctx = _eval_ctx(tt, tc)
        mask = tt.rowmask
        for p in expand_exprs((node.predicate,), tt.schema()):
            v = eval_expr(p, ctx)
            if not isinstance(v.dtype, dt.Boolean):
                raise ComputeError(f"filter predicate must be Boolean, got {v.dtype!r}")
            pv = v.values.to(torch.bool)
            if v.validity is not None:
                pv = pv & v.validity
            mask = mask & pv  # a SCALAR predicate broadcasts
        return TTable(tt.cols, mask)

    if isinstance(node, L.LSelect):
        return _trace_select(trace_node(node.input, tc), node.expressions, tc, keep_input=False)

    if isinstance(node, L.LWithColumns):
        return _trace_select(trace_node(node.input, tc), node.expressions, tc, keep_input=True)

    if isinstance(node, L.LSort):
        tt = trace_node(node.input, tc)
        ctx = _eval_ctx(tt, tc)
        key_vals = [_as_rows(eval_expr(b, ctx), tt.rowmask.shape[0]) for b in expand_exprs(node.by, tt.schema())]
        desc = list(node.descending)
        nl = list(node.nulls_last)
        while len(desc) < len(key_vals):
            desc.append(desc[-1] if desc else False)
        while len(nl) < len(key_vals):
            nl.append(nl[-1] if nl else False)
        perm = sort_perm(key_vals, desc, nl, tt.rowmask)
        cols = {n: apply_perm(v, perm) for n, v in tt.cols.items()}
        # masked-out rows sort last, so the mask becomes a prefix
        mask = tt.rowmask.index_select(0, perm)
        if node.limit is not None:
            mask[node.limit:] = False
        return TTable(cols, mask)

    if isinstance(node, L.LGroupBy):
        return _trace_groupby(trace_node(node.input, tc), node, tc)

    if isinstance(node, L.LRename):
        tt = trace_node(node.input, tc)
        mapping = dict(node.mapping)
        return TTable({mapping.get(n, n): v for n, v in tt.cols.items()}, tt.rowmask)

    if isinstance(node, L.LDrop):
        tt = trace_node(node.input, tc)
        return TTable({n: v for n, v in tt.cols.items() if n not in node.columns}, tt.rowmask)

    if isinstance(node, L.LWithRowIndex):
        tt = trace_node(node.input, tc)
        rank = torch.cumsum(tt.rowmask, 0, dtype=torch.int64) + (node.offset - 1)  # UInt32 is int64 here
        return TTable({node.name: Val(rank, None, dt.UInt32(), None, ROW), **tt.cols}, tt.rowmask)

    if isinstance(node, L.LDistinct):
        tt = trace_node(node.input, tc)
        subset = node.subset if node.subset is not None else tuple(tt.cols)
        keep = _distinct_rowmask([tt.cols[c] for c in subset], tt.rowmask, node.keep)
        return TTable(tt.cols, tt.rowmask & keep)

    if isinstance(node, L.LUnion):
        return _trace_union([trace_node(i, tc) for i in node.inputs_])

    if isinstance(node, L.LExplode):
        return _trace_explode(trace_node(node.input, tc), node.columns, tc)

    if isinstance(node, L.LHConcat):
        return _trace_hconcat([trace_node(i, tc) for i in node.inputs_])

    raise InvalidOperationError(f"cannot run {type(node).__name__} in a segment")


def _distinct_rowmask(keys: list[Val], rowmask: torch.Tensor, keep: str) -> torch.Tensor:
    """The rows ``unique`` keeps, in place (no reordering): a stable argsort
    of the key words puts equal keys next to each other in row order, and a
    row is kept by its place in its run of equals (``keep`` any or first:
    the first; last: the last; none: a run of one). A null is one value
    whatever lies under it; rows outside ``rowmask`` sort last and match
    nothing."""
    words = [(~rowmask).to(torch.int8)]
    for k in keys:
        kw = val_words(k)
        if k.validity is not None:
            words.append((~k.validity).to(torch.int8))
            kw = [torch.where(k.validity, w, torch.zeros((), dtype=w.dtype, device=w.device)) for w in kw]
        words.extend(kw)
    perm = stable_argsort_words(words)
    # the mask word is among the words, so a run never spans kept and
    # masked rows
    same_prev = ~boundaries_from_words(words, perm) & rowmask.index_select(0, perm)
    same_next = torch.zeros_like(same_prev)
    same_next[:-1] = same_prev[1:]
    if keep in ("any", "first"):
        flag = ~same_prev
    elif keep == "last":
        flag = ~same_next
    else:
        flag = ~(same_prev | same_next)
    return torch.empty_like(flag).index_copy_(0, perm, flag)


def _trace_explode(tt: TTable, columns: tuple[str, ...], tc: _TraceCtx) -> TTable:
    """Each kept row once per element of its lists (one row with a null for
    a null or empty list): the exploded columns take their elements, the
    others repeat. The lists of one row must have one length (a check on
    the segment's count read). One host read: the output's length."""
    first = tt.cols[columns[0]]
    owner, pos = NS.explode_index(first, tt.rowmask)
    lens = NS.explode_lens(first)
    for c in columns[1:]:
        bad = (NS.explode_lens(tt.cols[c]) != lens) & tt.rowmask
        tc.flags.append((bad.any(), "exploded columns must have matching element counts", ShapeError))
    cols = {}
    for name, v in tt.cols.items():
        cols[name] = NS.exploded(v, owner, pos) if name in columns else NS.gather_val(v, owner)
    return TTable(cols, torch.ones(owner.shape[0], dtype=torch.bool, device=owner.device))


def _trace_union(tts: list[TTable]) -> TTable:
    """The inputs' rows one after another, each column cast to the
    supertype of its pieces and string columns put on one dictionary."""
    cols: dict[str, Val] = {}
    for n in tts[0].cols:
        vals = [t.cols[n] for t in tts]
        cols[n] = concat_vals(vals, functools.reduce(supertype, (v.dtype for v in vals)))
    return TTable(cols, torch.cat([t.rowmask for t in tts]))


def _trace_hconcat(tts: list[TTable]) -> TTable:
    """The inputs' kept rows side by side by rank, without a host read: row
    r of each input is its r-th kept row (gathered through a scatter of
    positions by rank), null past its count, as Polars pads a shorter
    frame."""
    rows = max(t.rowmask.shape[0] for t in tts)
    iota = torch.arange(rows, device=tts[0].rowmask.device)
    cols: dict[str, Val] = {}
    mask = torch.zeros(rows, dtype=torch.bool, device=iota.device)
    for t in tts:
        n = t.rowmask.shape[0]
        rank = torch.cumsum(t.rowmask, 0, dtype=torch.int64) - 1
        present = iota < (rank[-1] + 1 if n else 0)
        pos = torch.zeros(rows + 1, dtype=torch.int64, device=iota.device)
        pos.index_copy_(0, torch.where(t.rowmask, rank, rows), torch.arange(n, device=iota.device))
        pos = pos[:rows]
        mask |= present
        for name, v in t.cols.items():
            if n:
                values = v.values.index_select(0, pos)
                validity = present if v.validity is None else present & v.validity.index_select(0, pos)
            else:
                values = torch.zeros(rows, dtype=v.values.dtype, device=iota.device)
                validity = present
            cols[name] = v.with_(values=values, validity=validity, domain=ROW)
    return TTable(cols, mask)


def _trace_select(tt: TTable, expressions: tuple[E.ENode, ...], tc: _TraceCtx, *, keep_input: bool) -> TTable:
    """select / with_columns. Aggregations reduce over one group of
    capacity 1 (``compiler.group_of``), their sums and counts batched into K1
    calls by :func:`_batch_aggs` as a group-by's are; a select of only
    scalars is a one-row table.

    A column of another length (a filter, slice or gather outside an
    aggregation, ``compiler.eval_piece``) comes with the mask of the rows it
    keeps: where every column keeps the same rows (a bare filter, say), that
    mask is the table's, and K2 compacts it at the segment's end; columns
    that keep different rows are lined up by rank (their counts must agree,
    a check on the segment's count read)."""
    ctx = _eval_ctx(tt, tc)
    exprs = expand_exprs(expressions, tt.schema())
    if not all(E.is_elementwise(e) for e in exprs):
        ctx.precomputed = _batch_aggs(exprs, ctx)
    results: list[tuple[str, Val, torch.Tensor | None]] = []
    for e in exprs:
        if E.changes_length(e):
            v, keep = eval_piece(e, ctx)
        else:
            v = eval_expr(e, ctx)
            reject_series(v)
            keep = None if v.domain == SCALAR else tt.rowmask
        if v.domain == GROUP:
            raise ShapeError("group-domain expression outside aggregation")
        results.append((E.output_name(e) or "literal", v, keep))
    if not keep_input and results and all(keep is None for _, _, keep in results):
        one = torch.ones(1, dtype=torch.bool, device=tt.rowmask.device)
        return TTable({name: _as_rows(v, 1) for name, v, _ in results}, one)
    pieces = [(v, tt.rowmask) for v in tt.cols.values()] if keep_input else []
    pieces += [(v, keep) for _, v, keep in results]
    vals, mask = align_pieces(ctx, pieces)
    mask = tt.rowmask if mask is None else mask
    names = (list(tt.cols) if keep_input else []) + [name for name, _, _ in results]
    cols: dict[str, Val] = {}
    for name, v in zip(names, vals):
        cols[name] = _as_rows(v, mask.shape[0])
    return TTable(cols, mask)


def _decode_dense_key(gctx, sizes: list[int], i: int) -> torch.Tensor:
    """Key i's code of every group, from the group's dense slot (-1 = null)."""
    stride = 1
    for s in sizes[i + 1:]:
        stride *= s + 1
    return torch.div(gctx.slots, stride, rounding_mode="floor") % (sizes[i] + 1) - 1


def _dense_parts(kv: Val) -> list[Val] | None:
    """The dictionary-coded or Boolean values a key groups by on the dense
    path: the key itself, or a Struct's validity (as a Boolean) and its
    fields at its rows, a null Struct's fields made null so that its rows
    are one group; None for any other key."""
    if kv.table is not None or isinstance(kv.dtype, dt.Boolean):
        return [kv]
    if not isinstance(kv.dtype, dt.Struct) or not kv.dtype.fields:
        return None
    from polars_tpu_torch.kernels.nested_keys import struct_fields

    fields = struct_fields(kv)
    if not all(f.table is not None or isinstance(f.dtype, dt.Boolean) for f in fields):
        return None
    if kv.validity is None:
        return fields
    own = Val(kv.validity, None, dt.Boolean(), None, kv.domain)
    return [own, *(f.with_(validity=kv.validity if f.validity is None else f.validity & kv.validity)
                   for f in fields)]


def _decoded_key(gctx, sizes: list[int], i: int, part: Val) -> Val:
    """Part i of the dense keys, per group, from the group's dense slot."""
    code = _decode_dense_key(gctx, sizes, i)
    values = (code.clamp(min=0) > 0) if isinstance(part.dtype, dt.Boolean) else \
        code.clamp(min=0).to(part.values.dtype)
    return Val(values, None if part.validity is None else code >= 0, part.dtype, part.table, ROW)


def _trace_groupby(tt: TTable, node: L.LGroupBy, tc: _TraceCtx) -> TTable:
    schema = tt.schema()
    keys = expand_exprs(node.keys, schema)
    aggs = expand_exprs(node.aggs, schema)
    ctx = _eval_ctx(tt, tc)
    key_vals = [(E.output_name(k) or "literal", eval_expr(k, ctx)) for k in keys]
    for _, kv in key_vals:
        if kv.domain == SCALAR:
            raise ShapeError("scalar group keys not supported")

    # dense (perfect-hash) path for dictionary-coded/bool keys, a Struct of
    # such fields by its fields (and its validity)
    parts = [_dense_parts(kv) for _, kv in key_vals]
    flat = [p for ps in parts if ps is not None for p in ps]
    dense_ok = bool(key_vals) and all(ps is not None for ps in parts)
    sizes = [max(len(p.table), 1) if p.table is not None else 2 for p in flat]
    if dense_ok:
        prod = 1
        for s in sizes:
            prod *= s + 1
        dense_ok = prod <= DENSE_MAX_CAP
    if dense_ok:
        gctx = G.dense_group_ctx(flat, tt.rowmask, sizes)
    else:
        gctx = G.sorted_group_ctx([kv for _, kv in key_vals], tt.rowmask)
    if node.maintain_order:
        gctx = G.reorder_by_first_occurrence(gctx, tt.rowmask)

    out_cols: dict[str, Val] = {}
    if dense_ok:
        # keys decoded from each group's dense slot: no pass over the rows
        at = 0
        for (name, kv), ps in zip(key_vals, parts):
            decoded = [_decoded_key(gctx, sizes, at + j, p) for j, p in enumerate(ps)]
            at += len(ps)
            if not isinstance(kv.dtype, dt.Struct):
                out_cols[name] = decoded[0]
                continue
            validity = None
            if kv.validity is not None:  # the first part: the Struct's own validity
                validity, decoded = decoded[0].values, decoded[1:]
            ids = torch.arange(gctx.capacity, dtype=torch.int64, device=tt.rowmask.device)
            out_cols[name] = Val(ids, validity, kv.dtype, None, ROW, tuple(decoded))
    else:
        # keys read at each group's first row (a nested key with its child)
        rep_idx, rep_has = G.seg_first_idx(tt.rowmask, gctx.gids, gctx.capacity)
        for name, kv in key_vals:
            values = kv.values.index_select(0, rep_idx)
            validity = None if kv.validity is None else kv.validity.index_select(0, rep_idx) & rep_has
            out_cols[name] = kv.with_(values=values, validity=validity, domain=ROW)

    gctx_ctx = EvalCtx(
        cols=dict(tt.cols), rowmask=tt.rowmask, groups=gctx, memo={}, flags=tc.flags,
    )
    gctx_ctx.precomputed = _batch_aggs(aggs, gctx_ctx)
    for a in aggs:
        name = E.output_name(a) or "literal"
        if E.changes_length(a) and not E.reduces_in_agg(a) and not isinstance(_unalias(a), E.EGather):
            # a filter or slice left as it is: each group's kept rows as a List
            v, mask = _agg_input(a, gctx_ctx)
            out_cols[name] = NS.implode(_sub_ctx(gctx_ctx, mask, {}), v, GROUP).with_(domain=ROW)
            continue
        v = eval_expr(a, gctx_ctx)
        if v.domain == ROW:  # a non-reducing expression: each group's rows as a List
            v = NS.implode(gctx_ctx, v, GROUP)
        elif not E.reduces_in_agg(a) and v.domain == GROUP and not isinstance(v.dtype, dt.List):
            # one value per group where the schema has a List: a List of it
            v = NS.one_per_list(v)
        if v.domain == SCALAR:
            v = v.with_(values=v.values.expand(gctx.capacity),
                        validity=None if v.validity is None else v.validity.expand(gctx.capacity))
        out_cols[name] = v.with_(domain=ROW)
    return TTable(out_cols, gctx.group_valid)


def _unalias(e: E.ENode) -> E.ENode:
    while isinstance(e, E.EAlias):
        e = e.input
    return e


def _batch_aggs(aggs, ctx: EvalCtx) -> dict:
    """Run every sum-class aggregation of a group-by (or, outside one, of a
    select over its one group) as ONE kernel K1 call per accumulation dtype
    (f64 for float sums and means, i64 for integer sums and counts), reading
    the columns in place; min/max follow per column.

    The JAX version materializes ``where(mask, v, 0)`` per column and a
    column of ones per mean. Here the kernel applies the segment's row mask
    itself; a column with its own validity is ``where``-masked before the
    call, and every count over the row mask reads the group counts
    (``groupby.group_counts``: the dense path's occupancy pass already took
    them). Columns that evaluate to the same tensor under the same mask are
    summed once.
    """
    gctx, dom = group_of(ctx), _agg_domain(ctx)
    cap = gctx.capacity
    f_cols: list = []
    i_cols: list = []
    slot_of: dict = {("count", None): ("rows", 0)}  # dedupe key -> (batch, index)

    def slot(batch: str, key, make):
        if key not in slot_of:
            cols = f_cols if batch == "f" else i_cols
            cols.append(make())
            slot_of[key] = (batch, len(cols) - 1)
        return slot_of[key]

    def count_slot(v: Val | None):
        if v is None or v.validity is None:
            return slot_of[("count", None)]
        return slot("i", ("count", id(v.validity)), lambda: v.validity.to(torch.int64))

    def value_slot(v: Val, batch: str):
        acc = torch.float64 if batch == "f" else torch.int64
        key = ("value", batch, id(v.values), None if v.validity is None else id(v.validity))

        def make():
            if batch == "i":
                x = v.values.to(acc)
            elif isinstance(v.dtype, dt.Decimal):  # a mean of the logical values
                x = decimal_to_float(v.values, v.dtype.scale, acc)
            else:
                x = float_values(v.values, v.dtype, acc)
            if v.validity is not None:
                x = torch.where(v.validity, x, torch.zeros((), dtype=acc, device=x.device))
            return x.contiguous()

        return slot(batch, key, make)

    def half_slot(v: Val, shift: int):
        def make():
            x = v.values.to(torch.int64)
            x = x >> 32 if shift else x & 0xFFFFFFFF
            return (x if v.validity is None else torch.where(v.validity, x, 0)).contiguous()

        return slot("i", ("half", shift, id(v.values), None if v.validity is None else id(v.validity)), make)

    jobs: list = []  # (node, kind, v, slots)
    minmax: list = []
    seen: set = set()
    for a in aggs:
        for sub in E.walk_outside_windows(a):
            if sub in seen:
                continue
            if isinstance(sub, E.ELen):
                seen.add(sub)
                jobs.append((sub, "count", None, (count_slot(None),)))
                continue
            if not isinstance(sub, E.EAgg) or sub.kind not in ("sum", "mean", "count", "len", "min", "max"):
                continue
            if sub.kind == "len":
                if E.changes_length(sub.input):  # a filter or slice under it: compiler._eval_agg
                    continue
                seen.add(sub)
                jobs.append((sub, "count", None, (count_slot(None),)))
                continue
            if not E.is_elementwise(sub.input):
                continue
            v = eval_expr(sub.input, ctx)
            if v.domain != ROW or v.table is not None or isinstance(v.dtype, dt.Time) or v.dtype.is_nested():
                continue  # evaluated on its own by compiler._eval_agg
            seen.add(sub)
            if sub.kind in ("min", "max"):
                minmax.append((sub, v))
            elif sub.kind == "count":
                jobs.append((sub, "count", v, (count_slot(v),)))
            elif sub.kind == "mean":
                jobs.append((sub, "mean", v, (value_slot(v, "f"), count_slot(v))))
            elif v.dtype.is_float():
                jobs.append((sub, "sum", v, (value_slot(v, "f"),)))
            elif isinstance(v.dtype, dt.Decimal):  # high and low 32 bits apart: a sum past int64 is seen
                jobs.append((sub, "dsum", v, (half_slot(v, 32), half_slot(v, 0))))
            else:  # exact integer/bool sums in i64
                jobs.append((sub, "sum", v, (value_slot(v, "i"),)))

    tables = {}
    for batch, cols, acc in (("f", f_cols, torch.float64), ("i", i_cols, torch.int64)):
        if cols and cap == 0:  # a group-by over no rows has no group, and K1 takes capacity >= 1
            tables[batch] = torch.zeros((0, len(cols)), dtype=acc, device=ctx.device)
        elif cols:
            tables[batch] = groupagg_sums(gctx.gids, cols, ctx.rowmask, cap)

    def col(s):
        batch, idx = s
        if batch == "rows":
            return G.group_counts(gctx, ctx.rowmask)
        return tables[batch][:, idx]

    out: dict = {}
    for node_a, kind, v, slots in jobs:
        if kind == "count":
            out[node_a] = Val(col(slots[0]), None, dt.UInt32(), None, dom)
        elif kind == "dsum":
            hi, lo = col(slots[0]), col(slots[1])
            hi = hi + (lo >> 32)
            ctx.add_flag(((hi < -(2**31)) | (hi >= 2**31)).any(),
                         f"decimal overflow: a sum of {v.dtype!r} does not fit in 64 bits", ComputeError)
            out[node_a] = Val((hi << 32) | (lo & 0xFFFFFFFF), None, _agg_out_dtype(node_a, v.dtype), None, dom)
        elif kind == "mean":
            s, c = col(slots[0]), col(slots[1])
            out_dt = _agg_out_dtype(node_a, v.dtype)
            out[node_a] = Val(mean_values(s / c.clamp(min=1).to(torch.float64), v.dtype, out_dt), c > 0,
                              out_dt, None, dom)
        else:
            out_dt = _agg_out_dtype(node_a, v.dtype)
            s = wrap_unsigned(col(slots[0]).to(dt.dtype_to_torch(out_dt)), out_dt)
            out[node_a] = Val(s, None, out_dt, None, dom)

    for node_a, v in minmax:
        m = ctx.rowmask if v.validity is None else (ctx.rowmask & v.validity)
        has = (G.group_counts(gctx, ctx.rowmask) if v.validity is None else G.seg_count(m, gctx.gids, cap)) > 0
        out[node_a] = Val(G.seg_extreme(node_a.kind, v, m, gctx.gids, cap), has, v.dtype, v.table, dom)
    return out


# ---------------------------------------------------------------------------
# materialization
# ---------------------------------------------------------------------------


def _df_to_ttable(df: DataFrame) -> TTable:
    cols = {c.name: col_to_val(c) for c in df._columns}
    return TTable(cols, torch.ones(df.height, dtype=torch.bool, device=df.device))


def _read_count(count: torch.Tensor, flags: list) -> int:
    """The segment's one host read: the survivor count (K2's device total),
    with the validation flags riding it as in the JAX package. A raised flag
    turns the count negative with its index in the high word (the earliest
    raised flag wins). Each flag encodes the TRUE count: the JAX loop
    re-negates an already negated count, so two raised flags cancel there. A
    flag with a message raises InvalidOperationError (or the error class
    the flag names); a join's cardinality flag (no message) raises
    ComputeError, as in the JAX package."""
    code = count
    for i in range(len(flags) - 1, -1, -1):
        code = torch.where(flags[i][0], -(count + 1 + (i << 32)), code)
    n = int(code)
    if n < 0:
        flag = flags[(-n - 1) >> 32]
        if flag[1] is not None:
            raise (flag[2] if len(flag) > 2 else InvalidOperationError)(flag[1])
        raise ComputeError(
            "in-trace validation failed: join keys do not satisfy the declared m:1/1:1/1:m cardinality"
        )
    return n


def run_segment(node: L.LNode, leaf_dfs: list[tuple[L.LNode, DataFrame]]) -> DataFrame:
    """Run one fused segment rooted at ``node`` over its materialized leaf
    frames ``leaf_dfs``, ending in one compaction and one host read."""
    out_schema = node_schema(node)
    tc = _TraceCtx({id(lnode): _df_to_ttable(df) for lnode, df in leaf_dfs})
    tt = trace_node(node, tc)

    # compact: surviving rows first, every output column (values and
    # validity) in one kernel K2 pass over the row mask; K2's device total,
    # with the flags on it, is the one value read to the host
    names = out_schema.names()
    inputs = []
    for name in names:
        v = tt.cols[name]
        inputs.append(v.values.to(dt.dtype_to_torch(out_schema[name])).contiguous())
        if v.validity is not None:
            inputs.append(v.validity.contiguous())
    mask = tt.rowmask.contiguous()
    offs = compact_count(mask)
    n = _read_count(offs[-1], tc.flags)
    outs = compact_scatter(inputs, mask, offs, n)
    it = iter(outs)
    cols = []
    for name in names:
        values = next(it)
        validity = next(it) if tt.cols[name].validity is not None else None
        v = tt.cols[name]
        cols.append(Column(name, out_schema[name], Buffer(values, validity, n), v.table,
                           child_column(v, out_schema[name])))
    return DataFrame._from_columns(cols, n, device=tt.rowmask.device)

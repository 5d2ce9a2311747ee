"""Plan execution: one fused segment between barriers (the port of
``polars_tpu/engine/executors.py``: ``TTable``, ``trace_node``,
``_trace_groupby``, ``_batch_aggs`` and ``run_segment``).

A segment is a chain of filter/select/with_columns/group-by/sort nodes over
its leaf frames. Filters only narrow a row mask; group-by outputs stay
capacity-sized with the group count on the device. The segment ends in one
compaction of every output column (kernel K2), whose survivor count is the
segment's single host read-back. The JAX package compiles each segment into
one XLA program and caches it; PyTorch runs eagerly, so the port has no jit
cache and no formulation toggles.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from polars_tpu_torch import datatypes as dt
from polars_tpu_torch.config import DENSE_MAX_CAP
from polars_tpu_torch.core.buffer import Buffer
from polars_tpu_torch.core.column import Column
from polars_tpu_torch.core.frame import DataFrame
from polars_tpu_torch.core.schema import Schema
from polars_tpu_torch.engine import groupby as G
from polars_tpu_torch.engine.cast import float_values, wrap_unsigned
from polars_tpu_torch.engine.common import GROUP, ROW, SCALAR, EvalCtx, Val
from polars_tpu_torch.engine.compiler import _agg_out_dtype, eval_expr
from polars_tpu_torch.engine.sort import apply_perm, sort_perm
from polars_tpu_torch.errors import ComputeError, InvalidOperationError, ShapeError
from polars_tpu_torch.kernels.compact import compact
from polars_tpu_torch.kernels.groupagg import groupagg_sums
from polars_tpu_torch.plan import exprs as E
from polars_tpu_torch.plan import logical as L
from polars_tpu_torch.plan.schema_resolve import expand_exprs, node_schema

# ---------------------------------------------------------------------------
# segment table
# ---------------------------------------------------------------------------


@dataclass
class TTable:
    cols: dict[str, Val]  # all ROW domain, tensors of one length
    rowmask: torch.Tensor

    def schema(self) -> Schema:
        return Schema([(n, v.dtype) for n, v in self.cols.items()])


_FUSABLE = (L.LFilter, L.LSelect, L.LWithColumns, L.LSort, L.LGroupBy)


def _is_fusable(node: L.LNode) -> bool:
    return isinstance(node, _FUSABLE)


class _TraceCtx:
    """State while running one segment."""

    def __init__(self, leaf_tables: dict[int, TTable]):
        self.leaf_tables = leaf_tables  # id(node) -> TTable
        self.flags: list = []  # (bool 0-d tensor, message): validation failures


def _eval_ctx(tt: TTable, tc: _TraceCtx) -> EvalCtx:
    return EvalCtx(cols=dict(tt.cols), rowmask=tt.rowmask, memo={}, flags=tc.flags)


def _as_rows(v: Val, rows: int) -> Val:
    """A SCALAR value broadcast to ``rows`` rows."""
    if v.domain != SCALAR:
        return v
    return Val(
        v.values.expand(rows), None if v.validity is None else v.validity.expand(rows),
        v.dtype, v.table, ROW,
    )


def trace_node(node: L.LNode, tc: _TraceCtx) -> TTable:
    if id(node) in tc.leaf_tables:
        return tc.leaf_tables[id(node)]

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
        return TTable(cols, tt.rowmask.index_select(0, perm))

    if isinstance(node, L.LGroupBy):
        return _trace_groupby(trace_node(node.input, tc), node, tc)

    raise InvalidOperationError(f"cannot run {type(node).__name__} in a segment")


def _trace_select(tt: TTable, expressions: tuple[E.ENode, ...], tc: _TraceCtx, *, keep_input: bool) -> TTable:
    ctx = _eval_ctx(tt, tc)
    results: list[tuple[str, Val]] = []
    for e in expand_exprs(expressions, tt.schema()):
        v = eval_expr(e, ctx)
        if v.domain == GROUP:
            raise ShapeError("group-domain expression outside aggregation")
        results.append((E.output_name(e) or "literal", v))
    if not keep_input and results and all(v.domain == SCALAR for _, v in results):
        raise NotImplementedError(
            "a select of only scalars (one-row result) is not ported yet (port queue: expression breadth)"
        )
    cols = dict(tt.cols) if keep_input else {}
    rows = tt.rowmask.shape[0]
    for name, v in results:
        cols[name] = _as_rows(v, rows)
    return TTable(cols, tt.rowmask)


def _decode_dense_key(gctx, sizes: list[int], i: int) -> torch.Tensor:
    """Key i's code of every group, from the group's dense slot (-1 = null)."""
    stride = 1
    for s in sizes[i + 1:]:
        stride *= s + 1
    return torch.div(gctx.slots, stride, rounding_mode="floor") % (sizes[i] + 1) - 1


def _trace_groupby(tt: TTable, node: L.LGroupBy, tc: _TraceCtx) -> TTable:
    schema = tt.schema()
    keys = expand_exprs(node.keys, schema)
    aggs = expand_exprs(node.aggs, schema)
    ctx = _eval_ctx(tt, tc)
    key_vals = [(E.output_name(k) or "literal", eval_expr(k, ctx)) for k in keys]
    for _, kv in key_vals:
        if kv.domain == SCALAR:
            raise ShapeError("scalar group keys not supported")

    # dense (perfect-hash) path for dictionary-coded/bool keys
    sizes = []
    dense_ok = bool(key_vals)
    for _, kv in key_vals:
        if kv.table is not None:
            sizes.append(max(len(kv.table), 1))
        elif isinstance(kv.dtype, dt.Boolean):
            sizes.append(2)
        else:
            dense_ok = False
            break
    if dense_ok:
        prod = 1
        for s in sizes:
            prod *= s + 1
        dense_ok = prod <= DENSE_MAX_CAP
    if not dense_ok:
        G.sorted_group_ctx([kv for _, kv in key_vals], tt.rowmask)  # raises: later slice
    if node.maintain_order:
        raise NotImplementedError(
            "group_by(maintain_order=True) is not ported yet (port queue: Q3/Q4 slice)"
        )
    gctx = G.dense_group_ctx([kv for _, kv in key_vals], tt.rowmask, sizes)

    out_cols: dict[str, Val] = {}
    for i, (name, kv) in enumerate(key_vals):
        code = _decode_dense_key(gctx, sizes, i)
        values = (code.clamp(min=0) > 0) if isinstance(kv.dtype, dt.Boolean) else code.clamp(min=0).to(kv.values.dtype)
        validity = None if kv.validity is None else code >= 0
        out_cols[name] = Val(values, validity, kv.dtype, kv.table, ROW)

    gctx_ctx = EvalCtx(
        cols=dict(tt.cols), rowmask=tt.rowmask, groups=gctx, memo={}, flags=tc.flags,
    )
    gctx_ctx.precomputed = _batch_aggs(aggs, gctx_ctx)
    for a in aggs:
        name = E.output_name(a) or "literal"
        v = eval_expr(a, gctx_ctx)
        if v.domain == ROW:
            raise InvalidOperationError(f"expression for {name!r} does not aggregate; wrap it in an aggregation")
        if v.domain == SCALAR:
            v = Val(
                v.values.expand(gctx.capacity),
                None if v.validity is None else v.validity.expand(gctx.capacity),
                v.dtype, v.table, GROUP,
            )
        out_cols[name] = Val(v.values, v.validity, v.dtype, v.table, ROW)
    return TTable(out_cols, gctx.group_valid)


def _batch_aggs(aggs, ctx: EvalCtx) -> dict:
    """Run every sum-class aggregation of a group-by as ONE kernel K1 call
    per accumulation dtype (f64 for float sums and means, i64 for integer
    sums and counts), reading the columns in place; min/max follow per column.

    The JAX version materializes ``where(mask, v, 0)`` per column and a
    column of ones per mean. Here the kernel applies the segment's row mask
    itself; a column with its own validity is ``where``-masked before the
    call, and every count over the row mask reads the group counts that
    ``dense_group_ctx`` already took. Columns that evaluate to the same
    tensor under the same mask are summed once.
    """
    gctx = ctx.groups
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
            x = float_values(v.values, v.dtype, acc) if batch == "f" else v.values.to(acc)
            if v.validity is not None:
                x = torch.where(v.validity, x, torch.zeros((), dtype=acc, device=x.device))
            return x.contiguous()

        return slot(batch, key, make)

    jobs: list = []  # (node, kind, v, slots)
    minmax: list = []
    seen: set = set()
    for a in aggs:
        for sub in E.walk(a):
            if sub in seen:
                continue
            if isinstance(sub, E.ELen):
                seen.add(sub)
                jobs.append((sub, "count", None, (count_slot(None),)))
                continue
            if not isinstance(sub, E.EAgg) or sub.kind not in ("sum", "mean", "count", "len", "min", "max"):
                continue
            if sub.kind == "len":
                seen.add(sub)
                jobs.append((sub, "count", None, (count_slot(None),)))
                continue
            if not E.is_elementwise(sub.input):
                continue
            v = eval_expr(sub.input, ctx)
            if v.domain != ROW or v.table is not None or v.dtype.is_temporal():
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
            else:  # exact integer/bool sums in i64
                jobs.append((sub, "sum", v, (value_slot(v, "i"),)))

    tables = {"rows": gctx.counts[:, None]}
    if f_cols:
        tables["f"] = groupagg_sums(gctx.gids, f_cols, ctx.rowmask, cap)
    if i_cols:
        tables["i"] = groupagg_sums(gctx.gids, i_cols, ctx.rowmask, cap)

    def col(s):
        batch, idx = s
        return tables[batch][:, idx]

    out: dict = {}
    for node_a, kind, v, slots in jobs:
        if kind == "count":
            out[node_a] = Val(col(slots[0]), None, dt.UInt32(), None, GROUP)
        elif kind == "mean":
            s, c = col(slots[0]), col(slots[1])
            out_dt = _agg_out_dtype(node_a, v.dtype)
            out[node_a] = Val(
                (s / c.clamp(min=1).to(torch.float64)).to(dt.dtype_to_torch(out_dt)), c > 0, out_dt, None, GROUP,
            )
        else:
            out_dt = _agg_out_dtype(node_a, v.dtype)
            s = wrap_unsigned(col(slots[0]).to(dt.dtype_to_torch(out_dt)), out_dt)
            out[node_a] = Val(s, None, out_dt, None, GROUP)

    for node_a, v in minmax:
        m = ctx.rowmask if v.validity is None else (ctx.rowmask & v.validity)
        has = (gctx.counts if v.validity is None else G.seg_count(m, gctx.gids, cap)) > 0
        out[node_a] = Val(G.seg_extreme(node_a.kind, v, m, gctx.gids, cap), has, v.dtype, v.table, GROUP)
    return out


# ---------------------------------------------------------------------------
# materialization
# ---------------------------------------------------------------------------


def _df_to_ttable(df: DataFrame) -> TTable:
    cols = {c.name: Val(c.buffer.values, c.buffer.validity, c.dtype, c.table, ROW) for c in df._columns}
    return TTable(cols, torch.ones(df.height, dtype=torch.bool, device=df.device))


def _raise_flags(tt: TTable, flags: list) -> None:
    """Validation failures ride the count read-back as a negated count with
    the flag's index in the high word (earliest flag wins), as in the JAX
    package: one host read for all of them. Each flag encodes the TRUE count:
    the JAX loop re-negates an already negated count, so two raised flags
    cancel there."""
    count = tt.rowmask.sum().to(torch.int64)
    code = count
    for i in range(len(flags) - 1, -1, -1):
        code = torch.where(flags[i][0], -(count + 1 + (i << 32)), code)
    n = int(code)
    if n < 0:
        idx = (-n - 1) >> 32
        raise InvalidOperationError(flags[idx][1])


def run_segment(node: L.LNode, leaf_dfs: list[tuple[L.LNode, DataFrame]]) -> DataFrame:
    """Run one fused segment rooted at ``node`` over its materialized leaf
    frames ``leaf_dfs``, ending in one compaction."""
    out_schema = node_schema(node)
    tc = _TraceCtx({id(lnode): _df_to_ttable(df) for lnode, df in leaf_dfs})
    tt = trace_node(node, tc)
    if tc.flags:
        _raise_flags(tt, tc.flags)

    # compact: surviving rows first, every output column (values and
    # validity) in one kernel K2 pass over the row mask
    names = out_schema.names()
    inputs = []
    for name in names:
        v = tt.cols[name]
        inputs.append(v.values.to(dt.dtype_to_torch(out_schema[name])).contiguous())
        if v.validity is not None:
            inputs.append(v.validity.contiguous())
    outs, n = compact(inputs, tt.rowmask.contiguous())
    it = iter(outs)
    cols = []
    for name in names:
        values = next(it)
        validity = next(it) if tt.cols[name].validity is not None else None
        cols.append(Column(name, out_schema[name], Buffer(values, validity, n), tt.cols[name].table))
    return DataFrame._from_columns(cols, n, device=tt.rowmask.device)

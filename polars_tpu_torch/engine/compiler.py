"""Expression evaluator: AST node -> tensors (the port of
``polars_tpu/engine/compiler.py``'s ``eval_expr``, trimmed to columns,
literals (numeric, bool, null, date and string; lists as literal Series),
casts, arithmetic and comparison with Polars type promotion, string
comparison across dictionaries, Kleene ``&``/``|``, when/then/otherwise,
registered functions (``engine/registry.py``), aliases and the sum, mean,
min, max, count, len, first, last and n_unique aggregations, per group or,
outside a group-by, over one group of capacity 1).

Where the JAX package traces into one XLA program, the port runs each op
eagerly on the tensors of the segment; ``Val.domain`` still tracks per-row,
per-group and scalar values.
"""

from __future__ import annotations

import numpy as np
import torch

from polars_tpu_torch import datatypes as dt
from polars_tpu_torch.engine import groupby as G
from polars_tpu_torch.engine.cast import cast_val, float_values, int_scalar, order_word, wrap_unsigned
from polars_tpu_torch.engine.common import (
    GROUP, ROW, SCALAR, SERIES, EvalCtx, GroupCtx, Val, broadcast_pair, combine_validity, reject_series, take_lut,
)
from polars_tpu_torch.engine.registry import get_spec
from polars_tpu_torch.engine.strings import unify_vals
from polars_tpu_torch.errors import ColumnNotFoundError, InvalidOperationError, ShapeError
from polars_tpu_torch.kernels.fastmath import div_any, floordiv_any, floordiv_u64, mod_any, mod_u64
from polars_tpu_torch.plan import exprs as E
from polars_tpu_torch.plan.schema_resolve import binary_dtype, dyn_literal_value, fit_dyn_dtype, supertype
from polars_tpu_torch.utils import strtable

_CMP = {"==", "!=", "<", "<=", ">", ">="}


def eval_expr(node: E.ENode, ctx: EvalCtx) -> Val:
    if isinstance(node, E.EColumn):
        try:
            return ctx.cols[node.name]
        except KeyError:
            raise ColumnNotFoundError(f"{node.name!r} not found; available: {list(ctx.cols)}") from None
    if ctx.precomputed is not None and node in ctx.precomputed:
        return ctx.precomputed[node]
    # common-subexpression memo: structurally equal subtrees evaluate once
    if ctx.memo is not None and node in ctx.memo:
        return ctx.memo[node]
    val = _eval_expr_uncached(node, ctx)
    if ctx.memo is not None:
        ctx.memo[node] = val
    return val


def _eval_expr_uncached(node: E.ENode, ctx: EvalCtx) -> Val:
    if isinstance(node, E.ELiteral):
        return _eval_literal(node, ctx)
    if isinstance(node, E.ESeriesLit):
        return _eval_series_literal(node, ctx)
    if isinstance(node, E.EAlias):
        return eval_expr(node.input, ctx)
    if isinstance(node, E.ECast):
        return cast_val(eval_expr(node.input, ctx), dt.parse_into_dtype(node.dtype), strict=node.strict)
    if isinstance(node, E.EBinary):
        return _eval_binary(node, ctx)
    if isinstance(node, E.ETernary):
        return _eval_ternary(node, ctx)
    if isinstance(node, E.EAgg):
        return _eval_agg(node, ctx)
    if isinstance(node, E.ELen):
        return Val(G.group_counts(group_of(ctx), ctx.rowmask), None, dt.UInt32(), None, _agg_domain(ctx))
    if isinstance(node, E.EFunction):
        spec = get_spec(node.name)
        args = [eval_expr(i, ctx) for i in node.inputs]
        if len(args) > 1:
            args = _adapt_dyn_literal_vals(node.inputs, args)
        return spec.impl(ctx, args, dict(node.options))
    raise InvalidOperationError(f"cannot evaluate {type(node).__name__}")


# ---------------------------------------------------------------------------
# literals
# ---------------------------------------------------------------------------


def _lit_dtype(value) -> dt.DataType:
    if isinstance(value, bool):
        return dt.Boolean()
    if isinstance(value, int):
        if 2**63 <= value < 2**64:
            return dt.UInt64()  # the one integer type that holds it
        return dt.Int32() if -(2**31) <= value < 2**31 else dt.Int64()
    if isinstance(value, float):
        return dt.Float64()
    raise NotImplementedError(f"literal {value!r} is not ported yet (port queue: expression breadth)")


def _eval_literal(node: E.ELiteral, ctx: EvalCtx) -> Val:
    value = node.value
    dtype = dt.parse_into_dtype(node.dtype) if node.dtype is not None else None
    if value is None:
        d = dtype if dtype is not None else dt.Null()
        if isinstance(d, (dt.String, dt.Categorical, dt.Enum, dt.Binary)):
            raise NotImplementedError("null string literals are not ported yet (port queue: expression breadth)")
        tdt = torch.int32 if isinstance(d, dt.Null) else dt.dtype_to_torch(d)
        return Val(
            torch.zeros(1, dtype=tdt, device=ctx.device),
            torch.zeros(1, dtype=torch.bool, device=ctx.device), d, None, SCALAR,
        )
    if isinstance(value, str):
        if isinstance(dtype, dt.Date):
            days = int(np.datetime64(value, "D").astype(np.int64))
            return Val(torch.tensor([days], dtype=torch.int32, device=ctx.device), None, dtype, None, SCALAR)
        if dtype is not None and not isinstance(dtype, dt.String):
            raise NotImplementedError(
                f"{dtype!r} literals are not ported yet"
                " (port queue: temporal breadth and asof/range joins)")
        # a one-entry sorted dictionary; code 0
        table = strtable.StringTable(np.asarray([value], object), sorted_order=True)
        return Val(torch.zeros(1, dtype=torch.int32, device=ctx.device), None, dt.String(), table, SCALAR)
    d = dtype if dtype is not None else _lit_dtype(value)
    return Val(int_scalar(value, d, ctx.device), None, d, None, SCALAR)


def _eval_series_literal(node: E.ESeriesLit, ctx: EvalCtx) -> Val:
    """A literal Series on the frame's device: a scalar when it holds one
    value (as in the JAX package), else its own (m,) tensor, which only
    ``is_in`` consumes (the JAX package pads it to the frame's rows)."""
    col = node.column
    values = col.buffer.values.to(ctx.device)
    validity = None if col.buffer.validity is None else col.buffer.validity.to(ctx.device)
    return Val(values, validity, col.dtype, col.table, SCALAR if len(col) == 1 else SERIES)


# ---------------------------------------------------------------------------
# binary ops
# ---------------------------------------------------------------------------


def _adapt_dyn_literal_vals(nodes, vals):
    """Untyped numeric literals take the first concrete numeric operand's
    dtype, as schema_resolve.adapt_dyn_literal_dtypes resolves them."""
    target = None
    for n, v in zip(nodes, vals):
        if dyn_literal_value(n) is None and v.dtype.is_numeric():
            target = v.dtype
            break
    if target is None:
        return list(vals)
    out = list(vals)
    for i, n in enumerate(nodes):
        lv = dyn_literal_value(n)
        if lv is None:
            continue
        nd = fit_dyn_dtype(lv, target)
        if nd is not None and nd != out[i].dtype:
            out[i] = Val(int_scalar(lv, nd, out[i].values.device), None, nd, None, SCALAR)
    return out


def _eval_binary(node: E.EBinary, ctx: EvalCtx) -> Val:
    op = node.op
    a = eval_expr(node.left, ctx)
    b = eval_expr(node.right, ctx)
    a, b = _adapt_dyn_literal_vals((node.left, node.right), (a, b))
    a, b, dom = broadcast_pair(a, b)
    if op in ("&", "|") and all(isinstance(v.dtype, (dt.Boolean, dt.Null)) for v in (a, b)):
        return _kleene(op, a, b, dom)
    if op in _CMP:
        return _eval_compare(op, a, b, dom)
    if a.table is not None or b.table is not None:
        raise InvalidOperationError(f"operator {op!r} not supported for strings")
    out_dt = binary_dtype(op, a.dtype, b.dtype)
    values, validity = _arith(op, a, b, out_dt)
    if validity is not None and validity.shape != values.shape:
        validity = validity.expand(values.shape)
    return Val(values, validity, out_dt, None, dom)


def _arith(op: str, a: Val, b: Val, out_dt: dt.DataType):
    if out_dt.is_temporal() or isinstance(out_dt, dt.Decimal) or a.dtype.is_temporal() or b.dtype.is_temporal():
        raise NotImplementedError(
            f"{op!r} on {a.dtype!r} and {b.dtype!r} is not ported yet"
            " (port queue: temporal breadth and asof/range joins)"
        )
    if not out_dt.is_numeric():
        raise InvalidOperationError(f"cannot apply {op!r} to {a.dtype!r} and {b.dtype!r}")
    validity = combine_validity(a.validity, b.validity)
    st = out_dt if op == "/" else supertype(a.dtype, b.dtype)
    av = cast_val(a, st).values
    bv = cast_val(b, st).values
    if op == "+":
        values = av + bv
    elif op == "-":
        values = av - bv
    elif op == "*":
        values = av * bv
    elif op == "/":
        values = div_any(av, bv)
    elif op == "//":
        if st.is_float():
            values = floordiv_any(av, bv)
        else:
            div = floordiv_u64 if isinstance(st, dt.UInt64) else floordiv_any
            values = div(av, torch.where(bv == 0, 1, bv))
            validity = combine_validity(validity, bv != 0)
    elif op == "%":
        if st.is_float():
            values = mod_any(av, bv)
        else:
            mod = mod_u64 if isinstance(st, dt.UInt64) else mod_any
            values = mod(av, torch.where(bv == 0, 1, bv))
            validity = combine_validity(validity, bv != 0)
    else:
        raise NotImplementedError(f"operator {op!r} is not ported yet (port queue: expression breadth)")
    tdt = dt.dtype_to_torch(out_dt)
    if values.dtype != tdt:
        values = values.to(tdt)
    # UInt16/UInt32 live in a wider signed tensor: wrap like the native type
    return wrap_unsigned(values, out_dt), validity


def _scalar_one_table(v: Val) -> bool:
    """A SCALAR with a one-entry dictionary: a string literal."""
    return v.domain == SCALAR and v.table is not None and len(v.table) == 1


def _compare_vs_scalar_lut(op: str, a: Val, b: Val, dom: str) -> Val:
    """Ordering compare of a dictionary column against ONE host-known string
    through a host bool table over the dictionary (O(|dict|) compares)."""
    flip = {"<": ">", ">": "<", "<=": ">=", ">=": "<="}
    if _scalar_one_table(b) and not _scalar_one_table(a):
        col, lit, opx = a, b.table.values[0], op
    else:
        col, lit, opx = b, a.table.values[0], flip[op]
    vals = col.table.values
    lut = {"<": vals < lit, "<=": vals <= lit, ">": vals > lit, ">=": vals >= lit}[opx]
    values = take_lut(np.asarray(lut, dtype=bool), col.values)
    validity = combine_validity(a.validity, b.validity)
    if validity is not None and validity.shape != values.shape:
        validity = validity.expand(values.shape)
    return Val(values, validity, dt.Boolean(), None, dom)


def _string_codes(op: str, a: Val, b: Val) -> tuple[torch.Tensor, torch.Tensor]:
    """The two operands' codes in one code space. Equality probes the smaller
    dictionary into the larger one's codes (-1 = absent, never equal to a
    valid code); ordering unifies both into one sorted dictionary."""
    if a.table is b.table:
        return a.values, b.values
    if op in ("==", "!="):
        if len(a.table) == 0 or len(b.table) == 0:  # an empty dictionary: codes never equal
            return a.values, torch.full_like(b.values, -1)
        if len(b.table) <= len(a.table):
            return a.values, take_lut(strtable.index_in(b.table.values, a.table.values), b.values)
        return take_lut(strtable.index_in(a.table.values, b.table.values), a.values), b.values
    _, lmap, rmap = strtable.unify(a.table, b.table, require_ordinal=True)
    return take_lut(lmap, a.values), take_lut(rmap, b.values)


def _eval_compare(op: str, a: Val, b: Val, dom: str) -> Val:
    if (a.table is not None) != (b.table is not None):
        raise InvalidOperationError(f"cannot compare {a.dtype!r} with {b.dtype!r}")
    if a.table is not None:
        if op not in ("==", "!=") and (_scalar_one_table(a) or _scalar_one_table(b)):
            return _compare_vs_scalar_lut(op, a, b, dom)
        av, bv = _string_codes(op, a, b)
    else:
        st = supertype(a.dtype, b.dtype)
        # UInt64 bit patterns compare as unsigned once their sign bit is flipped
        av, bv = order_word(cast_val(a, st).values, st), order_word(cast_val(b, st).values, st)
    fn = {"==": torch.eq, "!=": torch.ne, "<": torch.lt, "<=": torch.le, ">": torch.gt, ">=": torch.ge}[op]
    values = fn(av, bv)
    validity = combine_validity(a.validity, b.validity)
    if validity is not None and validity.shape != values.shape:
        validity = validity.expand(values.shape)
    return Val(values, validity, dt.Boolean(), None, dom)


def _kleene(op: str, a: Val, b: Val, dom: str) -> Val:
    """SQL three-valued logic for boolean &/| (reference:
    polars-compute/src/boolean.rs Kleene kernels)."""
    av = a.values.to(torch.bool)
    bv = b.values.to(torch.bool)
    if a.validity is None and b.validity is None:
        values = (av & bv) if op == "&" else (av | bv)
        return Val(values, None, dt.Boolean(), None, dom)
    an = torch.zeros_like(av) if a.validity is None else ~a.validity
    bn = torch.zeros_like(bv) if b.validity is None else ~b.validity
    if op == "&":
        known_false = (~an & ~av) | (~bn & ~bv)
        validity = known_false | (~an & ~bn)
        values = (av & bv) & ~(an | bn)
    else:
        known_true = (~an & av) | (~bn & bv)
        validity = known_true | (~an & ~bn)
        values = known_true | (av | bv)
    return Val(values, validity, dt.Boolean(), None, dom)


# ---------------------------------------------------------------------------
# ternary
# ---------------------------------------------------------------------------


def _eval_ternary(node: E.ETernary, ctx: EvalCtx) -> Val:
    """when/then/otherwise: a null predicate picks the otherwise branch
    (reference: if_then_else kernels)."""
    p = eval_expr(node.predicate, ctx)
    t = eval_expr(node.truthy, ctx)
    f = eval_expr(node.falsy, ctx)
    reject_series(p, t, f)
    t, f = _adapt_dyn_literal_vals((node.truthy, node.falsy), (t, f))
    t, f = _unify_branches(t, f)
    doms = {p.domain, t.domain, f.domain} - {SCALAR}
    if len(doms) > 1:
        raise ShapeError("mixed domains in when/then/otherwise")
    dom = doms.pop() if doms else SCALAR
    pv = p.values.to(torch.bool)
    if p.validity is not None:
        pv = pv & p.validity
    values = torch.where(pv, t.values, f.values)
    if t.validity is None and f.validity is None:
        validity = None
    else:
        tv = torch.ones_like(t.values, dtype=torch.bool) if t.validity is None else t.validity
        fv = torch.ones_like(f.values, dtype=torch.bool) if f.validity is None else f.validity
        validity = torch.where(pv, tv, fv).expand(values.shape)
    return Val(values, validity, t.dtype, t.table, dom)


def _unify_branches(t: Val, f: Val) -> tuple[Val, Val]:
    """Both branches in one dtype: strings on one merged dictionary, numbers
    in their supertype; a null literal takes the other branch's type."""
    if t.table is not None or f.table is not None:
        if t.table is not None and f.table is not None:
            return unify_vals(t, f)
        if isinstance(t.dtype, dt.Null):
            return t.with_(dtype=f.dtype, table=f.table), f
        if isinstance(f.dtype, dt.Null):
            return t, f.with_(dtype=t.dtype, table=t.table)
        raise InvalidOperationError("when/then branches mix string and non-string")
    st = supertype(t.dtype, f.dtype)
    return cast_val(t, st), cast_val(f, st)


# ---------------------------------------------------------------------------
# aggregation
# ---------------------------------------------------------------------------


def group_of(ctx: EvalCtx) -> GroupCtx:
    """The context's groups; outside a group-by, one group of capacity 1
    that holds every row (the JAX package's ``_group_of``)."""
    if ctx.groups is not None:
        return ctx.groups
    if ctx.scalar_group is None:
        ctx.scalar_group = G.one_group_ctx(ctx.rowmask)
    return ctx.scalar_group


def _agg_domain(ctx: EvalCtx) -> str:
    """An aggregation yields one value per group, or one scalar outside a
    group-by."""
    return GROUP if ctx.groups is not None else SCALAR


def _eval_agg(node: E.EAgg, ctx: EvalCtx) -> Val:
    gctx, dom = group_of(ctx), _agg_domain(ctx)
    gids, rowmask, cap = gctx.gids, ctx.rowmask, gctx.capacity
    kind = node.kind
    if kind == "len":
        return Val(G.group_counts(gctx, ctx.rowmask), None, dt.UInt32(), None, dom)
    v = eval_expr(node.input, ctx)
    reject_series(v)
    if v.domain == GROUP:
        raise InvalidOperationError("nested aggregations are not supported")
    if v.domain == SCALAR:
        v = v.with_(
            values=v.values.expand(ctx.rows),
            validity=None if v.validity is None else v.validity.expand(ctx.rows),
            domain=ROW,
        )
    data_mask = rowmask if v.validity is None else (rowmask & v.validity)
    if kind == "count":
        return Val(G.seg_count(data_mask, gids, cap), None, dt.UInt32(), None, dom)
    if v.dtype.is_temporal() and kind in ("sum", "mean"):
        raise NotImplementedError(
            f"{kind} of {v.dtype!r} is not ported yet"
            " (port queue: temporal breadth and asof/range joins)")
    if kind == "sum":
        out_dt = _agg_out_dtype(node, v.dtype)
        s = G.seg_sum(v.values.to(dt.dtype_to_torch(out_dt)), data_mask, gids, cap)
        return Val(wrap_unsigned(s, out_dt), None, out_dt, None, dom)  # polars: sum of all-null/empty = 0
    if kind == "mean":
        vals = float_values(v.values, v.dtype, torch.float64) if v.dtype.is_integer() else v.values
        m, has = G.seg_mean(vals, data_mask, gids, cap)
        out_dt = _agg_out_dtype(node, v.dtype)
        return Val(m.to(dt.dtype_to_torch(out_dt)), has, out_dt, None, dom)
    if kind in ("min", "max"):
        if v.table is not None and not v.table.sorted_order:
            raise NotImplementedError("min/max over an unordered dictionary is not ported yet")
        has = G.seg_count(data_mask, gids, cap) > 0
        return Val(G.seg_extreme(kind, v, data_mask, gids, cap), has, v.dtype, v.table, dom)
    if kind in ("first", "last"):
        # Polars' first/last include nulls: the row is picked by position
        # among the group's rows, and its validity goes with it
        fn = G.seg_first_idx if kind == "first" else G.seg_last_idx
        idx, has = fn(rowmask, gids, cap)
        validity = has if v.validity is None else (has & v.validity.index_select(0, idx))
        return Val(v.values.index_select(0, idx), validity, v.dtype, v.table, dom)
    if kind == "n_unique":
        out = G.seg_nunique(v, rowmask, gids, cap)
        return Val(wrap_unsigned(out, dt.UInt32()), None, dt.UInt32(), None, dom)
    raise NotImplementedError(f"aggregation {kind!r} is not ported yet (port queue: expression breadth)")


def _agg_out_dtype(node: E.EAgg, in_dt: dt.DataType) -> dt.DataType:
    from polars_tpu_torch.core.schema import Schema
    from polars_tpu_torch.plan.schema_resolve import agg_dtype

    fake = Schema([("__x", in_dt)])
    return agg_dtype(E.EAgg(E.EColumn("__x"), node.kind, node.options), fake)

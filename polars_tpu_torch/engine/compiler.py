"""Expression evaluator: AST node -> tensors (the port of
``polars_tpu/engine/compiler.py``'s ``eval_expr``, trimmed to columns,
literals (numeric, bool, null, temporal and string; lists as literal
Series), casts, arithmetic (temporal arithmetic on integer epochs, as the
JAX package's ``_arith`` and ``_temporal_pair``) and comparison with Polars
type promotion, string comparison across dictionaries, Kleene ``&``/``|``, when/then/otherwise,
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
        if dtype is not None and dtype.is_temporal():
            iv = torch.tensor([parse_temporal_literal(value, dtype)], dtype=dt.dtype_to_torch(dtype), device=ctx.device)
            return Val(iv, None, dtype, None, SCALAR)
        if dtype is not None and not isinstance(dtype, dt.String):
            raise NotImplementedError(
                f"{dtype!r} literals are not ported yet (port queue: expression breadth)")
        # a one-entry sorted dictionary; code 0
        table = strtable.StringTable(np.asarray([value], object), sorted_order=True)
        return Val(torch.zeros(1, dtype=torch.int32, device=ctx.device), None, dt.String(), table, SCALAR)
    d = dtype if dtype is not None else _lit_dtype(value)
    return Val(int_scalar(value, d, ctx.device), None, d, None, SCALAR)


def parse_temporal_literal(value: str, dtype: dt.DataType) -> int:
    """An ISO date or datetime string as the epoch integer of ``dtype``. A
    string with a UTC offset is that instant; without one, it is the wall
    clock of ``dtype``'s time zone (the earlier instant where the clock
    repeats an hour), or naive."""
    if isinstance(dtype, dt.Date):
        return int(np.datetime64(value, "D").astype(np.int64))
    if isinstance(dtype, dt.Datetime):
        import datetime as _pydt

        try:
            parsed = _pydt.datetime.fromisoformat(value)
        except ValueError:
            parsed = None
        if parsed is None or (parsed.tzinfo is None and not dtype.time_zone):
            return int(np.datetime64(value, dtype.time_unit).astype(np.int64))
        if parsed.tzinfo is None:
            from polars_tpu_torch.kernels.timezone import zone

            parsed = parsed.replace(tzinfo=zone(dtype.time_zone))
        delta = parsed - _pydt.datetime(1970, 1, 1, tzinfo=_pydt.timezone.utc)
        micros = (delta.days * 86_400 + delta.seconds) * 1_000_000 + delta.microseconds
        return micros * dt.TICKS_PER_SECOND[dtype.time_unit] // 1_000_000
    raise InvalidOperationError(f"cannot parse temporal literal for {dtype!r}")


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
    if isinstance(out_dt, dt.Decimal):
        raise NotImplementedError(
            f"{op!r} on {a.dtype!r} and {b.dtype!r} is not ported yet (port queue: expression breadth)")
    if out_dt.is_temporal() or a.dtype.is_temporal() or b.dtype.is_temporal():
        return _temporal_arith(op, a, b, out_dt)
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


_US_PER_DAY = 86_400_000_000


def _temporal_arith(op: str, a: Val, b: Val, out_dt: dt.DataType):
    """Temporal arithmetic on integer epochs (the JAX package's ``_arith``):
    differences and sums of instants and durations on one time scale,
    ``Date ± Duration`` as a Date through microseconds floored to days, and
    a Duration times or floor-divided by a number (division by 0 is null)."""
    an, bn = type(a.dtype).__name__, type(b.dtype).__name__
    validity = combine_validity(a.validity, b.validity)
    if isinstance(out_dt, dt.Duration) and op in ("+", "-") and an in ("Date", "Datetime", "Duration", "Time"):
        av, bv = _temporal_pair(a, b, out_dt)
        return (av - bv if op == "-" else av + bv), validity
    if {an, bn} in ({"Date", "Duration"}, {"Datetime", "Duration"}) and op in ("+", "-"):
        work = dt.Datetime("us") if isinstance(out_dt, dt.Date) else out_dt
        av, bv = _temporal_pair(a, b, work)
        values = av + bv if op == "+" else av - bv
        if isinstance(out_dt, dt.Date):
            values = floordiv_any(values, _US_PER_DAY).to(torch.int32)
        return values, validity
    if isinstance(out_dt, dt.Duration) and op in ("*", "/"):
        av, bv = a.values.to(torch.int64), b.values
        if op == "*":
            return (av * bv).to(torch.int64), validity
        values = floordiv_any(av, torch.where(bv == 0, torch.ones((), dtype=bv.dtype, device=bv.device), bv))
        return values.to(torch.int64), combine_validity(validity, bv != 0)
    if op in ("+", "-") and out_dt.is_temporal():  # e.g. Datetime - Date: both in their supertype
        st = supertype(a.dtype, b.dtype)
        av, bv = cast_val(a, st).values, cast_val(b, st).values
        return (av + bv if op == "+" else av - bv), validity
    raise InvalidOperationError(f"cannot apply {op!r} to {a.dtype!r} and {b.dtype!r}")


def _temporal_pair(a: Val, b: Val, out_dt: dt.DataType) -> tuple[torch.Tensor, torch.Tensor]:
    """Both operands as int64 ticks of ``out_dt``'s time unit (microseconds
    without one): days scale up, finer units floor down, Time is
    nanoseconds."""
    unit = getattr(out_dt, "time_unit", "us")
    per = dt.TICKS_PER_SECOND[unit]

    def ticks(v: Val) -> torch.Tensor:
        x = v.values.to(torch.int64)
        if isinstance(v.dtype, dt.Date):
            return x * (86_400 * per)
        if isinstance(v.dtype, (dt.Datetime, dt.Duration)):
            src = dt.TICKS_PER_SECOND[v.dtype.time_unit]
            return x * (per // src) if per >= src else floordiv_any(x, src // per)
        if isinstance(v.dtype, dt.Time):
            return floordiv_any(x, 1_000_000_000 // per)
        return x

    return ticks(a), ticks(b)


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
    if kind == "sum":
        out_dt = _agg_out_dtype(node, v.dtype)
        s = G.seg_sum(v.values.to(dt.dtype_to_torch(out_dt)), data_mask, gids, cap)
        return Val(wrap_unsigned(s, out_dt), None, out_dt, None, dom)  # polars: sum of all-null/empty = 0
    if kind == "mean":
        as_float = v.dtype.is_integer() or v.dtype.is_temporal()
        vals = float_values(v.values, v.dtype, torch.float64) if as_float else v.values
        m, has = G.seg_mean(vals, data_mask, gids, cap)
        out_dt = _agg_out_dtype(node, v.dtype)
        return Val(mean_values(m, v.dtype, out_dt), has, out_dt, None, dom)
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


def mean_values(m: torch.Tensor, in_dt: dt.DataType, out_dt: dt.DataType) -> torch.Tensor:
    """Float means in the storage of ``out_dt``: a temporal mean truncates
    to whole ticks, and a Date's mean of days becomes milliseconds (its mean
    is a ``Datetime("ms")``; the JAX package reads the days as milliseconds,
    ROADMAP §3)."""
    if isinstance(in_dt, dt.Date):
        m = m * 86_400_000.0
    return m.to(dt.dtype_to_torch(out_dt))


def _agg_out_dtype(node: E.EAgg, in_dt: dt.DataType) -> dt.DataType:
    from polars_tpu_torch.core.schema import Schema
    from polars_tpu_torch.plan.schema_resolve import agg_dtype

    fake = Schema([("__x", in_dt)])
    return agg_dtype(E.EAgg(E.EColumn("__x"), node.kind, node.options), fake)

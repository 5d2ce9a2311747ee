"""Core functions (the port of ``polars_tpu/engine/fn_core.py``): the math
block (the float functions, ``arctan2``, ``log`` with a base, ``abs``,
``negate``, ``sign``, ``round``, ``floor``, ``ceil`` and ``clip``),
``to_physical``, ``not``, the null block (``is_null``, ``is_not_null``,
``is_nan``, ``is_not_nan``, ``is_finite``, ``is_infinite``, ``fill_null``
with a value, ``fill_nan`` and ``coalesce``), ``is_in``, ``is_between``, the
temporal constructors ``make_date``, ``make_datetime`` and
``make_duration``, the distinct flags, the horizontal functions, the bit
counts, ``truncate``, ``reinterpret``, ``round_sig_figs``, the bounds,
``replace`` and ``replace_strict``, ``cut`` and ``hash``; and, reading
other rows than their own, ``search_sorted``, ``rle_id`` and ``qcut``
(in ``fn_position``'s group space). ``unique``, ``unique_counts``,
``int_range``, ``repeat`` and ``shrink_dtype`` run on the host in a select
(``engine/hostops.py``) and refuse anywhere else. All are registered in
``engine/registry.py``."""

from __future__ import annotations

import math

import numpy as np
import torch

from polars_tpu_torch import datatypes as dt
from polars_tpu_torch.engine.cast import cast_val, float_values, order_word, wrap_unsigned
from polars_tpu_torch.engine.common import (
    GROUP, ROW, SCALAR, SERIES, Val, broadcast_pair, combine_validity, flag_rows, reject_series, take_lut,
)
from polars_tpu_torch.engine.registry import BOOL, FLOAT, SAME, SUPER, raises, register
from polars_tpu_torch.errors import InvalidOperationError
from polars_tpu_torch.plan.schema_resolve import supertype
from polars_tpu_torch.utils import strtable


# -- math ---------------------------------------------------------------------------


def _float_vals(v: Val) -> tuple[torch.Tensor, dt.DataType]:
    """``v`` as Float32 if it is one, else as Float64 (the ``FLOAT`` rule)."""
    if isinstance(v.dtype, dt.Float32):
        return v.values, dt.Float32()
    if not (v.dtype.is_numeric() or isinstance(v.dtype, (dt.Boolean, dt.Null))):
        raise InvalidOperationError(f"a float function expects a number, got {v.dtype!r}")
    return float_values(v.values, v.dtype, torch.float64), dt.Float64()


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    """The real cube root: in f64, ``|x|^(1/3)`` and one Newton step (1/3
    is inexact), in ``x``'s float type."""
    a = torch.abs(x.to(torch.float64))
    y = torch.pow(a, 1.0 / 3.0)
    y = torch.where((y > 0) & torch.isfinite(y), y - (y * y * y - a) / (3.0 * y * y), y)
    return (torch.sign(x.to(torch.float64)) * y).to(x.dtype)


def _unary_float(name: str, fn) -> None:
    @register(name, FLOAT)
    def _(ctx, args, opts, _fn=fn):
        v = args[0]
        x, out_dt = _float_vals(v)
        return Val(_fn(x), v.validity, out_dt, None, v.domain)


for _n, _f in [
    ("sqrt", torch.sqrt), ("exp", torch.exp), ("log10", torch.log10), ("log1p", torch.log1p),
    ("cbrt", _cbrt),
    ("sin", torch.sin), ("cos", torch.cos), ("tan", torch.tan), ("cot", lambda x: 1.0 / torch.tan(x)),
    ("arcsin", torch.asin), ("arccos", torch.acos), ("arctan", torch.atan),
    ("sinh", torch.sinh), ("cosh", torch.cosh), ("tanh", torch.tanh),
    ("arcsinh", torch.asinh), ("arccosh", torch.acosh), ("arctanh", torch.atanh),
    ("degrees", torch.rad2deg), ("radians", torch.deg2rad),
]:
    _unary_float(_n, _f)


@register("arctan2", FLOAT)
def _arctan2(ctx, args, opts):
    y, x, dom = broadcast_pair(*args)
    yv, out_dt = _float_vals(y)
    xv = _float_vals(x)[0].to(yv.dtype)
    out = torch.atan2(yv, xv)
    if opts.get("degrees"):
        out = torch.rad2deg(out)
    validity = combine_validity(y.validity, x.validity)
    if validity is not None and validity.shape != out.shape:
        validity = validity.expand(out.shape)
    return Val(out, validity, out_dt, None, dom)


@register("log", FLOAT)
def _log(ctx, args, opts):
    v = args[0]
    x, out_dt = _float_vals(v)
    base = opts.get("base")
    out = torch.log(x) if base is None else torch.log(x) * (1.0 / math.log(base))
    return Val(out, v.validity, out_dt, None, v.domain)


@register("abs", SAME)
def _abs(ctx, args, opts):
    v = args[0]
    if v.dtype.is_unsigned_integer() or isinstance(v.dtype, dt.Boolean):
        return v
    if not (v.dtype.is_numeric() or isinstance(v.dtype, dt.Duration)):
        raise InvalidOperationError(f"`abs` operation not supported for dtype `{v.dtype!r}`")
    return v.with_(values=torch.abs(v.values))


@register("negate", SAME)
def _negate(ctx, args, opts):
    """The same dtype; unsigned, Boolean and String are refused, as in the
    JAX package (Polars: ``FunctionExpr::Negate``). A Decimal negates its
    scaled integer."""
    v = args[0]
    d = v.dtype
    if not ((d.is_integer() and not d.is_unsigned_integer()) or d.is_float()
            or isinstance(d, (dt.Duration, dt.Decimal))):
        raise InvalidOperationError(f"`neg` operation not supported for dtype `{d!r}`")
    return v.with_(values=-v.values)


@register("sign", SAME)
def _sign(ctx, args, opts):
    v = args[0]
    if v.dtype.is_unsigned_integer():  # a UInt64 of 2^63 or more is negative in its storage
        return v.with_(values=(v.values != 0).to(v.values.dtype))
    x = v.values
    out = torch.sign(x)
    if x.is_floating_point():  # the sign of NaN is NaN
        out = torch.where(torch.isnan(x), x, out)
    return v.with_(values=out.to(x.dtype))


@register("round", SAME)
def _round(ctx, args, opts):
    """Half away from zero, as Polars rounds."""
    v = args[0]
    if not v.dtype.is_float():
        return v
    f = 10.0 ** opts.get("decimals", 0)
    x = v.values * f
    return v.with_(values=(torch.sign(x) * torch.floor(torch.abs(x) + 0.5) * (1.0 / f)).to(v.values.dtype))


@register("floor", SAME)
def _floor(ctx, args, opts):
    v = args[0]
    return v.with_(values=torch.floor(v.values)) if v.dtype.is_float() else v


@register("ceil", SAME)
def _ceil(ctx, args, opts):
    v = args[0]
    return v.with_(values=torch.ceil(v.values)) if v.dtype.is_float() else v


@register("clip", SAME)
def _clip(ctx, args, opts):
    """Bounded below and above, each bound cast to the input's dtype (a
    null bound leaves the value as it is)."""
    v = args[0]
    rest = list(args[1:])
    lo = rest.pop(0) if opts.get("has_lower") else None
    hi = rest.pop(0) if opts.get("has_upper") else None
    out, dom = order_word(v.values, v.dtype), v.domain
    for b, pick in ((lo, torch.maximum), (hi, torch.minimum)):
        if b is None:
            continue
        _, b, dom = broadcast_pair(v.with_(domain=dom), b)
        bv = order_word(cast_val(b, v.dtype).values, v.dtype)
        clipped = pick(out, bv)
        out = clipped if b.validity is None else torch.where(b.validity, clipped, out)
    out = order_word(out, v.dtype)
    validity = v.validity
    if validity is not None and validity.shape != out.shape:
        validity = validity.expand(out.shape)
    return Val(out, validity, v.dtype, None, dom)


@register("cast_wrap", lambda dts, opts: opts["dtype"])
def _cast_wrap(ctx, args, opts):
    """``cast(wrap_numerical=True)``: an integer out of the target's range
    wraps into it, as Polars casts (the JAX package ignores the flag)."""
    return cast_val(args[0], opts["dtype"], wrap=True)


def _physical_dtype(d: dt.DataType) -> dt.DataType:
    return {"String": dt.UInt32(), "Categorical": dt.UInt32(), "Enum": dt.UInt32(), "Date": dt.Int32(),
            "Datetime": dt.Int64(), "Duration": dt.Int64(),
            "Time": dt.Int64()}.get(type(d).__name__, d)


@register("to_physical", lambda dts, opts: _physical_dtype(dts[0]))
def _to_physical(ctx, args, opts):
    v = args[0]
    out_dt = _physical_dtype(v.dtype)
    return Val(v.values.to(dt.dtype_to_torch(out_dt)), v.validity, out_dt, None, v.domain)


@register("not", SAME)
def _not(ctx, args, opts):
    v = args[0]
    if isinstance(v.dtype, dt.Boolean):
        return v.with_(values=~v.values.to(torch.bool))
    if v.dtype.is_integer():
        return v.with_(values=wrap_unsigned(torch.bitwise_not(v.values), v.dtype))
    raise InvalidOperationError(f"cannot negate {v.dtype!r}")


# -- null handling ----------------------------------------------------------------


def _valid(v: Val) -> torch.Tensor:
    """``v``'s validity, all true where it has none."""
    if v.validity is not None:
        return v.validity
    return torch.ones(v.values.shape, dtype=torch.bool, device=v.values.device)


def _float_test(v: Val, fn, other: bool) -> Val:
    """``fn`` of a float column (null stays null), ``other`` for any other."""
    if v.dtype.is_float():
        out = fn(v.values)
    else:
        out = torch.full(v.values.shape, other, dtype=torch.bool, device=v.values.device)
    return Val(out, v.validity, dt.Boolean(), None, v.domain)


@register("is_null", BOOL)
def _is_null(ctx, args, opts):
    return Val(~_valid(args[0]), None, dt.Boolean(), None, args[0].domain)


@register("is_not_null", BOOL)
def _is_not_null(ctx, args, opts):
    return Val(_valid(args[0]).clone(), None, dt.Boolean(), None, args[0].domain)


@register("is_nan", BOOL)
def _is_nan(ctx, args, opts):
    return _float_test(args[0], torch.isnan, False)


@register("is_not_nan", BOOL)
def _is_not_nan(ctx, args, opts):
    return _float_test(args[0], lambda x: ~torch.isnan(x), True)


@register("is_finite", BOOL)
def _is_finite(ctx, args, opts):
    return _float_test(args[0], torch.isfinite, True)


@register("is_infinite", BOOL)
def _is_infinite(ctx, args, opts):
    return _float_test(args[0], torch.isinf, False)


def _unified(vals: list[Val]) -> list[Val]:
    """The values in one dtype: strings on one merged dictionary (a null
    literal takes it), anything else cast to the supertype."""
    strs = [v for v in vals if v.table is not None]
    if not strs:
        st = vals[0].dtype
        for v in vals[1:]:
            st = supertype(st, v.dtype)
        return [cast_val(v, st) for v in vals]
    if len(strs) + sum(isinstance(v.dtype, dt.Null) for v in vals) != len(vals):
        raise InvalidOperationError("cannot mix strings with other types here")
    table = strs[0].table
    for v in strs[1:]:
        if v.table is not table:
            table = strtable.unify(table, v.table)[0]
    return [v.with_(dtype=strs[0].dtype, table=table,
                    values=v.values if v.table is None or v.table is table
                    else take_lut(strtable.index_in(v.table.values, table.values), v.values))
            for v in vals]


def _first_valid(vals: list[Val]) -> Val:
    """Row by row, the first of ``vals`` that is not null (null where none
    is; no validity where one of them has none)."""
    vals = _unified(vals)
    if vals[0].dtype.is_nested():
        from polars_tpu_torch.engine.fn_nested import on_one_child

        vals = on_one_child(vals)
    dom = next((v.domain for v in vals if v.domain != SCALAR), SCALAR)
    shape = next((v.values.shape for v in vals if v.domain != SCALAR), vals[0].values.shape)
    values = vals[0].values.expand(shape)
    valid = _valid(vals[0]).expand(shape)
    for v in vals[1:]:
        values = torch.where(valid, values, v.values.expand(shape))
        valid = valid | _valid(v).expand(shape)
    validity = None if any(v.validity is None for v in vals) else valid
    return Val(values, validity, vals[0].dtype, vals[0].table, dom, vals[0].child)


@register("fill_null", SUPER)
def _fill_null(ctx, args, opts):
    """Nulls replaced by the fill value, in the supertype of both (a string
    column by a string, on one dictionary)."""
    return _first_valid(list(args))


@register("fill_nan", SAME)
def _fill_nan(ctx, args, opts):
    """NaN replaced by the fill value (a null fill makes NaN null); a column
    that is not float is itself."""
    v, fill = args
    if not v.dtype.is_float():
        return v
    nan = torch.isnan(v.values)
    values = torch.where(nan, fill.values.to(v.values.dtype).expand(v.values.shape), v.values)
    validity = v.validity
    if fill.validity is not None:
        validity = torch.where(nan, fill.validity.expand(nan.shape), _valid(v))
    return Val(values, validity, v.dtype, None, v.domain)


@register("coalesce", SUPER)
def _coalesce(ctx, args, opts):
    return _first_valid(list(args))


# -- membership -----------------------------------------------------------------


@register("is_in", BOOL)
def _is_in(ctx, args, opts):
    """Membership in a literal list, kept as its own (m,) tensor: one (n, m)
    broadcast compare (m is a handful of values; a list of one is a scalar).
    A string list is first probed into the column's dictionary on the host,
    so its values take the column's codes (-1, matching nothing, where the
    dictionary lacks one). A null in the column gives null, unless
    ``nulls_equal``: then it is in the list iff the list holds a null.
    Against a column or an expression: membership in its kept values (one
    sort of them and a binary search); against a List column, in each
    row's own list (``list.contains``)."""
    v, other = args
    if isinstance(other.dtype, (dt.List, dt.Array)) and other.domain != SERIES:
        from polars_tpu_torch.engine.fn_nested import _list_contains

        if other.domain == SCALAR and v.domain != SCALAR:  # one list (a literal) for every row
            n = v.values.shape[0]
            validity = None if other.validity is None else other.validity.expand(n)
            other = other.with_(values=other.values.expand(n), validity=validity, domain=v.domain)
        out = _list_contains(ctx, [other, v], opts)
        return out.with_(validity=combine_validity(out.validity, v.validity))
    if other.domain not in (SCALAR, SERIES):
        return _is_in_column(ctx, v, other, opts)
    if isinstance(other.dtype, dt.Null):  # [] or [None, ...]: nothing to match
        out = torch.zeros(v.values.shape, dtype=torch.bool, device=v.values.device)
    else:
        if (v.table is None) != (other.table is None):
            raise InvalidOperationError(f"is_in cannot compare {v.dtype!r} with {other.dtype!r}")
        if v.table is not None:
            vv = v.values
            ov = take_lut(strtable.index_in(other.table.values, v.table.values), other.values)
        elif v.dtype != other.dtype:
            st = supertype(v.dtype, other.dtype)
            vv, ov = cast_val(v, st).values, cast_val(other, st).values
        else:
            vv, ov = v.values, other.values
        hits = vv.reshape(-1, 1) == ov.reshape(1, -1)
        if other.validity is not None:
            hits = hits & other.validity.reshape(1, -1)
        out = hits.any(dim=1)
    validity = v.validity
    if opts.get("nulls_equal", False) and validity is not None:
        other_has_null = (
            torch.zeros((), dtype=torch.bool, device=out.device) if other.validity is None else (~other.validity).any()
        )
        out = torch.where(validity, out, other_has_null)
        validity = None
    return Val(out, validity, dt.Boolean(), None, v.domain)


def _is_in_column(ctx, v: Val, other: Val, opts: dict) -> Val:
    """``v`` in the set of ``other``'s kept values: both as one order word
    in their supertype (strings on one dictionary), the set's words sorted
    (the rows a mask drops and the nulls past the end) and searched."""
    from polars_tpu_torch.engine.fn_position import row_domain
    from polars_tpu_torch.engine.strings import unify_vals
    from polars_tpu_torch.kernels.argsort import key_words

    other = row_domain(ctx, other)
    if (v.table is None) != (other.table is None):
        raise InvalidOperationError(f"is_in cannot compare {v.dtype!r} with {other.dtype!r}")
    if v.table is not None:
        v2, o2 = unify_vals(v, other)
        vw, ow = v2.values.to(torch.int64), o2.values.to(torch.int64)
    else:
        st = supertype(v.dtype, other.dtype)
        vw, ow = key_words(cast_val(v, st).values, st)[0], key_words(cast_val(other, st).values, st)[0]
        vw, ow = vw.to(torch.int64), ow.to(torch.int64)
    keep = ctx.rowmask if other.validity is None else ctx.rowmask & other.validity
    big = torch.iinfo(torch.int64).max
    seq = torch.sort(torch.where(keep, ow, big)).values
    kept = keep.sum()
    idx = torch.searchsorted(seq, vw.contiguous()).clamp(max=max(seq.shape[0] - 1, 0))
    found = (seq.index_select(0, idx) == vw) & (idx < kept) if seq.shape[0] else torch.zeros_like(vw, dtype=torch.bool)
    validity = v.validity
    if opts.get("nulls_equal", False) and validity is not None:
        has_null = (ctx.rowmask & ~other.validity).any() if other.validity is not None else torch.zeros(
            (), dtype=torch.bool, device=found.device)
        found = torch.where(validity, found, has_null)
        validity = None
    return Val(found, validity, dt.Boolean(), None, v.domain)


@register("is_between", BOOL)
def _is_between(ctx, args, opts):
    """``lower <= v <= upper``, each side open or closed by ``closed``
    (``both``, ``left``, ``right`` or ``none``), in the three operands'
    supertype; null where any operand is null."""
    v, lo, hi = args
    closed = opts.get("closed", "both")
    lop = ">=" if closed in ("both", "left") else ">"
    hop = "<=" if closed in ("both", "right") else "<"
    if any(a.table is not None for a in args):
        # strings by their text (a bound that is a literal by a table over
        # the dictionary), an Enum by its categories: the compares' paths
        from polars_tpu_torch.engine.compiler import compare_vals

        left, right = compare_vals(lop, v, lo), compare_vals(hop, v, hi)
        validity = combine_validity(left.validity, right.validity)
        out = left.values & right.values
        if validity is not None and validity.shape != out.shape:
            validity = validity.expand(out.shape)
        return Val(out, validity, dt.Boolean(), None, next((a.domain for a in args if a.domain != SCALAR), SCALAR))
    st = supertype(supertype(v.dtype, lo.dtype), hi.dtype)
    vv, lv, hv = (order_word(cast_val(a, st).values, st) for a in args)
    cmp = {">=": torch.ge, ">": torch.gt, "<=": torch.le, "<": torch.lt}
    out = cmp[lop](vv, lv) & cmp[hop](vv, hv)
    validity = combine_validity(v.validity, lo.validity, hi.validity)
    if validity is not None and validity.shape != out.shape:  # a bound's (1,) validity
        validity = validity.expand(out.shape)
    dom = next((a.domain for a in args if a.domain != SCALAR), SCALAR)
    return Val(out, validity, dt.Boolean(), None, dom)


# -- temporal constructors ---------------------------------------------------------


def _parts_domain(args) -> str:
    return ROW if any(a.domain == ROW for a in args) else (args[0].domain if args else SCALAR)


@register("make_date", dt.Date())
def _make_date(ctx, args, opts):
    from polars_tpu_torch.kernels.temporal import days_from_civil

    y, m, d = args
    return Val(days_from_civil(y.values, m.values, d.values), combine_validity(y.validity, m.validity, d.validity),
               dt.Date(), None, _parts_domain(args))


@register("make_datetime", lambda dts, opts: dt.Datetime(opts.get("time_unit", "us")))
def _make_datetime(ctx, args, opts):
    """Days from the civil date, then hours, minutes and seconds in ticks,
    and the microseconds floored to the unit."""
    from polars_tpu_torch.kernels.fastmath import floordiv_const
    from polars_tpu_torch.kernels.temporal import days_from_civil

    tu = opts.get("time_unit", "us")
    per_s = dt.TICKS_PER_SECOND[tu]
    y, mo, d = args[:3]
    out = days_from_civil(y.values, mo.values, d.values).to(torch.int64) * (86_400 * per_s)
    for a, scale in zip(args[3:6], (3_600 * per_s, 60 * per_s, per_s)):
        out = out + a.values.to(torch.int64) * scale
    if len(args) > 6:
        out = out + floordiv_const(args[6].values.to(torch.int64) * per_s, 1_000_000)
    return Val(out, combine_validity(*[a.validity for a in args]), dt.Datetime(tu), None, _parts_domain(args))


@register("make_duration", lambda dts, opts: dt.Duration(opts.get("time_unit", "us")))
def _make_duration(ctx, args, opts):
    """The sum of the given parts in ticks of the time unit (a part finer
    than the unit counts 0)."""
    tu = opts.get("time_unit", "us")
    per_s = dt.TICKS_PER_SECOND[tu]
    per = {"weeks": 604_800 * per_s, "days": 86_400 * per_s, "hours": 3_600 * per_s, "minutes": 60 * per_s,
           "seconds": per_s, "milliseconds": per_s // 1_000, "microseconds": per_s // 1_000_000,
           "nanoseconds": per_s // 1_000_000_000}
    out = None
    for unit, a in zip(opts["units"], args):
        term = a.values.to(torch.int64) * per[unit]
        out = term if out is None else out + term
    if out is None:
        out = torch.zeros(1, dtype=torch.int64, device=ctx.device)
    return Val(out, combine_validity(*[a.validity for a in args]), dt.Duration(tu), None, _parts_domain(args))


# -- distinct flags -----------------------------------------------------------------------


def distinct_flags(ctx, v: Val, kind: str) -> Val:
    """``is_duplicated``/``is_unique``/``is_first_distinct``/``is_last_distinct``
    (the JAX package's ``_distinct_flags``, ``fn_core.py:340-381``): one
    stable sort of each segment by (null, value) and a compare with the
    neighbours. A null is one value; per group in a window or a group-by;
    outside one, over the rows the mask keeps."""
    from polars_tpu_torch.engine.fn_position import row_domain, sort_in_groups
    from polars_tpu_torch.kernels.argsort import boundaries_from_words

    v = row_domain(ctx, v)
    o, perm2, words = sort_in_groups(ctx, [(v, False, False)])
    n = o.n
    same_prev = ~boundaries_from_words(words, perm2) if n else o.kept
    same_next = torch.zeros_like(same_prev)
    same_next[:-1] = same_prev[1:]
    flag = {"is_first_distinct": ~same_prev, "is_last_distinct": ~same_next,
            "is_duplicated": same_prev | same_next, "is_unique": ~(same_prev | same_next)}[kind]
    out_g = torch.empty_like(flag).index_copy_(0, perm2, flag)
    return Val(o.to_rows(out_g), None, dt.Boolean(), None, ROW)


def _register_distinct(kind: str) -> None:
    @register(kind, BOOL, elementwise=False)
    def _(ctx, args, opts):
        return distinct_flags(ctx, args[0], kind)


for _kind in ("is_duplicated", "is_unique", "is_first_distinct", "is_last_distinct"):
    _register_distinct(_kind)


# -- horizontal ops (the JAX package's fn_core.py:396-499) -----------------------------------


def _horizontal_domain(args) -> str:
    return next((a.domain for a in args if a.domain != SCALAR), SCALAR)


def _horizontal_shape(args) -> tuple:
    return next((a.values.shape for a in args if a.domain != SCALAR), args[0].values.shape)


def _numeric_inputs(name: str, args) -> None:
    for a in args:
        reject_series(a)
        if a.table is not None or not (a.dtype.is_numeric() or a.dtype.is_temporal()
                                       or isinstance(a.dtype, (dt.Boolean, dt.Null))):
            raise InvalidOperationError(f"{name} expects numeric columns, got {a.dtype!r}")


@register("all_horizontal", BOOL)
def _all_horizontal(ctx, args, opts):
    """Kleene ``&`` of the inputs, left to right."""
    from polars_tpu_torch.engine.compiler import _kleene

    out = args[0]
    for nxt in args[1:]:
        out = _kleene("&", *broadcast_pair(out, nxt))
    return out


@register("any_horizontal", BOOL)
def _any_horizontal(ctx, args, opts):
    from polars_tpu_torch.engine.compiler import _kleene

    out = args[0]
    for nxt in args[1:]:
        out = _kleene("|", *broadcast_pair(out, nxt))
    return out


def _sum_h_dtype(dts, opts):
    st = SUPER(dts, opts)
    return dt.UInt32() if isinstance(st, dt.Boolean) else st


@register("sum_horizontal", _sum_h_dtype)
def _sum_horizontal(ctx, args, opts):
    """The sum in the inputs' supertype (Booleans count as UInt32); a null
    adds nothing, so a row of nulls sums to 0, as in the JAX package."""
    _numeric_inputs("sum_horizontal", args)
    st = _sum_h_dtype([a.dtype for a in args], opts)
    shape = _horizontal_shape(args)
    acc = None
    for a in args:
        x = cast_val(a, st).values.expand(shape)
        if a.validity is not None:
            x = torch.where(a.validity.expand(shape), x, torch.zeros((), dtype=x.dtype, device=x.device))
        acc = x if acc is None else acc + x
    return Val(wrap_unsigned(acc.to(dt.dtype_to_torch(st)), st), None, st, None, _horizontal_domain(args))


@register("mean_horizontal", FLOAT)
def _mean_horizontal(ctx, args, opts):
    """The mean of the non-null inputs of each row, in f64; null where all
    are null."""
    _numeric_inputs("mean_horizontal", args)
    shape = _horizontal_shape(args)
    acc = cnt = None
    for a in args:
        x = float_values(a.values, a.dtype, torch.float64).expand(shape)
        valid = _valid(a).expand(shape)
        x = torch.where(valid, x, torch.zeros((), dtype=x.dtype, device=x.device))
        acc = x if acc is None else acc + x
        cnt = valid.to(torch.float64) if cnt is None else cnt + valid
    out_dt = FLOAT([args[0].dtype], opts)
    out = (acc / cnt.clamp(min=1.0)).to(dt.dtype_to_torch(out_dt))
    return Val(out, cnt > 0, out_dt, None, _horizontal_domain(args))


def _minmax_horizontal(args, is_min: bool) -> Val:
    """The least (greatest) non-null input of each row in the supertype;
    null where all are null. A NaN is kept where it comes first and skipped
    where it comes later (``<`` and ``>`` are false for it), as in the JAX
    package."""
    _numeric_inputs("min_horizontal" if is_min else "max_horizontal", args)
    st = SUPER([a.dtype for a in args], {})
    shape = _horizontal_shape(args)
    acc_v = acc_ok = None
    for a in args:
        x = order_word(cast_val(a, st).values, st).expand(shape)
        valid = _valid(a).expand(shape)
        if acc_v is None:
            acc_v, acc_ok = x, valid
            continue
        better = (x < acc_v) if is_min else (x > acc_v)
        take = valid & (~acc_ok | better)
        acc_v = torch.where(take, x, acc_v)
        acc_ok = acc_ok | valid
    validity = None if all(a.validity is None for a in args) else acc_ok
    return Val(order_word(acc_v, st).contiguous(), validity, st, None, _horizontal_domain(args))


@register("min_horizontal", SUPER)
def _min_horizontal(ctx, args, opts):
    return _minmax_horizontal(args, True)


@register("max_horizontal", SUPER)
def _max_horizontal(ctx, args, opts):
    return _minmax_horizontal(args, False)


# -- bit counts (fn_core.py:501-519, 634-679) -------------------------------------------------

_POPCOUNT8 = None


def _popcount(u: torch.Tensor) -> torch.Tensor:
    """Set bits of each int64 word: a 256-entry table over its eight bytes."""
    global _POPCOUNT8
    if _POPCOUNT8 is None:
        _POPCOUNT8 = torch.tensor([bin(i).count("1") for i in range(256)], dtype=torch.int64)
    lut = _POPCOUNT8.to(u.device)
    b = u.contiguous().view(torch.uint8).reshape(*u.shape, 8).to(torch.int64)
    return lut.index_select(0, b.reshape(-1)).reshape(b.shape).sum(-1)


def _width(v: Val) -> int:
    """The logical bit width of an integer dtype."""
    from polars_tpu_torch.engine.cast import _BITS

    return _BITS[type(v.dtype).__name__]


def _unsigned_bits(v: Val) -> tuple[torch.Tensor, int, int]:
    """(the value's logical bits zero-extended into int64, width, mask)."""
    w = _width(v)
    mask = -1 if w == 64 else (1 << w) - 1
    return v.values.to(torch.int64) & mask, w, mask


def _smear(u: torch.Tensor) -> torch.Tensor:
    """Every bit below the highest set bit set too (logical shifts)."""
    from polars_tpu_torch.kernels.hashing import _shr

    for k in (1, 2, 4, 8, 16, 32):
        u = u | _shr(u, k)
    return u


def _bit_count(kind: str, v: Val) -> torch.Tensor:
    if isinstance(v.dtype, dt.Boolean):  # width 1 but for count_zeros, whose width is a byte (the JAX package's)
        b = v.values.to(torch.bool)
        one, zero = torch.ones_like(b, dtype=torch.int64), torch.zeros_like(b, dtype=torch.int64)
        return {"bitwise_count_ones": torch.where(b, one, zero), "bitwise_count_zeros": torch.where(b, 7, 8),
                "bitwise_leading_zeros": torch.where(b, zero, one), "bitwise_leading_ones": torch.where(b, one, zero),
                "bitwise_trailing_zeros": torch.where(b, zero, one),
                "bitwise_trailing_ones": torch.where(b, one, zero)}[kind]
    if not v.dtype.is_integer():
        raise InvalidOperationError(f"{kind} expects an integer or Boolean column, got {v.dtype!r}")
    u, w, mask = _unsigned_bits(v)
    if kind == "bitwise_count_ones":
        return _popcount(u)
    if kind == "bitwise_count_zeros":
        return w - _popcount(u)
    if kind == "bitwise_leading_zeros":
        return w - _popcount(_smear(u))
    if kind == "bitwise_leading_ones":
        return w - _popcount(_smear(~u & mask))
    if kind == "bitwise_trailing_zeros":  # popcount(~x & (x - 1)) is the full width for 0
        return _popcount(~u & (u - 1) & mask)
    return _popcount(u & ((~u & mask) - 1) & mask)  # trailing ones


def _register_bit_count(kind: str) -> None:
    @register(kind, dt.UInt32())
    def _(ctx, args, opts):
        v = args[0]
        return Val(_bit_count(kind, v).to(dt.dtype_to_torch(dt.UInt32())), v.validity, dt.UInt32(), None, v.domain)


for _kind in ("bitwise_count_ones", "bitwise_count_zeros", "bitwise_leading_zeros", "bitwise_leading_ones",
              "bitwise_trailing_zeros", "bitwise_trailing_ones"):
    _register_bit_count(_kind)


# -- truncate, reinterpret, round_sig_figs, bounds (fn_core.py:574-632, 820, 1158-1195) -----------


@register("truncate", SAME)
def _truncate(ctx, args, opts):
    """Toward zero to ``decimals`` places; an integer is itself."""
    v = args[0]
    if not v.dtype.is_float():
        if v.dtype.is_numeric():
            return v
        raise InvalidOperationError(f"truncate expects a numeric column, got {v.dtype!r}")
    scale = 10.0 ** int(opts.get("decimals", 0))
    return v.with_(values=(torch.trunc(v.values * scale) / scale).to(v.values.dtype))


_REINTERPRET_PAIRS = {("Int8", "UInt8"), ("Int16", "UInt16"), ("Int32", "UInt32"), ("Int64", "UInt64"),
                      ("Int32", "Float32"), ("UInt32", "Float32"), ("Int64", "Float64"), ("UInt64", "Float64")}
_VIEW = {32: (torch.int32, torch.float32), 64: (torch.int64, torch.float64)}


def _reinterpret_dtype(dts, opts):
    if opts.get("dtype") is not None:
        return dt.parse_into_dtype(opts["dtype"])
    name = type(dts[0]).__name__
    signed = opts.get("signed")
    signed = True if signed is None else bool(signed)
    for w in ("8", "16", "32", "64"):
        if name.endswith(w):
            return getattr(dt, ("Int" if signed else "UInt") + w)()
    raise InvalidOperationError(f"cannot reinterpret {dts[0]!r}")


@register("reinterpret", _reinterpret_dtype)
def _reinterpret(ctx, args, opts):
    """The same bits read as another type of the same width (an unsigned
    value through its logical bits, whatever wider tensor holds it)."""
    from polars_tpu_torch.engine.cast import wrap_int

    v = args[0]
    out_dt = _reinterpret_dtype([v.dtype], opts)
    a, b = type(v.dtype).__name__, type(out_dt).__name__
    if a == b:
        return v
    if (a, b) not in _REINTERPRET_PAIRS and (b, a) not in _REINTERPRET_PAIRS:
        raise InvalidOperationError(f"cannot reinterpret {v.dtype!r} as {out_dt!r}")
    if v.dtype.is_float():  # float bits -> the signed integer of the width, then the target
        bits = v.values.view(_VIEW[_width(Val(v.values, None, out_dt))][0]).to(torch.int64)
        out = wrap_int(bits, out_dt)
    else:
        u, w, _ = _unsigned_bits(v)
        if out_dt.is_float():
            out = wrap_int(u, getattr(dt, f"Int{w}")()).view(_VIEW[w][1])
        else:
            out = wrap_int(u, out_dt)
    return Val(out, v.validity, out_dt, None, v.domain)


def _sig_figs_dtype(dts, opts):
    return dts[0] if dts[0].is_float() else dt.Float64()


@register("round_sig_figs", _sig_figs_dtype)
def _round_sig_figs(ctx, args, opts):
    """Rounded to ``digits`` significant digits (half to even at the last
    kept digit, as the JAX package's ``jnp.round``)."""
    v = args[0]
    d = int(opts["digits"])
    x = float_values(v.values, v.dtype, torch.float64)
    mag = torch.floor(torch.log10(torch.clamp(torch.abs(x), min=1e-300)))
    scale = torch.pow(10.0, d - 1 - mag)
    out = torch.where(x == 0, torch.zeros((), dtype=x.dtype, device=x.device),
                      torch.round(x * scale) / torch.clamp(scale, min=1e-300))
    out_dt = _sig_figs_dtype([v.dtype], opts)
    return Val(out.to(dt.dtype_to_torch(out_dt)), v.validity, out_dt, None, v.domain)


def _bound_value(d: dt.DataType, upper: bool):
    if d.is_float():
        return math.inf if upper else -math.inf
    if d.is_integer():
        from polars_tpu_torch.engine.cast import int_bounds

        return int_bounds(d)[1 if upper else 0]
    raise InvalidOperationError(f"no bound of {d!r}")


def _register_bound(name: str, upper: bool) -> None:
    @register(name, SAME, elementwise=False)
    def _(ctx, args, opts):
        d = args[0].dtype
        value = _bound_value(d, upper)
        if d.is_float():
            t = torch.tensor([value], dtype=dt.dtype_to_torch(d), device=ctx.device)
        else:
            from polars_tpu_torch.engine.cast import int_scalar

            t = int_scalar(value, d, ctx.device)
        return Val(t, None, d, None, SCALAR)


_register_bound("lower_bound", False)
_register_bound("upper_bound", True)


@register("set_sorted", SAME)
def _set_sorted(ctx, args, opts):
    return args[0]


# -- replace, replace_strict (fn_core.py:690-818) ---------------------------------------------


def _literal_like(value, v: Val) -> torch.Tensor:
    """A Python value as a one-element tensor in ``v``'s storage."""
    from polars_tpu_torch.engine.cast import int_scalar

    if v.dtype.is_float():
        return torch.tensor([float(value)], dtype=v.values.dtype, device=v.values.device)
    if isinstance(v.dtype, dt.Boolean):
        return torch.tensor([bool(value)], device=v.values.device)
    if isinstance(v.dtype, dt.Decimal):
        import decimal

        return torch.tensor([int(decimal.Decimal(str(value)).scaleb(v.dtype.scale)
                                 .to_integral_value(decimal.ROUND_HALF_EVEN))], dtype=torch.int64,
                            device=v.values.device)
    return int_scalar(int(value), v.dtype, v.values.device)


def _hits(v: Val, olds) -> list[torch.Tensor]:
    """For each old value, the rows that hold it (a None matches the nulls)."""
    out = []
    for o in olds:
        if o is None:
            out.append(~_valid(v))
            continue
        if isinstance(o, float) and math.isnan(o) and v.dtype.is_float():
            hit = torch.isnan(v.values)
        else:
            hit = v.values == _literal_like(o, v)
        out.append(hit if v.validity is None else hit & v.validity)
    return out


def _string_lut(v: Val, olds) -> tuple[np.ndarray, np.ndarray]:
    """(the index of each dictionary entry among ``olds``, -1 for none;
    the index that the nulls take, -1 for none)."""
    pos = {str(o): i for i, o in reversed(list(enumerate(olds))) if o is not None}
    lut = np.fromiter((pos.get(u, -1) for u in v.table.values.tolist()), np.int64, len(v.table))
    null_at = next((i for i, o in enumerate(olds) if o is None), -1)
    return lut, null_at


@register("replace", SAME)
def _replace(ctx, args, opts):
    """The listed values replaced by their new ones, the others kept, in the
    input's dtype. A string column maps its dictionary once on the host."""
    from polars_tpu_torch.engine.strings import map_over_table

    v = args[0]
    olds, news = list(opts["olds"]), list(opts["news"])
    if v.table is not None:
        mapping = {str(o): n for o, n in zip(olds, news) if o is not None}
        if any(not isinstance(n, str) for n in mapping.values()):
            raise InvalidOperationError("replace on a string column takes string replacements")
        return map_over_table(v, lambda u: mapping.get(u, u))
    values, validity = v.values, v.validity
    for hit, new in zip(_hits(v, olds), news):
        if new is None:
            validity = torch.where(hit, False, _valid(v) if validity is None else validity)
        else:
            values = torch.where(hit, _literal_like(new, v), values)
            if validity is not None:
                validity = validity | hit
    return v.with_(values=values, validity=validity)


def _replace_strict_dtype(dts, opts):
    if opts.get("return_dtype") is not None:
        return dt.parse_into_dtype(opts["return_dtype"])
    from polars_tpu_torch.core.column import _infer_pylist_dtype

    cand = [n for n in opts.get("news", ()) if n is not None]
    if opts.get("default") is not None:
        cand.append(opts["default"])
    return _infer_pylist_dtype(cand) if cand else dt.Null()


@register("replace_strict", _replace_strict_dtype)
def _replace_strict(ctx, args, opts):
    """Every value mapped to its new one; an unmapped value takes
    ``default``, or, without one, fails the segment at its count read (a
    validation flag; a null stays null). A string input is looked up once
    per dictionary entry; a string output gets a sorted dictionary of the
    new values."""
    v = args[0]
    olds, news = list(opts["olds"]), list(opts["news"])
    default = opts.get("default")
    out_dt = _replace_strict_dtype([v.dtype], opts)
    text = isinstance(out_dt, (dt.String, dt.Categorical, dt.Enum))
    outs = [*news, default]
    table = None
    if text:
        labels = sorted({str(x) for x in outs if x is not None})
        table = strtable.StringTable(np.asarray(labels or [""], object), sorted_order=True)
        code = {s: i for i, s in enumerate(labels)}
        new_vals = [None if x is None else code[str(x)] for x in outs]
        tdt = torch.int32
    else:
        new_vals, tdt = outs, dt.dtype_to_torch(out_dt)
    dev = v.values.device
    if v.table is not None:
        lut, null_at = _string_lut(v, olds)
        # per entry of the mapping: its new value and whether it is null
        fill = [0 if x is None else x for x in new_vals[:-1]] or [0]
        vals_t = torch.tensor(fill, dtype=tdt if tdt != torch.bool else torch.bool, device=dev)
        isnull_t = torch.tensor([x is None for x in new_vals[:-1]] or [True], device=dev)
        idx = take_lut(lut, v.values)
        if null_at >= 0:
            idx = torch.where(_valid(v), idx, null_at)
        matched = idx >= 0
        if v.validity is not None and null_at < 0:
            matched = matched & v.validity
        safe = idx.clamp(min=0)
        values = vals_t.index_select(0, safe.reshape(-1)).reshape(idx.shape)
        new_null = isnull_t.index_select(0, safe.reshape(-1)).reshape(idx.shape) & matched
    else:
        values = torch.zeros(v.values.shape, dtype=tdt, device=dev)
        matched = torch.zeros(v.values.shape, dtype=torch.bool, device=dev)
        new_null = torch.zeros_like(matched)
        for hit, new in zip(_hits(v, olds), new_vals[:-1]):
            hit = hit & ~matched  # the first listed old value wins
            if new is None:
                new_null = new_null | hit
            else:
                values = torch.where(hit, torch.tensor(new, dtype=tdt, device=dev), values)
            matched = matched | hit
    if default is not None:
        values = torch.where(matched, values, torch.tensor(new_vals[-1], dtype=tdt, device=dev))
        validity = ~new_null & (matched | _valid(v))
    else:
        flag_rows(ctx, v, ~matched, "replace_strict: a value is not in the mapping and no `default` is set")
        validity = matched & ~new_null
    return Val(values, validity, out_dt, table, v.domain)


# -- functions over a column's rows: search_sorted, rle_id, cut, qcut, hash ------------------


@register("search_sorted", dt.UInt32(), elementwise=False)
def _search_sorted(ctx, args, opts):
    """Where each element would go in the kept rows of a sorted column (the
    JAX package's ``fn_core.py:896-918``): both sides as order words (NaN
    greatest, unsigned in unsigned order, strings on one ordinal
    dictionary), the rows a mask drops and the nulls after every value."""
    from polars_tpu_torch.engine.fn_position import group_order, row_domain
    from polars_tpu_torch.kernels.argsort import key_words

    v, elem = row_domain(ctx, args[0]), args[1]
    reject_series(elem)
    if v.table is not None or elem.table is not None:
        if v.table is None or elem.table is None:
            raise InvalidOperationError(f"search_sorted cannot compare {v.dtype!r} with {elem.dtype!r}")
        merged, vmap, emap = strtable.unify(v.table, elem.table, require_ordinal=True)
        vv = v.values if len(vmap) == 0 else take_lut(vmap, v.values)
        ev = elem.values if len(emap) == 0 else take_lut(emap, elem.values)
        ranks = merged.ordinal()[1]  # one table, unordered: its ordinal codes
        if len(ranks):
            vv, ev = take_lut(ranks, vv), take_lut(ranks, ev)
        dtype = dt.String()
    else:
        ev, vv, dtype = cast_val(elem, v.dtype).values, v.values, v.dtype
    if ctx.groups is not None:
        return _search_sorted_groups(ctx, v, vv, ev, elem, dtype, opts.get("side", "any") == "right")
    o = group_order(ctx)
    keep = o.kept if v.validity is None else o.kept & o.to_group(v.validity)
    word = key_words(o.to_group(vv), dtype)[0]
    big = torch.iinfo(word.dtype).max
    seq = torch.where(keep, word, torch.full((), big, dtype=word.dtype, device=word.device))
    needles = key_words(ev, dtype)[0].to(seq.dtype)
    idx = torch.searchsorted(seq.contiguous(), needles.contiguous(), right=opts.get("side", "any") == "right")
    idx = torch.minimum(idx, keep.sum())  # a needle at the sentinel's word stops before the padding
    return Val(idx.to(dt.dtype_to_torch(dt.UInt32())), None, dt.UInt32(), None, elem.domain)


def _search_sorted_groups(ctx, v: Val, vv: torch.Tensor, ev: torch.Tensor, elem: Val, dtype, right: bool) -> Val:
    """``search_sorted`` in each group (of a window or a group-by): where
    the needle would go among its group's kept values. The values and the
    needles (one per group for a scalar, else one per row, in its row's
    group) sort together by (group, order word), a needle before the values
    it equals (after them for ``side="right"``); its place is the count of
    its group's values before it."""
    from polars_tpu_torch.engine.fn_position import row_domain
    from polars_tpu_torch.kernels.argsort import key_words, stable_argsort_words

    g = ctx.groups
    cap, dev = g.capacity, vv.device
    keep = ctx.rowmask if v.validity is None else ctx.rowmask & v.validity
    gv = torch.where(keep, g.gids.to(torch.int64), cap)
    if elem.domain == SCALAR:
        gn = torch.arange(cap, dtype=torch.int64, device=dev)
        ev = ev.reshape(-1).expand(cap)
    else:
        elem = row_domain(ctx, elem)
        gn = torch.where(ctx.rowmask, g.gids.to(torch.int64), cap)
    words_v, words_n = key_words(vv, dtype)[0].to(torch.int64), key_words(ev, dtype)[0].to(torch.int64)
    nv, nn = gv.shape[0], gn.shape[0]
    is_val = torch.cat([torch.ones(nv, dtype=torch.int64, device=dev), torch.zeros(nn, dtype=torch.int64, device=dev)])
    tie = is_val if not right else 1 - is_val  # which comes first among equal words
    perm = stable_argsort_words([torch.cat([gv, gn]), torch.cat([words_v, words_n]), tie])
    grp = torch.cat([gv, gn]).index_select(0, perm)
    before = torch.cumsum(is_val.index_select(0, perm), 0) - is_val.index_select(0, perm)
    start = torch.full((cap + 1,), nv + nn, dtype=torch.int64, device=dev).scatter_reduce(
        0, grp, torch.arange(nv + nn, device=dev), "amin", include_self=True)
    first_before = before.index_select(0, start.clamp(max=max(nv + nn - 1, 0)).index_select(0, grp))
    at = torch.empty_like(before).index_copy_(0, perm, before - first_before)[nv:]
    return Val(at.to(dt.dtype_to_torch(dt.UInt32())), None, dt.UInt32(), None, GROUP if elem.domain == SCALAR else ROW)


@register("rle_id", dt.UInt32(), elementwise=False)
def _rle_id(ctx, args, opts):
    """The run of equal values each row belongs to, numbered from 0 in each
    segment (the kept rows, a window's group): a run ends where the value or
    its validity changes; nulls make one run. A nested value compares by
    its content's rank."""
    from polars_tpu_torch.engine.compiler import content_val
    from polars_tpu_torch.engine.fn_position import group_order, row_domain

    v = content_val(row_domain(ctx, args[0]))
    o = group_order(ctx)
    n = o.n
    vals = o.to_group(v.values)
    iota = torch.arange(n, device=vals.device)
    change = iota == o.start
    if n:
        diff = torch.ones(n, dtype=torch.bool, device=vals.device)
        diff[1:] = vals[1:] != vals[:-1]
        if v.validity is not None:
            valid = o.to_group(v.validity)
            both_null = torch.zeros_like(diff)
            both_null[1:] = ~valid[1:] & ~valid[:-1]
            flip = torch.zeros_like(diff)
            flip[1:] = valid[1:] != valid[:-1]
            diff = (diff & ~both_null) | flip
        change = change | diff
    c = torch.cumsum(change, 0)
    ids = c - c.index_select(0, o.start) if n else c
    return Val(o.to_rows(ids), None, dt.UInt32(), None, ROW)


def _fmt_break(b: float) -> str:
    return str(int(b)) if float(b).is_integer() else repr(float(b))


def _cut_labels(breaks, labels, left_closed: bool) -> list[str]:
    """Interval labels in bin order (Polars' ``(a, b]``, or ``[a, b)`` when
    ``left_closed``)."""
    if labels is None:
        edges = ["-inf", *(_fmt_break(b) for b in breaks), "inf"]
        fmt = "[{}, {})" if left_closed else "({}, {}]"
        labels = [fmt.format(a, b) for a, b in zip(edges[:-1], edges[1:])]
    labels = [str(x) for x in labels]
    if len(labels) != len(list(breaks)) + 1:
        from polars_tpu_torch.errors import ShapeError

        raise ShapeError(f"expected {len(list(breaks)) + 1} labels, got {len(labels)}")
    return labels


def _bins(x: torch.Tensor, breaks, left_closed: bool) -> torch.Tensor:
    """The bin of each value: how many breaks lie below it (at or below it
    when ``left_closed``). ``breaks`` holds floats or per-row tensors."""
    idx = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    for b in breaks:
        idx += (x >= b) if left_closed else (x > b)
    return idx


def _category_val(v: Val, idx: torch.Tensor, labels: list[str], dtype: dt.DataType) -> Val:
    """Bin numbers as an Enum (or Categorical) of ``labels``: a fixed table
    in category order, so that a sort follows the bins."""
    table = strtable.StringTable(np.asarray(labels, object), sorted_order=False)
    return Val(idx, v.validity, dtype, table, v.domain)


def _cut_dtype(dts, opts):
    if "quantiles" in opts and opts.get("labels") is None:
        return dt.Categorical()  # labels from the data's breaks (Polars)
    return dt.Enum(_cut_labels(opts.get("breaks", opts.get("quantiles", ())), opts.get("labels"),
                               opts.get("left_closed", False)))


@register("cut", _cut_dtype)
def _cut(ctx, args, opts):
    v = args[0]
    breaks = [float(b) for b in opts["breaks"]]
    labels = _cut_labels(breaks, opts.get("labels"), opts.get("left_closed", False))
    x = float_values(v.values, v.dtype, torch.float64)
    return _category_val(v, _bins(x, breaks, opts.get("left_closed", False)), labels, dt.Enum(labels))


@register("qcut", _cut_dtype, elementwise=False)
def _qcut(ctx, args, opts):
    """Bins between the column's quantiles (linear), per group in a window.
    With ``labels`` the output is an Enum of them; without, the labels are
    the break values, as Polars gives them (a Categorical, one host read of
    the breaks; the JAX package labels with the quantile fractions), and a
    break that repeats raises unless ``allow_duplicates`` drops it."""
    from polars_tpu_torch.engine import groupby as G
    from polars_tpu_torch.engine.compiler import group_of
    from polars_tpu_torch.engine.fn_position import row_domain

    v = row_domain(ctx, args[0])
    qs = [float(q) for q in opts["quantiles"]]
    left_closed = opts.get("left_closed", False)
    g = group_of(ctx)
    mask = ctx.rowmask if v.validity is None else ctx.rowmask & v.validity
    brks, _ = G.seg_quantiles(v, mask, g.gids, g.capacity, qs, "linear")
    x = float_values(v.values, v.dtype, torch.float64)
    if opts.get("labels") is not None:
        labels = _cut_labels(qs, opts["labels"], left_closed)
        if g.capacity == 1:
            per_row = [brks[0, j] for j in range(len(qs))]
        else:
            ids = g.gids.clamp(0, g.capacity - 1).long()
            per_row = [brks[:, j].index_select(0, ids) for j in range(len(qs))]
        return _category_val(v, _bins(x, per_row, left_closed), labels, dt.Enum(labels))
    if ctx.groups is not None:
        return _qcut_groups(v, x, g, brks, left_closed, bool(opts.get("allow_duplicates")))
    values = [float(b) for b in brks[0].tolist()]
    if len(set(values)) < len(values):
        if not opts.get("allow_duplicates"):
            from polars_tpu_torch.errors import DuplicateError

            raise DuplicateError(f"quantiles are not unique while allow_duplicates=False: {values}")
        values = sorted(set(values))
    labels = _cut_labels(values, None, left_closed)
    return _category_val(v, _bins(x, values, left_closed), labels, dt.Categorical())


def _upper_break(x: torch.Tensor, breaks: list, left_closed: bool) -> torch.Tensor:
    """Each value's bin's upper break (inf past the last): breaks are
    floats or per-row tensors, ascending."""
    out = torch.full(x.shape, math.inf, dtype=torch.float64, device=x.device)
    for b in reversed(breaks):
        inside = (x < b) if left_closed else (x <= b)
        out = torch.where(inside, b if isinstance(b, torch.Tensor) else torch.tensor(b, dtype=torch.float64,
                                                                                     device=x.device), out)
    return out


@register("cut_breakpoint", dt.Float64())
def _cut_breakpoint(ctx, args, opts):
    """``cut(include_breaks=True)``'s ``breakpoint`` field."""
    v = args[0]
    x = float_values(v.values, v.dtype, torch.float64)
    return Val(_upper_break(x, [float(b) for b in opts["breaks"]], opts.get("left_closed", False)), v.validity,
               dt.Float64(), None, v.domain)


@register("qcut_breakpoint", dt.Float64(), elementwise=False)
def _qcut_breakpoint(ctx, args, opts):
    """``qcut(include_breaks=True)``'s ``breakpoint`` field: the column's
    quantiles as breaks, per group in a window."""
    from polars_tpu_torch.engine import groupby as G
    from polars_tpu_torch.engine.compiler import group_of
    from polars_tpu_torch.engine.fn_position import row_domain

    v = row_domain(ctx, args[0])
    g = group_of(ctx)
    mask = ctx.rowmask if v.validity is None else ctx.rowmask & v.validity
    qs = [float(q) for q in opts["quantiles"]]
    brks, _ = G.seg_quantiles(v, mask, g.gids, g.capacity, qs, "linear")
    ids = g.gids.clamp(0, g.capacity - 1).long()
    x = float_values(v.values, v.dtype, torch.float64)
    per_row = [brks[:, j].index_select(0, ids) for j in range(len(qs))]
    return Val(_upper_break(x, per_row, opts.get("left_closed", False)), v.validity, dt.Float64(), None, v.domain)


def _qcut_groups(v: Val, x: torch.Tensor, g, brks: torch.Tensor, left_closed: bool, allow_duplicates: bool) -> Val:
    """``qcut`` without labels in each group (a window's or a group-by's):
    each group's breaks name its bins, as Polars labels them; the labels of
    every group share one Categorical dictionary. The groups' distinct
    tuples of breaks (bit for bit) are found on the device and only those
    are read to the host and labelled, once each."""
    k = brks.shape[1]
    ng = int(g.num_groups)
    if ng:
        rows, inverse = torch.unique(brks[:ng].contiguous().view(torch.int64), dim=0, return_inverse=True)
    else:
        rows, inverse = brks[:0].view(torch.int64), torch.zeros(1, dtype=torch.int64, device=brks.device)
    host = rows.view(torch.float64).cpu().numpy()
    names: dict[str, int] = {}
    lut = np.zeros((max(len(host), 1), k + 1), np.int32)
    for r, row in enumerate(host):
        vals = [float(b) for b in row]
        if len(set(vals)) < len(vals) and not allow_duplicates:
            from polars_tpu_torch.errors import DuplicateError

            raise DuplicateError(f"quantiles are not unique while allow_duplicates=False: {vals}")
        labels = _cut_labels(sorted(set(vals)), None, left_closed)
        for b in range(k + 1):  # a bin past repeated breaks is the next distinct one
            lut[r, b] = names.setdefault(labels[len(set(vals[:b]))], len(names))
    ids = g.gids.clamp(0, g.capacity - 1).long()
    idx = _bins(x, [brks[:, j].index_select(0, ids) for j in range(k)], left_closed)
    codes = take_lut(lut.reshape(-1), inverse.index_select(0, ids.clamp(max=max(ng - 1, 0))) * (k + 1) + idx)
    table = strtable.StringTable(np.asarray(list(names), object), sorted_order=False)
    return Val(codes, v.validity, dt.Categorical(), table, v.domain)


def _string_hashes(table) -> np.ndarray:
    """A 64-bit hash of each dictionary entry's UTF-8 text (BLAKE2b), as
    int64 bit patterns."""
    import hashlib

    return np.fromiter((int.from_bytes(hashlib.blake2b(str(u).encode(), digest_size=8).digest(), "little",
                                       signed=True) for u in table.values.tolist()), np.int64, len(table))


def _flat_hash(v: Val, seed: int) -> torch.Tensor:
    """splitmix64 of each value with the seed: a string by its text, each
    dictionary entry once; nulls to the sentinel."""
    from polars_tpu_torch.kernels.hashing import _NULL_HASH, hash_column, splitmix64

    if v.table is None:
        return hash_column(v.values, v.validity, seed)
    entry = v.table.memo(("hash",), lambda: _string_hashes(v.table))
    h = splitmix64(take_lut(entry, v.values) + seed)
    return h if v.validity is None else torch.where(v.validity, h, _NULL_HASH)


@register("hash", dt.UInt64())
def _hash(ctx, args, opts):
    """splitmix64 of each value with the seed (``kernels/hashing.py``): a
    number, date or Boolean bit for bit as the JAX package hashes it; a
    string by its text, each dictionary entry once, never by its code (the
    JAX package hashes the code, ROADMAP section 3); a List, Array or
    Struct by its content (``kernels/nested_keys.content_hash``: equal
    contents hash equal in any frame, where the JAX package hashes the word
    into the child). Nulls hash to a fixed sentinel."""
    from polars_tpu_torch.kernels.nested_keys import content_hash

    v = args[0]
    seed = int(opts.get("seed", 0))
    h = content_hash(v, seed, _flat_hash) if v.dtype.is_nested() else _flat_hash(v, seed)
    return Val(h, None, dt.UInt64(), None, v.domain)


# -- functions that refuse or run elsewhere ---------------------------------------------------


# a select runs these on the host (engine/hostops.distinct_column); elsewhere they refuse
register("unique", SAME, elementwise=False)(
    raises("expression-level unique() changes length: only in a select; use frame unique()"))
register("unique_counts", dt.UInt32(), elementwise=False)(
    raises("unique_counts changes length: only in a select; use value_counts()"))
register("pack_pair", SAME, elementwise=False)(raises("corr/cov are evaluated by the aggregation engine"))
# generators and value-dependent dtypes: host functions (engine/hostops.py)
register("int_range", lambda dts, opts: opts.get("dtype") or dt.Int64(), elementwise=False)(
    raises("int_range is made on the host"))
register("repeat_value", lambda dts, opts: opts.get("dtype") or dts[0], elementwise=False)(
    raises("repeat is made on the host"))
register("temporal_range", lambda dts, opts: opts["dtype"], elementwise=False)(
    raises("date_range/datetime_range is made on the host"))
register("shrink_dtype", SAME, elementwise=False)(raises("shrink_dtype runs on the host"))

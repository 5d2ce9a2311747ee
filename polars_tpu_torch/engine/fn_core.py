"""Core elementwise functions (the port of ``polars_tpu/engine/fn_core.py``,
trimmed to the math block (the float functions, ``arctan2``, ``log`` with a
base, ``abs``, ``negate``, ``sign``, ``round``, ``floor``, ``ceil`` and
``clip``), ``to_physical``, ``not``, the null block (``is_null``, ``is_not_null``,
``is_nan``, ``is_not_nan``, ``is_finite``, ``is_infinite``, ``fill_null``
with a value, ``fill_nan`` and ``coalesce``), ``is_in``, ``is_between`` and
the temporal constructors ``make_date``, ``make_datetime`` and
``make_duration``, and the distinct flags ``is_duplicated``, ``is_unique``,
``is_first_distinct`` and ``is_last_distinct``), registered in
``engine/registry.py``."""

from __future__ import annotations

import torch

from polars_tpu_torch import datatypes as dt
import math

from polars_tpu_torch.engine.cast import cast_val, float_values, order_word, wrap_unsigned
from polars_tpu_torch.engine.common import ROW, SCALAR, SERIES, Val, broadcast_pair, combine_validity, take_lut
from polars_tpu_torch.engine.registry import BOOL, FLOAT, SAME, SUPER, register
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
    JAX package (Polars: ``FunctionExpr::Negate``)."""
    v = args[0]
    d = v.dtype
    if not ((d.is_integer() and not d.is_unsigned_integer()) or d.is_float() or isinstance(d, dt.Duration)):
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
    return {"String": dt.UInt32(), "Date": dt.Int32(), "Datetime": dt.Int64(), "Duration": dt.Int64(),
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
    dom = next((v.domain for v in vals if v.domain != SCALAR), SCALAR)
    shape = next((v.values.shape for v in vals if v.domain != SCALAR), vals[0].values.shape)
    values = vals[0].values.expand(shape)
    valid = _valid(vals[0]).expand(shape)
    for v in vals[1:]:
        values = torch.where(valid, values, v.values.expand(shape))
        valid = valid | _valid(v).expand(shape)
    validity = None if any(v.validity is None for v in vals) else valid
    return Val(values, validity, vals[0].dtype, vals[0].table, dom)


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
    ``nulls_equal``: then it is in the list iff the list holds a null."""
    v, other = args
    if other.domain not in (SCALAR, SERIES):
        raise NotImplementedError(
            "is_in against a column or an expression is not ported yet (port queue: expression breadth)"
        )
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


@register("is_between", BOOL)
def _is_between(ctx, args, opts):
    """``lower <= v <= upper``, each side open or closed by ``closed``
    (``both``, ``left``, ``right`` or ``none``), in the three operands'
    supertype; null where any operand is null."""
    v, lo, hi = args
    if any(a.table is not None for a in args):
        raise NotImplementedError("is_between on strings is not ported yet (port queue: expression breadth)")
    closed = opts.get("closed", "both")
    st = supertype(supertype(v.dtype, lo.dtype), hi.dtype)
    vv, lv, hv = (order_word(cast_val(a, st).values, st) for a in args)
    left = vv >= lv if closed in ("both", "left") else vv > lv
    right = vv <= hv if closed in ("both", "right") else vv < hv
    out = left & right
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


def _distinct_flags(ctx, v: Val, kind: str) -> Val:
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
        return _distinct_flags(ctx, args[0], kind)


for _kind in ("is_duplicated", "is_unique", "is_first_distinct", "is_last_distinct"):
    _register_distinct(_kind)

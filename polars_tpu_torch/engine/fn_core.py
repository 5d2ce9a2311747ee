"""Core elementwise functions (the port of ``polars_tpu/engine/fn_core.py``,
trimmed to ``not``, the null block (``is_null``, ``is_not_null``,
``is_nan``, ``is_not_nan``, ``is_finite``, ``is_infinite``, ``fill_null``
with a value, ``fill_nan`` and ``coalesce``), ``is_in``, ``is_between`` and
the temporal constructors ``make_date``, ``make_datetime`` and
``make_duration``), registered in ``engine/registry.py``."""

from __future__ import annotations

import torch

from polars_tpu_torch import datatypes as dt
from polars_tpu_torch.engine.cast import cast_val, order_word, wrap_unsigned
from polars_tpu_torch.engine.common import ROW, SCALAR, SERIES, Val, combine_validity, take_lut
from polars_tpu_torch.engine.registry import BOOL, SAME, SUPER, register
from polars_tpu_torch.errors import InvalidOperationError
from polars_tpu_torch.plan.schema_resolve import supertype
from polars_tpu_torch.utils import strtable


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

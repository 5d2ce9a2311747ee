"""Core elementwise functions (the port of ``polars_tpu/engine/fn_core.py``,
trimmed to ``not``, ``is_in``, ``is_between`` and the temporal constructors
``make_date``, ``make_datetime`` and ``make_duration``), registered in
``engine/registry.py``."""

from __future__ import annotations

import torch

from polars_tpu_torch import datatypes as dt
from polars_tpu_torch.engine.cast import cast_val, order_word, wrap_unsigned
from polars_tpu_torch.engine.common import ROW, SCALAR, SERIES, Val, combine_validity, take_lut
from polars_tpu_torch.engine.registry import BOOL, SAME, register
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

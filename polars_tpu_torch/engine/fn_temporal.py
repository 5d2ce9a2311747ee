"""Temporal functions of Date, Datetime, Duration and Time columns (the port
of ``polars_tpu/engine/fn_temporal.py``): the calendar fields, the
time-of-day fields, ``date``/``time``/``datetime``, ``timestamp``, the casts
of time units, ``total_*``, ``truncate``, ``round``,
``month_start``/``month_end``, ``offset_by``, ``century``, ``millennium``,
``combine``, ``replace``, the business-day functions, and the time-zone
functions ``replace_time_zone``, ``convert_time_zone``, ``base_utc_offset``
and ``dst_offset``, each with the reference's output dtype. Values are
integer epochs; every division floors (``kernels/fastmath.py``), so days
and times of day before 1970 come out right. The civil-calendar math is
``kernels/temporal.py``; a null row keeps its validity.

A Datetime with a time zone stores UTC instants. Its fields read the zone's
wall clock (``_local``, through ``kernels/timezone.py``); the functions that
move the wall clock (``truncate``, ``round``, the calendar part of
``offset_by``, ``month_start``/``month_end``, ``replace``, business days)
run on the wall clock and map back to instants (``_wall_op``), the earlier
one where the clock repeats an hour. ``to_string`` is a host op: the
executor formats its input between segments (``engine/hostops.py``).
"""

from __future__ import annotations

import re

import numpy as np
import torch

from polars_tpu_torch import datatypes as dt
from polars_tpu_torch.engine.common import ROW, Val, combine_validity, flag_rows, take_lut
from polars_tpu_torch.engine.registry import BOOL, register
from polars_tpu_torch.errors import InvalidOperationError
from polars_tpu_torch.kernels import temporal as T
from polars_tpu_torch.kernels import timezone as TZ
from polars_tpu_torch.kernels.fastmath import floordiv_any, floordiv_const, mod_any, mod_const

_TU = dt.TICKS_PER_SECOND


def _zone(v: Val) -> str | None:
    return v.dtype.time_zone if isinstance(v.dtype, dt.Datetime) else None


def _local(v: Val) -> torch.Tensor:
    """The wall-clock values: a Datetime with a time zone localizes its UTC
    instants; anything else is its own values."""
    tz = _zone(v)
    return TZ.local_from_utc(v.values, v.dtype.time_unit, tz) if tz else v.values


def _wall_op(v: Val, fn) -> Val:
    """``fn`` on the wall clock of a Datetime with a time zone, mapped back
    to instants (the earlier one where the clock repeats an hour; a time in
    a spring-forward gap moves past it); ``fn(v)`` on anything else."""
    tz = _zone(v)
    if not tz:
        return fn(v)
    tu = v.dtype.time_unit
    out = fn(v.with_(values=TZ.local_from_utc(v.values, tu, tz), dtype=dt.Datetime(tu)))
    return out.with_(values=TZ.utc_from_local(out.values, tu, tz, "earliest")[0], dtype=v.dtype)


def _days_of(v: Val) -> torch.Tensor:
    """Epoch days (int64) of a Date or Datetime."""
    if isinstance(v.dtype, dt.Date):
        return v.values.to(torch.int64)
    if isinstance(v.dtype, dt.Datetime):
        return floordiv_const(_local(v), _TU[v.dtype.time_unit] * 86_400)
    raise InvalidOperationError(f"expected Date/Datetime, got {v.dtype!r}")


def _time_part(v: Val) -> tuple[torch.Tensor, int]:
    """(the intra-day offset, nonnegative for a Datetime; ticks per second)."""
    if isinstance(v.dtype, dt.Datetime):
        return mod_const(_local(v), _TU[v.dtype.time_unit] * 86_400), _TU[v.dtype.time_unit]
    if isinstance(v.dtype, dt.Time):
        return v.values, 1_000_000_000
    if isinstance(v.dtype, dt.Duration):
        return v.values, _TU[v.dtype.time_unit]
    if isinstance(v.dtype, dt.Date):
        return torch.zeros_like(v.values, dtype=torch.int64), 1
    raise InvalidOperationError(f"no time component in {v.dtype!r}")


def _out(v: Val, values: torch.Tensor, dtype: dt.DataType) -> Val:
    return Val(values, v.validity, dtype, None, v.domain)


def _simple(name: str, out_dt: dt.DataType, fn) -> None:
    @register(f"dt.{name}", out_dt)
    def _(ctx, args, opts):
        v = args[0]
        return _out(v, fn(_days_of(v)), out_dt)


def _year(days):
    return T.civil_from_days(days)[0]


def _month(days):
    return T.civil_from_days(days)[1]


def _ceil_div_pos(y: torch.Tensor, div: int) -> torch.Tensor:
    """Century or millennium of a year: 2000 is in the 20th century, 2001 in
    the 21st."""
    return (-floordiv_const(-y.to(torch.int64), div)).to(torch.int32)


_simple("year", dt.Int32(), _year)
_simple("month", dt.Int8(), _month)
_simple("day", dt.Int8(), lambda d: T.civil_from_days(d)[2])
_simple("quarter", dt.Int8(), lambda d: (floordiv_const(_month(d) - 1, 3) + 1).to(torch.int8))
_simple("weekday", dt.Int8(), T.weekday_from_days)
_simple("week", dt.Int8(), T.iso_week)
_simple("iso_year", dt.Int32(), T.iso_year)
_simple("ordinal_day", dt.Int16(), T.ordinal_day)
_simple("leap_year", dt.Boolean(), lambda d: T.is_leap_year(_year(d)))
_simple("days_in_month", dt.Int8(), lambda d: T.days_in_month(*T.civil_from_days(d)[:2]))
_simple("century", dt.Int32(), lambda d: _ceil_div_pos(_year(d), 100))
_simple("millennium", dt.Int32(), lambda d: _ceil_div_pos(_year(d), 1000))


# -- time of day ------------------------------------------------------------------


def _clock(name: str, out_dt: dt.DataType, fn) -> None:
    @register(f"dt.{name}", out_dt)
    def _(ctx, args, opts):
        v = args[0]
        t, per_s = _time_part(v)
        return _out(v, fn(t, per_s).to(dt.dtype_to_torch(out_dt)), out_dt)


def _sub_second(per_unit: int):
    """Whole units of 1/``per_unit`` s within the second."""
    def fn(t, per_s):
        frac = mod_any(t, per_s)
        return floordiv_any(frac * per_unit, per_s) if per_s >= per_unit else frac * (per_unit // per_s)

    return fn


_clock("hour", dt.Int8(), lambda t, per_s: floordiv_any(t, per_s * 3600))
_clock("minute", dt.Int8(), lambda t, per_s: mod_any(floordiv_any(t, per_s * 60), 60))
_clock("millisecond", dt.Int32(), _sub_second(1_000))
_clock("microsecond", dt.Int32(), _sub_second(1_000_000))
_clock("nanosecond", dt.Int32(), lambda t, per_s: mod_any(t, per_s) * (1_000_000_000 // per_s))


@register("dt.second", lambda dts, opts: dt.Float64() if opts.get("fractional") else dt.Int8())
def _second(ctx, args, opts):
    v = args[0]
    t, per_s = _time_part(v)
    if opts.get("fractional"):
        return _out(v, mod_any(t, per_s * 60).to(torch.float64) / per_s, dt.Float64())
    return _out(v, mod_any(floordiv_any(t, per_s), 60).to(torch.int8), dt.Int8())


@register("dt.date", dt.Date())
def _date(ctx, args, opts):
    v = args[0]
    return _out(v, _days_of(v).to(torch.int32), dt.Date())


@register("dt.time", dt.Time())
def _time(ctx, args, opts):
    v = args[0]
    t, per_s = _time_part(v)
    return _out(v, (t * (1_000_000_000 // per_s)).to(torch.int64), dt.Time())


@register("dt.datetime", lambda dts, opts: dt.Datetime("us"))
def _datetime(ctx, args, opts):
    """The naive local datetime (a zone's wall clock, as Polars gives it;
    the JAX package keeps the UTC instants)."""
    v = args[0]
    if isinstance(v.dtype, dt.Date):
        return _out(v, v.values.to(torch.int64) * 86_400_000_000, dt.Datetime("us"))
    return _out(v, _local(v), dt.Datetime(v.dtype.time_unit))


# -- epochs and units -----------------------------------------------------------------


@register("dt.timestamp", dt.Int64())
def _timestamp(ctx, args, opts):
    v = args[0]
    tu = opts.get("time_unit", "us")
    per = {"s": 1, "d": 1, "ms": 1_000, "us": 1_000_000, "ns": 1_000_000_000}[tu]
    x = v.values.to(torch.int64)  # an aware value's epoch is its instant's
    if isinstance(v.dtype, dt.Date):
        out = x if tu == "d" else x * (86_400 * per)
    else:
        src = _TU[v.dtype.time_unit]
        if tu == "d":
            out = floordiv_const(x, src * 86_400)
        elif per >= src:
            out = x * (per // src)
        else:
            out = floordiv_const(x, src // per)
    return _out(v, out, dt.Int64())


def _unit_dtype(dts, opts):
    """The same type in another time unit; a Datetime keeps its zone (the
    JAX package drops it)."""
    d = dts[0]
    return dt.Datetime(opts["time_unit"], d.time_zone) if isinstance(d, dt.Datetime) else dt.Duration(opts["time_unit"])


@register("dt.with_time_unit", _unit_dtype)
def _with_time_unit(ctx, args, opts):
    v = args[0]
    return v.with_(dtype=_unit_dtype([v.dtype], opts))


@register("dt.cast_time_unit", _unit_dtype)
def _cast_time_unit(ctx, args, opts):
    from polars_tpu_torch.engine.cast import tu_convert

    v = args[0]
    return _out(v, tu_convert(v.values, v.dtype.time_unit, opts["time_unit"]), _unit_dtype([v.dtype], opts))


@register("dt.total", dt.Int64())
def _total(ctx, args, opts):
    """Whole units of a Duration, truncated toward zero."""
    v = args[0]
    unit = opts["unit"]
    per_s = _TU[v.dtype.time_unit]
    x = v.values.to(torch.int64)
    if unit in _TU and per_s < _TU[unit]:
        return _out(v, x * (_TU[unit] // per_s), dt.Int64())
    div = {"d": per_s * 86_400, "h": per_s * 3_600, "m": per_s * 60, "s": per_s}.get(unit) or per_s // _TU[unit]
    return _out(v, torch.div(x, div, rounding_mode="trunc"), dt.Int64())


# -- truncate, round, offsets ------------------------------------------------------------


def _parse_every(every: str) -> tuple[int, str]:
    """A one-unit interval such as '1d', '3mo' or '15m'."""
    m = re.fullmatch(r"(\d+)(ns|us|ms|s|m|h|d|w|mo|q|y)", every)
    if not m:
        raise InvalidOperationError(f"unsupported interval {every!r}")
    return int(m.group(1)), m.group(2)


# the length of each fixed unit in nanoseconds
_UNIT_NS = {"ns": 1, "us": 1_000, "ms": 1_000_000, "s": 10**9, "m": 60 * 10**9, "h": 3_600 * 10**9,
            "d": 86_400 * 10**9, "w": 604_800 * 10**9}


def _fixed_ticks(n: int, unit: str, tu: str) -> int:
    """``n`` fixed units as ticks of time unit ``tu``. The JAX package
    scales microseconds by ``ticks per us or 1``, which makes a
    millisecond column's hour 1,000 hours (ROADMAP §3); this is exact."""
    ns = n * _UNIT_NS[unit]
    if ns * _TU[tu] % 1_000_000_000:
        raise InvalidOperationError(f"an interval of {n}{unit} is not a whole number of {tu}")
    return ns * _TU[tu] // 1_000_000_000
# weeks start on a Monday; 1970-01-01 was a Thursday, three days later
_WEEK_ANCHOR_DAYS = 3


def _months_floor(y: torch.Tensor, m: torch.Tensor, n: int, unit: str) -> tuple[torch.Tensor, torch.Tensor]:
    """(year, month) of the start of each value's run of ``n`` months,
    quarters or years."""
    if unit == "y":
        y = y.to(torch.int64)
        return (floordiv_const(y, n) * n if n > 1 else y), torch.ones_like(y)
    step = n * (3 if unit == "q" else 1)
    months = floordiv_const(y.to(torch.int64) * 12 + (m.to(torch.int64) - 1), step) * step
    return floordiv_const(months, 12), mod_const(months, 12) + 1


@register("dt.truncate", lambda dts, opts: dts[0])
def _truncate(ctx, args, opts):
    return _wall_op(args[0], lambda v: _truncate_wall(v, opts))


def _truncate_wall(v: Val, opts) -> Val:
    n, unit = _parse_every(opts["every"])
    x = v.values
    if isinstance(v.dtype, dt.Date):
        if unit in ("d", "w"):
            step = n * (7 if unit == "w" else 1)
            anchor = _WEEK_ANCHOR_DAYS if unit == "w" else 0
            return v.with_(values=(floordiv_const(x.to(torch.int64) + anchor, step) * step - anchor).to(torch.int32))
        if unit in ("mo", "q", "y"):
            y, m, _ = T.civil_from_days(x)
            y2, m2 = _months_floor(y, m, n, unit)
            return v.with_(values=T.days_from_civil(y2, m2, torch.ones_like(m2)))
        raise InvalidOperationError(f"cannot truncate Date by {unit!r}")
    if isinstance(v.dtype, dt.Datetime):
        tu = v.dtype.time_unit
        if unit in _UNIT_NS:
            step = _fixed_ticks(n, unit, tu)
            anchor = _fixed_ticks(_WEEK_ANCHOR_DAYS, "d", tu) if unit == "w" else 0
            return v.with_(values=floordiv_const(x + anchor, step) * step - anchor)
        if unit in ("mo", "q", "y"):
            per_day = _TU[v.dtype.time_unit] * 86_400
            y, m, _ = T.civil_from_days(floordiv_const(x, per_day))
            if unit == "y":  # the reference floors the year by 1 whatever n is
                n = 1
            y2, m2 = _months_floor(y, m, n, unit)
            out_days = T.days_from_civil(y2, m2, torch.ones_like(m2))
            return v.with_(values=out_days.to(torch.int64) * per_day)
    raise InvalidOperationError(f"cannot truncate {v.dtype!r}")


@register("dt.dt_round", lambda dts, opts: dts[0])
def _dt_round(ctx, args, opts):
    """To the nearest multiple of a fixed interval, halves up."""
    return _wall_op(args[0], lambda v: _round_wall(v, opts))


def _round_wall(v: Val, opts) -> Val:
    n, unit = _parse_every(opts["every"])
    x = v.values
    if isinstance(v.dtype, dt.Datetime) and unit in _UNIT_NS:
        tu = v.dtype.time_unit
        step = _fixed_ticks(n, unit, tu)
        anchor = _fixed_ticks(_WEEK_ANCHOR_DAYS, "d", tu) if unit == "w" else 0
        return v.with_(values=floordiv_const(x + anchor + step // 2, step) * step - anchor)
    if isinstance(v.dtype, dt.Date) and unit in ("d", "w"):
        step = n * (7 if unit == "w" else 1)
        anchor = _WEEK_ANCHOR_DAYS if unit == "w" else 0
        out = floordiv_const(x.to(torch.int64) + anchor + step // 2, step) * step - anchor
        return v.with_(values=out.to(torch.int32))
    raise InvalidOperationError(f"dt.round by {unit!r} unsupported")


def _with_days(v: Val, out_days: torch.Tensor) -> Val:
    """A Date or Datetime moved to other days, its time of day kept."""
    if isinstance(v.dtype, dt.Date):
        return v.with_(values=out_days.to(torch.int32))
    per_day = _TU[v.dtype.time_unit] * 86_400
    return v.with_(values=out_days.to(torch.int64) * per_day + mod_const(v.values, per_day))


def _month_day(v: Val, *, first: bool) -> Val:
    y, m, _ = T.civil_from_days(_days_of(v))
    d2 = torch.ones_like(m, dtype=torch.int64) if first else T.days_in_month(y, m)
    return _with_days(v, T.days_from_civil(y, m, d2))


@register("dt.month_start", lambda dts, opts: dts[0])
def _month_start(ctx, args, opts):
    return _wall_op(args[0], lambda v: _month_day(v, first=True))


@register("dt.month_end", lambda dts, opts: dts[0])
def _month_end(ctx, args, opts):
    return _wall_op(args[0], lambda v: _month_day(v, first=False))


@register("dt.offset_by", lambda dts, opts: dts[0])
def _offset_by(ctx, args, opts):
    """Move by an interval of one or more units ('1mo', '-1y', '3d12h'), as
    Polars adds a duration: the calendar months first, keeping the day of
    the month where the target month has it and clamping it to the month's
    end where not; then weeks and days; then the fixed units. With a time
    zone the months, weeks and days move the wall clock and the fixed units
    the instant."""
    v = args[0]
    by = opts["by"]
    sign = -1 if by.startswith("-") else 1
    parts = re.findall(r"(\d+)(ns|us|ms|mo|s|m|h|d|w|q|y)", by.lstrip("-"))
    if not parts or "".join(a + u for a, u in parts) != by.lstrip("-"):
        raise InvalidOperationError(f"unsupported offset {by!r}")
    months = sum(int(a) * {"mo": 1, "q": 3, "y": 12}[u] for a, u in parts if u in ("mo", "q", "y"))
    days = sum(int(a) * (7 if u == "w" else 1) for a, u in parts if u in ("w", "d"))
    fixed_ns = sum(int(a) * _UNIT_NS[u] for a, u in parts if u in _UNIT_NS and u not in ("w", "d"))
    if isinstance(v.dtype, dt.Date) and fixed_ns:
        raise InvalidOperationError("sub-day offsets on Date")

    def calendar(w: Val) -> Val:
        if months:
            y, m, d = T.civil_from_days(_days_of(w))
            total = y.to(torch.int64) * 12 + (m.to(torch.int64) - 1) + sign * months
            y2, m2 = floordiv_const(total, 12), mod_const(total, 12) + 1
            d2 = torch.minimum(d.to(torch.int64), T.days_in_month(y2, m2).to(torch.int64))
            w = _with_days(w, T.days_from_civil(y2, m2, d2))
        if isinstance(w.dtype, dt.Date):
            return w.with_(values=(w.values.to(torch.int64) + sign * days).to(torch.int32))
        return w.with_(values=w.values + sign * _fixed_ticks(days, "d", w.dtype.time_unit))

    if months or days:
        v = _wall_op(v, calendar)
    if fixed_ns:
        v = v.with_(values=v.values + sign * _fixed_ticks(fixed_ns, "ns", v.dtype.time_unit))
    return v


# -- combine and replace -------------------------------------------------------------------


@register("dt.combine", lambda dts, opts: dt.Datetime(opts.get("time_unit", "us")))
def _combine(ctx, args, opts):
    """A Date (or a Datetime's date) and a Time of day as a Datetime."""
    v = args[0]
    tu = opts.get("time_unit", "us")
    per_day = _TU[tu] * 86_400
    if len(args) > 1:
        t = args[1]
        if not isinstance(t.dtype, dt.Time):
            raise InvalidOperationError("dt.combine expects a Time column")
        tod = floordiv_const(t.values, 1_000_000_000 // _TU[tu])
        validity = combine_validity(v.validity, t.validity)
    else:
        tod = int(opts.get("time_ns", 0)) * _TU[tu] // 1_000_000_000
        validity = v.validity
    return Val(_days_of(v) * per_day + tod, validity, dt.Datetime(tu), None, v.domain)


@register("dt.replace", lambda dts, opts: dts[0])
def _dt_replace(ctx, args, opts):
    """Set date and time parts to given values; a day past the new month's
    end is clamped to it."""
    v = args[0]
    if not isinstance(v.dtype, (dt.Date, dt.Datetime)):
        raise InvalidOperationError(f"dt.replace expects Date/Datetime, got {v.dtype!r}")
    y, m, d = (x.to(torch.int64) for x in T.civil_from_days(_days_of(v)))
    y, m, d = (x if opts.get(k) is None else torch.full_like(x, int(opts[k]))
               for x, k in ((y, "year"), (m, "month"), (d, "day")))
    new_days = T.days_from_civil(y, m, torch.minimum(d, T.days_in_month(y, m).to(torch.int64)))
    if isinstance(v.dtype, dt.Date):
        return v.with_(values=new_days)
    tu = v.dtype.time_unit
    per_day = _TU[tu] * 86_400
    tod = mod_const(_local(v), per_day)
    for part, ticks, span in (("hour", _TU[tu] * 3_600, 24), ("minute", _TU[tu] * 60, 60), ("second", _TU[tu], 60),
                              ("microsecond", _TU[tu] // 1_000_000 if _TU[tu] >= 1_000_000 else None, 1_000_000)):
        if opts.get(part) is None:
            continue
        if ticks is None:
            raise InvalidOperationError(f"cannot set {part} on {tu}-unit Datetime")
        tod = tod + (int(opts[part]) - mod_const(floordiv_const(tod, ticks), span)) * ticks
    wall = new_days.to(torch.int64) * per_day + tod
    tz = _zone(v)
    if tz:  # the new wall clock of the zone; "latest" takes the later instant of a repeated hour
        wall = TZ.utc_from_local(wall, tu, tz, opts.get("ambiguous") or "earliest")[0]
    return v.with_(values=wall)


# -- business days ------------------------------------------------------------------------


def _bday_setup(opts) -> tuple[tuple[bool, ...], tuple[int, ...]]:
    mask = tuple(bool(m) for m in opts.get("week_mask", (1, 1, 1, 1, 1, 0, 0)))
    if not any(mask):
        raise InvalidOperationError("week_mask must have at least one business day")
    return mask, tuple(int(h) for h in opts.get("holidays", ()))


def _is_open(days: torch.Tensor, mask, holidays) -> torch.Tensor:
    """Whether each epoch day is a business day (weekday 0 is a Monday)."""
    dow = mod_const(days + _WEEK_ANCHOR_DAYS, 7)
    out = torch.zeros(days.shape, dtype=torch.bool, device=days.device)
    for w, keep in enumerate(mask):
        if keep:
            out |= dow == w
    for h in holidays:
        out &= days != h
    return out


@register("dt.is_business_day", BOOL)
def _is_business_day(ctx, args, opts):
    v = args[0]
    mask, holidays = _bday_setup(opts)
    return _out(v, _is_open(_days_of(v), mask, holidays), dt.Boolean())


@register("dt.add_business_days", lambda dts, opts: dts[0])
def _add_business_days(ctx, args, opts):
    return _wall_op(args[0], lambda v: _add_business_days_wall(ctx, v, opts))


def _add_business_days_wall(ctx, v: Val, opts) -> Val:
    """Move by ``n`` business days. A start on a closed day rolls forward or
    backward, or with ``roll="raise"`` fails at the segment's count read.
    The walk takes one calendar day a step, for as many steps as ``n``
    business days can span: ceil(|n| * 7 / open days) + 7 per holiday and
    week."""
    days = _days_of(v)
    mask, holidays = _bday_setup(opts)
    n = int(opts.get("n", 1))
    roll = opts.get("roll", "raise")
    if roll in ("forward", "backward"):
        step = 1 if roll == "forward" else -1
        for _ in range(8 + len(holidays)):
            days = torch.where(_is_open(days, mask, holidays), days, days + step)
    else:
        flag_rows(ctx, v, ~_is_open(days, mask, holidays), "non-business day date; use `roll='forward'/'backward'`")
    step, remaining = (1 if n >= 0 else -1), abs(n)
    cur = days
    left = torch.full_like(days, remaining)
    for _ in range(remaining * 7 // max(sum(mask), 1) + 7 * (1 + len(holidays))):
        move = left > 0
        nxt = torch.where(move, cur + step, cur)
        left = left - (move & _is_open(nxt, mask, holidays)).to(torch.int64)
        cur = nxt
    return _with_days(v, cur)


@register("business_day_count", dt.Int32())
def _business_day_count(ctx, args, opts):
    """Business days in [start, end), negative where end < start (then
    counted over (end, start])."""
    s_v, e_v = args
    s, e = _days_of(s_v), _days_of(e_v)
    mask, holidays = _bday_setup(opts)
    neg = e < s
    lo = torch.where(neg, e + 1, s)
    hi = torch.where(neg, s + 1, e)
    span = hi - lo
    dow_lo = mod_const(lo + _WEEK_ANCHOR_DAYS, 7)
    total = torch.zeros_like(lo)
    for w, keep in enumerate(mask):
        if keep:  # the days of weekday w from lo on: the first is `off` days after lo
            off = mod_const(w - dow_lo, 7)
            total += torch.clamp(floordiv_const(span - off + 6, 7), min=0)
    for h in holidays:
        if mask[(h + _WEEK_ANCHOR_DAYS) % 7]:
            total -= ((lo <= h) & (h < hi)).to(torch.int64)
    total = torch.where(neg, -total, total)
    dom = s_v.domain if s_v.domain == e_v.domain else ROW
    return Val(total.to(torch.int32), combine_validity(s_v.validity, e_v.validity), dt.Int32(), None, dom)


# -- time zones -------------------------------------------------------------------------------

_AMBIGUOUS = ("raise", "earliest", "latest", "null")
_NON_EXISTENT = ("raise", "null")


def _with_zone(dts, opts):
    if not isinstance(dts[0], dt.Datetime):
        raise InvalidOperationError(f"expected Datetime, got {dts[0]!r}")
    return dt.Datetime(dts[0].time_unit, opts.get("time_zone"))


def localize(ctx, v: Val, tz: str, ambiguous: str | Val = "raise", non_existent: str = "raise") -> Val:
    """Naive wall-clock values ``v`` of zone ``tz`` as its UTC instants. A
    wall time the clock shows twice takes the earlier or the later instant,
    is null, or (``"raise"``) fails the segment at its count read; a wall
    time the clock skips is null or fails (Polars' ``non_existent``).
    ``ambiguous`` may be a String value that names one of those per row."""
    if isinstance(ambiguous, Val):
        return _localize_per_row(ctx, v, tz, ambiguous, non_existent)
    if ambiguous not in _AMBIGUOUS:
        raise InvalidOperationError(f"ambiguous must be one of {_AMBIGUOUS}, got {ambiguous!r}")
    if non_existent not in _NON_EXISTENT:
        raise InvalidOperationError(f"non_existent must be one of {_NON_EXISTENT}, got {non_existent!r}")
    tu = v.dtype.time_unit
    utc, amb, nonex = TZ.utc_from_local(v.values, tu, tz, ambiguous)
    validity = v.validity
    for kind, mask, how, hint in (("ambiguous", amb, ambiguous, "ambiguous='earliest'/'latest'/'null'"),
                                  ("non-existent", nonex, non_existent, "non_existent='null'")):
        if how == "raise":
            flag_rows(ctx, v, mask, f"datetime is {kind} in time zone {tz!r}; use `{hint}`")
        elif how == "null":
            validity = combine_validity(validity, ~mask)
    return Val(utc, validity, dt.Datetime(tu, tz), None, v.domain)


def _localize_per_row(ctx, v: Val, tz: str, how: Val, non_existent: str) -> Val:
    """``localize`` with ``ambiguous`` read per row from a String value:
    its dictionary's words looked up once on the host, the earlier and the
    later instants both taken, each row choosing."""
    if how.table is None:
        raise InvalidOperationError(f"ambiguous must be a String expression, got {how.dtype!r}")
    words = how.table.values.tolist()
    bad = [w for w in words if w not in _AMBIGUOUS]
    if bad:
        raise InvalidOperationError(f"ambiguous must be one of {_AMBIGUOUS}, got {bad[0]!r}")
    kind = take_lut(np.asarray([_AMBIGUOUS.index(w) for w in words] or [0], np.int64), how.values)
    if kind.shape != v.values.shape:
        kind = kind.expand(v.values.shape)
    early = localize(ctx, v, tz, "earliest", non_existent)
    late, amb, _ = TZ.utc_from_local(v.values, v.dtype.time_unit, tz, "latest")
    name = dict(enumerate(_AMBIGUOUS))
    is_ = {w: kind == i for i, w in name.items()}
    out = torch.where(amb & is_["latest"], late, early.values)
    validity = early.validity
    if how.validity is not None:
        validity = combine_validity(validity, how.validity.expand(v.values.shape))
    validity = combine_validity(validity, ~(amb & is_["null"]))
    flag_rows(ctx, v, amb & is_["raise"], f"datetime is ambiguous in time zone {tz!r}; use "
                                          "`ambiguous='earliest'/'latest'/'null'`")
    return Val(out, validity, early.dtype, None, v.domain)


@register("dt.replace_time_zone", _with_zone)
def _replace_time_zone(ctx, args, opts):
    """The same wall clock in another zone (or none): the instants move so
    that the local reading stays."""
    v = args[0]
    wall = v.with_(values=_local(v), dtype=dt.Datetime(v.dtype.time_unit))
    tz = opts.get("time_zone")
    if tz is None:
        return wall
    ambiguous = args[1] if len(args) > 1 else opts.get("ambiguous", "raise")
    return localize(ctx, wall, tz, ambiguous, opts.get("non_existent", "raise"))


@register("dt.convert_time_zone", _with_zone)
def _convert_time_zone(ctx, args, opts):
    """The same instants shown in another zone: only the dtype changes (a
    naive value is read as UTC, as in the JAX package)."""
    v = args[0]
    TZ.tz_table(opts["time_zone"])  # an unknown zone raises here
    return v.with_(dtype=_with_zone([v.dtype], opts))


def _offset_ms(v: Val, name: str, dst_only: bool) -> Val:
    tz = _zone(v)
    if not tz:
        raise InvalidOperationError(f"{name} expects a Datetime with a time zone, got {v.dtype!r}")
    tu = v.dtype.time_unit
    dst = TZ.dst_offset(v.values, tu, tz)
    ticks = dst if dst_only else TZ.utc_offset(v.values, tu, tz) - dst
    return _out(v, floordiv_const(ticks, _TU[tu] // 1_000), dt.Duration("ms"))


@register("dt.base_utc_offset", dt.Duration("ms"))
def _base_utc_offset(ctx, args, opts):
    return _offset_ms(args[0], "base_utc_offset", dst_only=False)


@register("dt.dst_offset", dt.Duration("ms"))
def _dst_offset(ctx, args, opts):
    return _offset_ms(args[0], "dst_offset", dst_only=True)


@register("dt.to_string", dt.String())
def _to_string(ctx, args, opts):
    raise InvalidOperationError(
        "dt.to_string is a host op: it runs in select and with_columns, between segments (engine/hostops.py)")

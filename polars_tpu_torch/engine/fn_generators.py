"""Ranges per row, as List values in a segment (the port of the JAX
package's host generators ``int_ranges``, ``date_ranges``,
``datetime_ranges``, ``time_ranges`` and ``linear_spaces``, which build
each row's list on the host, ``engine/run.py:1252``).

Each row's length comes from its bounds on the device; one host read of
the total (with the flag of a bad argument: a zero step, a negative
count) sizes the child, which is the starts repeated by
``repeat_interleave`` plus each element's place in its list times the
step. A null bound gives a null list. A calendar interval (months,
quarters, years, with any fixed part) steps by civil-date arithmetic on the
device (:func:`_calendar_range`): element k is the start's date ``k *
months`` later, its day clamped at the month's end as Polars clamps it, plus
``k`` fixed parts. ``datetime_ranges`` with a time zone steps a calendar
interval or whole days on the zone's wall clock and a sub-day interval in
UTC, as Polars does (``kernels/timezone.py``). A scalar ``date_range`` steps
months on the host (``engine/hostops.generate``).
"""

from __future__ import annotations

import re

import torch

from polars_tpu_torch import datatypes as dt
from polars_tpu_torch.engine.common import SCALAR, Val, combine_validity
from polars_tpu_torch.engine.fn_nested import make_list
from polars_tpu_torch.engine.registry import register
from polars_tpu_torch.errors import ComputeError


def _rows(args: list[Val]) -> list[Val]:
    """The arguments at one row count and in one domain (a scalar repeats)."""
    n = max(a.values.shape[0] for a in args)
    dom = next((a.domain for a in args if a.domain != SCALAR), SCALAR)
    out = []
    for a in args:
        if a.values.shape[0] != n:
            a = a.with_(values=a.values.expand(n), validity=None if a.validity is None else a.validity.expand(n))
        out.append(a.with_(domain=dom))
    return out


def _ranges(owner: Val, start: torch.Tensor, span_lo: torch.Tensor, span_hi: torch.Tensor,
            validity: torch.Tensor | None, bad: torch.Tensor | None = None,
            fault: str = "") -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(lens, the owning row of each element, its place in its list): row r
    holds the steps k in [span_lo[r], span_hi[r]]. A row where ``bad``
    holds raises ``ComputeError(fault)``, read with the total."""
    lens = (span_hi - span_lo + 1).clamp(min=0)
    if validity is not None:
        lens = torch.where(validity, lens, 0)
    read = [lens.sum()] + ([] if bad is None else [bad.any().to(torch.int64)])
    total, *flag = torch.stack(read).tolist() if lens.shape[0] else [0, 0]  # the one read
    if bad is not None and flag[0]:
        raise ComputeError(fault)
    n = lens.shape[0]
    rows = torch.arange(n, dtype=torch.int64, device=lens.device)
    elem_owner = torch.repeat_interleave(rows, lens, output_size=total)
    offs = torch.cumsum(lens, 0) - lens
    pos = torch.arange(total, dtype=torch.int64, device=lens.device) - offs.index_select(0, elem_owner)
    return lens, elem_owner, pos + span_lo.index_select(0, elem_owner)


def _steps(span: torch.Tensor, step: torch.Tensor, closed: str) -> tuple[torch.Tensor, torch.Tensor]:
    """(first, last) step k of ``start + k * step`` within ``span = end -
    start`` under ``closed`` (both, left, right, none)."""
    last = torch.div(span, step, rounding_mode="floor")
    exact = last * step == span
    if closed in ("left", "none"):
        last = torch.where(exact, last - 1, last)
    first = torch.zeros_like(last) if closed in ("both", "left") else torch.ones_like(last)
    return first, last


def _fixed_range(owner: Val, lo: Val, hi: Val, step: torch.Tensor, closed: str, out_dtype: dt.DataType,
                 child_dtype: dt.DataType) -> Val:
    a = lo.values.to(torch.int64)
    b = hi.values.to(torch.int64)
    first, last = _steps(b - a, step, closed)
    validity = combine_validity(lo.validity, hi.validity)
    lens, own, k = _ranges(owner, a, first, last, validity)
    values = a.index_select(0, own) + k * (step if step.dim() == 0 else step.index_select(0, own))
    child = Val(values.to(dt.dtype_to_torch(child_dtype)), None, child_dtype)
    return make_list(owner.with_(validity=validity, dtype=out_dtype), lens, child, out_dtype)


def _int_ranges_dt(dts, opts):
    return dt.List(opts.get("dtype") or dt.Int64())


@register("int_ranges", _int_ranges_dt)
def _int_ranges(ctx, args, opts):
    """``start, start + step, ...`` up to ``end`` (excluded) per row."""
    lo, hi, st = _rows(list(args))
    step = st.values.to(torch.int64)
    zero = step == 0 if st.validity is None else (step == 0) & st.validity
    safe = torch.where(step == 0, 1, step)
    a, b = lo.values.to(torch.int64), hi.values.to(torch.int64)
    last = torch.where(step > 0, torch.div(b - a - 1, safe, rounding_mode="floor"),
                       torch.div(b - a + 1, safe, rounding_mode="floor"))
    validity = combine_validity(lo.validity, hi.validity, st.validity)
    lens, own, k = _ranges(lo, a, torch.zeros_like(last), last, validity, zero, "int_ranges: step must not be zero")
    inner = opts.get("dtype") or dt.Int64()
    values = a.index_select(0, own) + k * step.index_select(0, own)
    out = dt.List(inner)
    return make_list(lo.with_(validity=validity, dtype=out), lens, Val(values.to(dt.dtype_to_torch(inner)), None,
                                                                         inner), out)


def _interval(interval: str, dtype: dt.DataType) -> int:
    from polars_tpu_torch.engine.rolling import interval_ticks

    return interval_ticks(interval, dtype)


_MONTHS = {"mo": 1, "q": 3, "y": 12}


def _split_calendar(interval: str) -> tuple[int, str]:
    """(the months of an interval, its fixed rest): ``mo``, ``q`` (three
    months) and ``y`` (twelve)."""
    months = sum(int(n) * _MONTHS[u] for n, u in re.findall(r"(\d+)(mo|q|y)", interval))
    return months, re.sub(r"\d+(mo|q|y)", "", interval)


def _calendar_range(owner: Val, a: torch.Tensor, b: torch.Tensor, validity, months: int, fixed: int,
                    per_day: int, closed: str) -> tuple[torch.Tensor, torch.Tensor]:
    """(lens, the elements) of the ranges from ``a`` to ``b`` (ticks, ``per_day``
    to a day) by ``months`` and ``fixed`` ticks: element k is the start's
    civil date moved ``k * months`` months, its day clamped at the month's
    end, at the start's time of day, plus ``k * fixed``. The last k is
    found by 32 halvings of [-1, the months between the bounds / months],
    with no host read (k past that bound lies in a later month than ``b``)."""
    from polars_tpu_torch.kernels.fastmath import floordiv_any
    from polars_tpu_torch.kernels.temporal import civil_from_days, days_from_civil, days_in_month

    days = floordiv_any(a, per_day)
    tod = a - days * per_day
    y, m, d = civil_from_days(days)
    base = y.to(torch.int64) * 12 + m.to(torch.int64) - 1
    by, bm, _ = civil_from_days(floordiv_any(b, per_day))
    span = by.to(torch.int64) * 12 + bm.to(torch.int64) - 1 - base

    def at(k, base, d, tod):
        mi = base + k * months
        yy = floordiv_any(mi, 12)
        mm = mi - yy * 12 + 1
        dd = torch.minimum(d.to(torch.int64), days_in_month(yy, mm).to(torch.int64))
        return days_from_civil(yy, mm, dd).to(torch.int64) * per_day + tod + k * fixed

    def within(t):
        return t <= b if closed in ("both", "right") else t < b

    lo_k = torch.full_like(a, -1)
    hi_k = torch.where(span >= 0, floordiv_any(span.clamp(min=0), months), -1) + 1
    for _ in range(32):
        mid = floordiv_any(lo_k + hi_k, 2)
        ok = within(at(mid, base, d, tod)) & (mid > lo_k)
        lo_k, hi_k = torch.where(ok, mid, lo_k), torch.where(ok | (mid <= lo_k), hi_k, mid)
    first = torch.zeros_like(a) if closed in ("both", "left") else torch.ones_like(a)
    lens, own, k = _ranges(owner, a, first, lo_k, validity)
    return lens, at(k, base.index_select(0, own), d.index_select(0, own), tod.index_select(0, own))


def _stepped(lo: Val, hi: Val, interval: str, target: dt.DataType, per_day: int, closed: str,
             out: dt.DataType) -> Val:
    """The ranges from ``lo`` to ``hi`` by ``interval`` (fixed or calendar),
    as a List of ``target``."""
    months, rest = _split_calendar(interval)
    if not months:
        step = torch.tensor(_interval(interval, target), device=lo.values.device)
        return _fixed_range(lo, lo, hi, step, closed, out, target)
    fixed = _interval(rest, target) if rest else 0
    validity = combine_validity(lo.validity, hi.validity)
    lens, values = _calendar_range(lo, lo.values.to(torch.int64), hi.values.to(torch.int64), validity, months,
                                   fixed, per_day, closed)
    child = Val(values.to(dt.dtype_to_torch(target)), None, target)
    return make_list(lo.with_(validity=validity, dtype=out), lens, child, out)


def _date_ranges_dt(dts, opts):
    return dt.List(dt.Date())


@register("date_ranges", _date_ranges_dt)
def _date_ranges(ctx, args, opts):
    lo, hi = _rows([_as(a, dt.Date()) for a in args])
    return _stepped(lo, hi, opts.get("interval", "1d"), dt.Date(), 1, opts.get("closed", "both"),
                    dt.List(dt.Date()))


def _datetime_ranges_dt(dts, opts):
    return dt.List(dt.Datetime(opts.get("time_unit") or "us", opts.get("time_zone")))


@register("datetime_ranges", _datetime_ranges_dt)
def _datetime_ranges(ctx, args, opts):
    """Per row, the Datetimes from ``start`` to ``end``. With ``time_zone``
    the bounds are wall times of the zone (an aware bound is read on its
    wall clock): a calendar interval or whole days step on the wall clock
    and each element is localized (one that does not exist there, or
    exists twice, fails the segment at its count read, as Polars raises);
    a sub-day interval steps the localized bounds in UTC."""
    from polars_tpu_torch.kernels.timezone import local_from_utc, utc_from_local

    tu, tz = opts.get("time_unit") or "us", opts.get("time_zone")
    naive = dt.Datetime(tu)
    closed, interval = opts.get("closed", "both"), opts.get("interval", "1d")
    bounds = []
    for a in args:
        x = _as(a, dt.Datetime(tu, getattr(a.dtype, "time_zone", None)) if isinstance(a.dtype, dt.Datetime)
                else naive)
        if tz is not None and getattr(x.dtype, "time_zone", None):
            x = x.with_(values=local_from_utc(x.values.to(torch.int64), tu, x.dtype.time_zone))
        bounds.append(x.with_(dtype=naive))
    lo, hi = _rows(bounds)
    per_day = dt.TICKS_PER_SECOND[tu] * 86_400
    out = dt.List(dt.Datetime(tu, tz))
    months, rest = _split_calendar(interval)
    if tz is None:
        return _stepped(lo, hi, interval, naive, per_day, closed, out)
    if not months and _interval(interval, naive) % per_day:  # sub-day: steps of elapsed time, in UTC
        lo, hi = (x.with_(values=utc_from_local(x.values.to(torch.int64), tu, tz)[0]) for x in (lo, hi))
        return _stepped(lo, hi, interval, naive, per_day, closed, out)
    res = _stepped(lo, hi, interval, naive, per_day, closed, out)
    utc, ambiguous, missing = utc_from_local(res.child.values, tu, tz)
    ctx.add_flag((ambiguous | missing).any(), f"a datetime of the range is ambiguous or non-existent in time zone "
                 f"{tz}", ComputeError)
    return res.with_(child=res.child.with_(values=utc))


def _time_ranges_dt(dts, opts):
    return dt.List(dt.Time())


@register("time_ranges", _time_ranges_dt)
def _time_ranges(ctx, args, opts):
    lo, hi = _rows([_as(a, dt.Time()) for a in args])
    step = torch.tensor(_interval(opts.get("interval", "1h"), dt.Time()), device=lo.values.device)
    return _fixed_range(lo, lo, hi, step, opts.get("closed", "both"), dt.List(dt.Time()), dt.Time())


def space_steps(n, closed: str):
    """(the first step k, the denominator) of ``n`` evenly spaced values
    under ``closed``: value k is ``start + (end - start) * k / denominator``
    for the ``n`` steps from the first; ``n`` an int or a tensor."""
    first = 1 if closed in ("right", "none") else 0
    denom = {"both": n - 1, "left": n, "right": n, "none": n + 1}[closed]
    if closed == "both":
        denom = denom.clamp(min=1) if isinstance(denom, torch.Tensor) else max(denom, 1)
    return first, denom


def _linear_spaces_dt(dts, opts):
    return dt.List(dt.Float64())


@register("linear_spaces", _linear_spaces_dt)
def _linear_spaces(ctx, args, opts):
    """``num_samples`` evenly spaced Float64 values per row between the
    bounds (``closed`` says which bounds are among them)."""
    lo, hi, num = _rows(list(args))
    n = num.values.to(torch.int64)
    validity = combine_validity(lo.validity, hi.validity, num.validity)
    first_k, denom = space_steps(n, opts.get("closed", "both"))
    first = torch.full_like(n, first_k)
    lens, own, k = _ranges(lo, n, first, first + n - 1, validity)
    denom = denom.to(torch.float64)
    a = lo.values.to(torch.float64).index_select(0, own)
    b = hi.values.to(torch.float64).index_select(0, own)
    values = a + (b - a) * k.to(torch.float64) / denom.index_select(0, own)
    out = dt.List(dt.Float64())
    return make_list(lo.with_(validity=validity, dtype=out), lens, Val(values, None, dt.Float64()), out)


def _repeat_by_dt(dts, opts):
    return dt.List(dts[0])


@register("repeat_by", _repeat_by_dt)
def _repeat_by(ctx, args, opts):
    """Each value repeated ``by`` times, as a List (a null count gives a
    null list); the child gathers the values, one read of its size."""
    from polars_tpu_torch.engine.fn_nested import gather_val

    v, by = _rows(list(args))
    counts = by.values.to(torch.int64)
    negative = counts < 0 if by.validity is None else (counts < 0) & by.validity
    lens, own, _ = _ranges(v, counts, torch.zeros_like(counts), counts - 1, by.validity, negative,
                           "repeat_by: a negative count")
    out = dt.List(v.dtype)
    return make_list(v.with_(validity=by.validity, dtype=out), lens, gather_val(v, own), out)


def _as(v: Val, target: dt.DataType) -> Val:
    """A bound in ``target``'s ticks (a Date to a Datetime, say)."""
    if v.dtype == target:
        return v
    from polars_tpu_torch.engine.cast import cast_val

    return cast_val(v, target)

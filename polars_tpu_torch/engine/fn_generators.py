"""Ranges per row, as List values in a segment (the port of the JAX
package's host generators ``int_ranges``, ``date_ranges``,
``datetime_ranges``, ``time_ranges`` and ``linear_spaces``, which build
each row's list on the host, ``engine/run.py:1252``).

Each row's length comes from its bounds on the device; one host read of
the total (with the flag of a bad argument: a zero step, a negative
count) sizes the child, which is the starts repeated by
``repeat_interleave`` plus each element's place in its list times the
step. A null bound gives a null list. Fixed intervals only: a calendar one
(months, quarters, years) per row is refused (ROADMAP item 4c); a scalar
``date_range`` steps months on the host (``engine/hostops.generate``).
"""

from __future__ import annotations

import torch

from polars_tpu_torch import datatypes as dt
from polars_tpu_torch.engine.common import SCALAR, Val, combine_validity
from polars_tpu_torch.engine.fn_nested import make_list
from polars_tpu_torch.engine.registry import register
from polars_tpu_torch.errors import ComputeError, InvalidOperationError


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

    try:
        return interval_ticks(interval, dtype)
    except InvalidOperationError:
        raise InvalidOperationError(f"a range per row by the calendar interval {interval!r} is not ported yet "
                                    "(port queue: item 4c)") from None


def _date_ranges_dt(dts, opts):
    return dt.List(dt.Date())


@register("date_ranges", _date_ranges_dt)
def _date_ranges(ctx, args, opts):
    lo, hi = _rows([_as(a, dt.Date()) for a in args])
    step = torch.tensor(_interval(opts.get("interval", "1d"), dt.Date()), device=lo.values.device)
    return _fixed_range(lo, lo, hi, step, opts.get("closed", "both"), dt.List(dt.Date()), dt.Date())


def _datetime_ranges_dt(dts, opts):
    return dt.List(dt.Datetime(opts.get("time_unit") or "us"))


@register("datetime_ranges", _datetime_ranges_dt)
def _datetime_ranges(ctx, args, opts):
    target = dt.Datetime(opts.get("time_unit") or "us")
    lo, hi = _rows([_as(a, target) for a in args])
    step = torch.tensor(_interval(opts.get("interval", "1d"), target), device=lo.values.device)
    return _fixed_range(lo, lo, hi, step, opts.get("closed", "both"), dt.List(target), target)


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

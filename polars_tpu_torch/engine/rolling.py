"""Windows over rows and over time (the port of ``polars_tpu/engine/rolling.py``,
``rolling_window_core`` and ``rolling_frames``, with the window arithmetic of
``engine/fn_position.py``'s ``_rolling``, ``_rolling_by`` and
``_rolling_order``). The expressions that use it are registered in
``engine/fn_rolling.py``.

A window is a run ``[lo, hi)`` of *slots*: the rows arranged so that every
window is contiguous. Row windows (``rolling_sum(w)``) run in the group space
of ``fn_position.group_order``; time windows (``rolling_sum_by``,
``LazyFrame.rolling``) sort the rows by (group, time) once (:class:`TimeOrder`)
and find each row's run with two ``searchsorted`` calls over the composite
key. Nothing here reads the device inside a segment.

Aggregations over the runs (:class:`SlotColumn`):

- sums, means, counts and variances are differences of prefix sums. A prefix
  over 60M rows grows far beyond one window's sum, and the JAX package's
  ``s2 - cnt * m**2`` over it loses most of a variance's digits. Here each
  value is shifted by the first finite value of its group, and each prefix
  carries a second prefix of its own rounding errors (a compensated prefix),
  so a window's sum is about as exact as a sum of its own values. NaN and
  the infinities are counted apart, so that one of them does not poison the
  prefix past its window (the JAX package's sums are NaN for every later
  window, ROADMAP section 3).
- min and max read a table of block extremes, doubled level by level in
  place (no stack of levels), each window as the binary digits of its width.
- median, quantile and rank sort each window's values, a block of slots at a
  time (the JAX package stacks ``window_size`` copies of the whole column).
"""

from __future__ import annotations

import re

import torch

from polars_tpu_torch import datatypes as dt
from polars_tpu_torch.engine.cast import float_values
from polars_tpu_torch.engine.fn_position import marked_neighbours
from polars_tpu_torch.errors import InvalidOperationError

_I64_MAX = 2**63 - 1
KEY_LIMIT = 1 << 62
# elements of one block of stacked windows (median, quantile, rank)
_STACK_ELEMENTS = 1 << 24
SUPPORTED = ("sum", "mean", "count", "len", "min", "max", "first", "last", "var", "std")


def interval_ticks(interval: str, dtype: dt.DataType) -> int:
    """A fixed interval (``"5m"``, ``"1h30m"``, ``"3i"``) in ticks of an index
    column of ``dtype``: days of a Date, its unit of a Datetime, nanoseconds
    of a Time, counts (``i``) of an integer (the JAX package's
    ``LazyGroupByDynamic._ticks``)."""
    total = 0
    pos = 0
    for m in re.finditer(r"(\d+)(ns|us|ms|s|mo|m|h|d|w|q|y|i)", interval):
        if m.start() != pos:
            raise InvalidOperationError(f"unsupported interval {interval!r}")
        pos = m.end()
        n, unit = int(m.group(1)), m.group(2)
        if unit == "i":
            total += n
            continue
        if unit in ("mo", "q", "y"):
            raise InvalidOperationError("calendar intervals handled separately")
        us = {"ns": 1e-3, "us": 1, "ms": 1_000, "s": 1_000_000, "m": 60_000_000, "h": 3_600_000_000,
              "d": 86_400_000_000, "w": 604_800_000_000}[unit]
        if isinstance(dtype, dt.Date):
            if us % 86_400_000_000:
                raise InvalidOperationError(f"sub-day interval {interval!r} on Date index")
            total += n * int(us // 86_400_000_000)
        elif isinstance(dtype, dt.Datetime):
            total += int(n * us * {"ms": 1e-3, "us": 1, "ns": 1e3}[dtype.time_unit])
        elif isinstance(dtype, dt.Time):
            total += int(n * us * 1e3)
        else:
            raise InvalidOperationError(f"interval {interval!r} on integer index needs 'i' units")
    if pos != len(interval) or total <= 0:
        raise InvalidOperationError(f"unsupported interval {interval!r}")
    return total


def _pad0(t: torch.Tensor) -> torch.Tensor:
    return torch.cat([t.new_zeros(1), t])


def _at(p: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """``p[hi] - p[lo]`` of a prefix padded with its leading 0."""
    return p.index_select(0, hi) - p.index_select(0, lo)


def compensated_prefix(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(the prefix sums of ``x``, the prefix sums of their rounding errors),
    each with a leading 0. Each step ``p[i] - p[i-1]`` of a float prefix is
    exact where neighbouring sums lie within a factor of two, so ``x[i]``
    minus it is exactly what the sum lost at ``i``; a window's sum is the
    difference of both prefixes."""
    p = torch.cumsum(x, 0)
    step = p.clone()
    step[1:] -= p[:-1]
    return _pad0(p), _pad0(torch.cumsum(x - step, 0))


def two_sum(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(a + b rounded, its rounding error), exactly (Knuth's TwoSum)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def two_prod(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(a * b rounded, its rounding error), exactly (Dekker's product over
    26-bit halves; no fused multiply-add needed)."""
    p = a * b
    ca, cb = 134217729.0 * a, 134217729.0 * b  # 2^27 + 1
    ah, bh = ca - (ca - a), cb - (cb - b)
    al, bl = a - ah, b - bh
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _ident(dtype: torch.dtype, kind: str):
    if dtype.is_floating_point:
        return float("inf") if kind == "min" else float("-inf")
    return torch.iinfo(dtype).max if kind == "min" else torch.iinfo(dtype).min


def range_extreme(x: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor, kind: str, max_width: int) -> torch.Tensor:
    """min or max of ``x[lo:hi)`` for each window (``x`` holds the identity
    where a value does not count). Level k's table holds the extreme of the
    2^k slots from each slot; a window takes, for each binary digit of its
    width from the lowest, the table at its running position. One table at a
    time, levels up to ``max_width``."""
    n = x.shape[0]
    acc = torch.full(lo.shape, _ident(x.dtype, kind), dtype=x.dtype, device=x.device)
    if n == 0 or lo.shape[0] == 0:
        return acc
    op = torch.minimum if kind == "min" else torch.maximum
    width = (hi - lo).clamp(min=0)
    pos = lo.clone()
    table = x
    k = 0
    while True:
        take = ((width >> k) & 1).bool()
        acc = torch.where(take, op(acc, table.index_select(0, pos.clamp(0, n - 1))), acc)
        pos = pos + (take.to(torch.int64) << k)
        s = 1 << k
        if 2 * s > max_width or s >= n:
            break
        nxt = table.clone()
        nxt[: n - s] = op(table[: n - s], table[s:])
        table, k = nxt, k + 1
    return acc


def segment_first(ok: torch.Tensor, start: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(the first slot of each slot's segment that ``ok`` marks, clamped;
    whether there is one)."""
    n = ok.shape[0]
    src = marked_neighbours(ok)[1].index_select(0, start)
    srcc = src.clamp(max=max(n - 1, 0))
    return srcc, (src < n) & (start.index_select(0, srcc) == start)


class SlotColumn:
    """One column in slot order, with the prefix sums its windows share,
    each made on first use: ``xs`` its storage values, ``ok`` whether each
    value counts, ``start`` the first slot of each slot's segment."""

    def __init__(self, xs: torch.Tensor, ok: torch.Tensor, start: torch.Tensor, dtype: dt.DataType) -> None:
        self.xs, self.ok, self.start, self.dtype = xs, ok, start, dtype
        self._memo: dict = {}

    def _lazy(self, key: str, make):
        if key not in self._memo:
            self._memo[key] = make()
        return self._memo[key]

    @property
    def count_prefix(self) -> torch.Tensor:
        return self._lazy("count", lambda: _pad0(torch.cumsum(self.ok, 0, dtype=torch.int32)))

    @property
    def floats(self) -> torch.Tensor:
        return self._lazy("floats", lambda: float_values(self.xs, self.dtype, torch.float64))

    @property
    def is_float(self) -> bool:
        return self.xs.is_floating_point()

    @property
    def shift(self) -> torch.Tensor:
        """Per slot: the first finite counted value of its segment (0 where
        there is none)."""

        def make():
            x = self.floats
            src, has = segment_first(self.ok & torch.isfinite(x), self.start)
            return torch.where(has, x.index_select(0, src), 0.0)

        return self._lazy("shift", make)

    def _finite(self) -> torch.Tensor:
        return self._lazy("finite", lambda: self.ok & torch.isfinite(self.floats))

    def _deviations(self) -> torch.Tensor:
        return self._lazy("d", lambda: torch.where(self._finite(), self.floats - self.shift, 0.0))

    def _moment(self, power: int):
        """The prefixes of the deviations (power 1), or of their exact
        squares (power 2: the rounded squares' compensated prefix and the
        plain prefix of the squares' rounding errors)."""

        def make():
            d = self._deviations()
            if power == 1:
                return compensated_prefix(d)
            sq, err = two_prod(d, d)
            return (*compensated_prefix(sq), _pad0(torch.cumsum(err, 0)))

        return self._lazy(f"m{power}", make)

    def _window_sum(self, power: int, lo: torch.Tensor, hi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """A window's sum of deviations (or of their squares) as an
        unevaluated pair (high part, low part)."""
        pre = self._moment(power)
        a, err = two_sum(pre[0].index_select(0, hi), -pre[0].index_select(0, lo))
        low = err + _at(pre[1], lo, hi)
        return a, low + _at(pre[2], lo, hi) if power == 2 else low

    def _nonfinite(self):
        """Prefix counts of the counted NaN, +inf and -inf values."""

        def make():
            x, ok = self.floats, self.ok
            return tuple(_pad0(torch.cumsum(ok & m, 0, dtype=torch.int32))
                         for m in (torch.isnan(x), x == float("inf"), x == float("-inf")))

        return self._lazy("nonfinite", make)

    def _int_prefix(self) -> torch.Tensor:
        return self._lazy("isum", lambda: _pad0(torch.cumsum(torch.where(self.ok, self.xs.to(torch.int64), 0), 0)))

    def agg(self, kind: str, lo: torch.Tensor, hi: torch.Tensor, *, ddof: int = 1,
            max_width: int = 0) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None]:
        """(``kind`` of each window's counted values, their count, a further
        validity or None): sum, mean, count, len, min, max, first, last, var,
        std. Integer sums are exact (int64); the float aggregations are
        Float64."""
        n = self.xs.shape[0]
        cnt = _at(self.count_prefix, lo, hi)
        if kind == "count":
            return cnt, cnt, None
        if kind == "len":
            return hi - lo, cnt, None
        if kind in ("first", "last"):
            pos = (lo if kind == "first" else hi - 1).clamp(0, max(n - 1, 0))
            return self.xs.index_select(0, pos), cnt, (hi > lo) & self.ok.index_select(0, pos)
        if kind in ("min", "max"):
            x = self.xs.to(torch.int8) if self.xs.dtype == torch.bool else self.xs
            x = torch.where(self.ok, x, _ident(x.dtype, kind))
            return range_extreme(x, lo, hi, kind, max_width).to(self.xs.dtype), cnt, None
        if kind == "sum" and not self.is_float:
            return _at(self._int_prefix(), lo, hi), cnt, None
        if kind not in ("sum", "mean", "var", "std"):
            raise InvalidOperationError(f"rolling aggregation {kind!r} is not supported")
        x0 = self.shift.index_select(0, lo.clamp(0, max(n - 1, 0))) if n else torch.zeros(lo.shape, dtype=torch.float64)
        c = cnt.to(torch.float64)
        a1, b1 = self._window_sum(1, lo, hi)
        extra = None
        if kind == "sum":
            out = (a1 + b1) + c * x0
        elif kind == "mean":
            out = x0 + (a1 + b1) / c.clamp(min=1.0)
        else:
            # n * S2 - S1^2 in double-double: the two terms cancel wherever
            # the window's spread is small beside its distance from the shift
            a2, b2 = self._window_sum(2, lo, hi)
            q, qe = two_prod(c, a2)
            p, pe = two_prod(a1, a1)
            num = (q - p) + ((qe - pe) + c * b2 - 2.0 * a1 * b1 - b1 * b1)
            out = (num.clamp(min=0.0) / (c * (c - ddof)).clamp(min=1.0))
            out = out.sqrt() if kind == "std" else out
            extra = c > ddof
        if self.is_float:
            nan, pinf, ninf = (_at(p, lo, hi) > 0 for p in self._nonfinite())
            if kind in ("var", "std"):
                out = torch.where(nan | pinf | ninf, float("nan"), out)
            else:
                out = torch.where(pinf, float("inf"), torch.where(ninf, float("-inf"), out))
                out = torch.where(nan | (pinf & ninf), float("nan"), out)
        return out, cnt, extra


class TimeOrder:
    """The rows sorted by (group, time): one stable sort of the composite
    key ``group * stride + (t - tmin)`` (a row that does not count sorts
    last), each row's key, the sorted keys and the first slot of each slot's
    group. ``gid`` is None without groups; ``stride`` a 0-d int64 tensor or
    an int."""

    def __init__(self, t: torch.Tensor, valid: torch.Tensor, gid: torch.Tensor | None, stride) -> None:
        n = t.shape[0]
        t64 = t.to(torch.int64)
        big = torch.full((), _I64_MAX, dtype=torch.int64, device=t.device)
        tmin = torch.where(valid, t64, big).min() if n else big
        tmin = torch.where(valid.any(), tmin, 0) if n else tmin
        key = torch.where(valid, t64 - tmin, 0)
        self.band = None
        if gid is not None:  # the lowest key of the row's group's band
            self.band = torch.where(valid, gid.to(torch.int64), 0) * stride
            self.stride = stride
            key = key + self.band
        skey, self.perm = torch.sort(torch.where(valid, key, big), stable=True)
        self.key, self.skey, self.valid = key, skey, valid
        self.nvalid = valid.sum()
        first = torch.ones(n, dtype=torch.bool, device=t.device)
        if gid is not None and n:
            sg = gid.to(torch.int64).index_select(0, self.perm)
            first[1:] = sg[1:] != sg[:-1]
        elif n:
            first[1:] = False
        self.start = marked_neighbours(first)[0] if n else torch.zeros(0, dtype=torch.int64, device=t.device)
        self._bounds: dict = {}
        self._columns: list = []

    @property
    def n(self) -> int:
        return self.perm.shape[0]

    def bounds(self, period: int, offset: int, closed: str) -> tuple[torch.Tensor, torch.Tensor]:
        """Each row's window ``(t + offset, t + offset + period]`` as slots
        ``[lo, hi)`` (``closed`` says which ends belong to it)."""
        memo = (period, offset, closed)
        if memo not in self._bounds:
            lo_side, hi_side = {"right": ("right", "right"), "left": ("left", "left"), "both": ("left", "right"),
                                "none": ("right", "left")}[closed]
            lo_q, hi_q = self.key + offset, self.key + (offset + period)
            if self.band is not None:  # keep both ends in the row's group
                lo_q = torch.minimum(torch.maximum(lo_q, self.band - 1), self.band + (self.stride - 1))
                hi_q = torch.minimum(torch.maximum(hi_q, self.band - 1), self.band + (self.stride - 1))
            lo = torch.searchsorted(self.skey, lo_q, side=lo_side)
            hi = torch.searchsorted(self.skey, hi_q, side=hi_side)
            self._bounds[memo] = (torch.minimum(lo, self.nvalid), torch.minimum(hi, self.nvalid))
        return self._bounds[memo]

    def column(self, values: torch.Tensor, validity: torch.Tensor | None, dtype: dt.DataType) -> SlotColumn:
        """``values`` in slot order (made once per tensor)."""
        for v, m, col in self._columns:
            if v is values and m is validity:
                return col
        ok = self.valid if validity is None else (self.valid & validity)
        col = SlotColumn(values.index_select(0, self.perm), ok.index_select(0, self.perm), self.start, dtype)
        self._columns.append((values, validity, col))
        return col


def group_stride(t: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The composite key's stride, a 0-d tensor: the span of the counted
    times plus two, so that each group's keys lie in a band of their own with
    a free key at each end (``TimeOrder.bounds`` clamps a window's ends into
    its row's band, whatever its period)."""
    t64 = t.to(torch.int64)
    if not t64.shape[0]:
        return torch.full((), 2, dtype=torch.int64, device=t.device)
    tmin = torch.where(valid, t64, _I64_MAX).min()
    tmax = torch.where(valid, t64, -_I64_MAX - 1).max()
    return (tmax - tmin).clamp(min=0) + 2


# -- row windows ---------------------------------------------------------------------------


def row_bounds(o, w: int, center: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Each slot's window of ``w`` slots in group space (the last ``w``
    slots to it, or centred), clipped to its segment."""
    iota = torch.arange(o.n, dtype=torch.int64, device=o.perm.device)
    offs = (w - 1) // 2 if center else 0
    lo = torch.maximum(iota - (w - 1) + offs, o.start)
    hi = torch.minimum(iota + offs, o.end) + 1
    return lo, torch.maximum(hi, lo)


def row_shifts(w: int, center: bool) -> list[int]:
    """The window's offsets from its slot, in order (weights[i] goes with
    the i-th)."""
    offs = (w - 1) // 2 if center else 0
    return [i - (w - 1) + offs for i in range(w)]


def shifted(o, x: torch.Tensor, ok: torch.Tensor, sh: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(``x`` at each slot plus ``sh``, whether it lies in the slot's segment
    and counts)."""
    n = o.n
    src = torch.arange(n, dtype=torch.int64, device=x.device) + sh
    inb = (src >= o.start) & (src <= o.end)
    srcc = src.clamp(0, max(n - 1, 0))
    return x.index_select(0, srcc), inb & ok.index_select(0, srcc)


def stacked_windows(o, x: torch.Tensor, ok: torch.Tensor, w: int, center: bool, fn) -> torch.Tensor:
    """``fn(values, counted, slots)`` over the stacked windows of a block of
    slots at a time: ``values`` and ``counted`` are (w, block) with row i at
    the i-th offset, ``slots`` the block's slot indices. The blocks hold at
    most about 16M values, whatever the column's length."""
    n = o.n
    shifts = torch.tensor(row_shifts(w, center), dtype=torch.int64, device=x.device)[:, None]
    block = max(1, _STACK_ELEMENTS // max(w, 1))
    outs = []
    for c0 in range(0, n, block):
        slots = torch.arange(c0, min(n, c0 + block), dtype=torch.int64, device=x.device)
        src = slots[None, :] + shifts
        inb = (src >= o.start.index_select(0, slots)[None, :]) & (src <= o.end.index_select(0, slots)[None, :])
        srcc = src.clamp(0, n - 1)
        outs.append(fn(x[srcc], inb & ok[srcc], slots))
    return torch.cat(outs) if outs else x.new_zeros(0)


# -- LazyFrame.rolling ----------------------------------------------------------------------


def rolling_frames(df, index: str, period_ticks: int, offset_ticks: int, closed: str, gb_names: list[str],
                   aggs: list[tuple]):
    """One window per row of ``df``, ``(t + offset, t + offset + period]``
    by ``index`` within each group of ``gb_names`` (dictionary-coded keys),
    and each aggregation of ``aggs`` (source column, kind, output name,
    output dtype[, min_samples[, ddof]]) over it. The rows keep their order;
    the output has the group and index columns, then the aggregations. With
    groups, one host read: the span of the index, which sizes the composite
    key and its overflow check."""
    from polars_tpu_torch.core.buffer import Buffer
    from polars_tpu_torch.core.column import Column
    from polars_tpu_torch.core.frame import DataFrame

    aggs = [tuple(a) + (1, 1)[len(a) - 4:] for a in aggs]
    icol = df._get(index)
    t = icol.buffer.values
    valid = torch.ones(df.height, dtype=torch.bool, device=t.device) if icol.buffer.validity is None \
        else icol.buffer.validity
    gid, stride = None, 0
    if gb_names:
        gid = torch.zeros(df.height, dtype=torch.int64, device=t.device)
        n_groups = 1
        for gname in gb_names:
            gcol = df._get(gname)
            if gcol.table is None:
                raise InvalidOperationError("rolling group_by currently needs string/categorical keys")
            size = len(gcol.table.values) + 1
            codes = gcol.buffer.values.to(torch.int64) + 1
            if gcol.buffer.validity is not None:
                codes = torch.where(gcol.buffer.validity, codes, 0)
            gid = gid * size + codes
            n_groups *= size
        t64 = t.to(torch.int64)
        lo_hi = torch.stack([torch.where(valid, t64, _I64_MAX).min(), torch.where(valid, t64, -_I64_MAX - 1).max()]) \
            if df.height else torch.zeros(2, dtype=torch.int64)
        tmin, tmax = lo_hi.tolist()
        stride = max(tmax - tmin, 0) + 2
        if n_groups * stride >= KEY_LIMIT:
            raise InvalidOperationError("rolling group_by: time span times group count exceeds the composite key "
                                        "range; pre-partition the frame instead")
    order = TimeOrder(t, valid, gid, stride)
    lo, hi = order.bounds(period_ticks, offset_ticks, closed)
    out_cols = [c for c in df._columns if c.name in (*gb_names, index)]
    for src, kind, out_name, out_dtype, minp, ddof in aggs:
        if kind not in SUPPORTED:
            raise InvalidOperationError(f"rolling agg {kind!r} unsupported")
        scol = df._get(src)
        values, vdtype = scol.buffer.values, scol.dtype
        if scol.dtype.is_nested() and kind in ("min", "max"):  # by content: the least or greatest rank's value
            from polars_tpu_torch.engine.common import col_to_val
            from polars_tpu_torch.kernels.nested_keys import content_rank, rank_rows

            values, vdtype = content_rank(col_to_val(scol)), dt.Int64()
        elif scol.dtype.is_nested() and kind not in ("first", "last", "count", "len"):
            raise InvalidOperationError(f"`rolling_{kind}` operation not supported for dtype `{scol.dtype!r}`")
        col = order.column(values, scol.buffer.validity, vdtype)
        out, cnt, extra = col.agg(kind, lo, hi, ddof=ddof, max_width=order.n)
        if vdtype is not scol.dtype:  # each rank back to a valid row that holds it
            rep = rank_rows(values, scol.buffer.validity).clamp(max=max(df.height - 1, 0))
            out = scol.buffer.values.index_select(0, rep.index_select(0, out.to(torch.int64).clamp(0, df.height)))
        ok = valid if kind in ("count", "len") else (cnt >= max(minp or 1, 1)) & valid
        if extra is not None:
            ok = ok & extra
        values = out.to(dt.dtype_to_torch(out_dtype))
        out_cols.append(Column(out_name, out_dtype, Buffer(values, None if kind in ("count", "len") and
                                                           icol.buffer.validity is None else ok, df.height),
                               scol.table if kind in ("first", "last", "min", "max") else None,
                               scol.child if kind in ("first", "last", "min", "max") else None))
    return DataFrame._from_columns(out_cols, df.height, device=df.device)

"""Order and position functions (the port of ``polars_tpu/engine/fn_position.py``
through ``arg_sort``, with ``arg_sort_by``, the fill strategies and the
peaks): shift, diff, pct_change, the cumulative functions, reverse, the
forward and backward fills, interpolate, rank, arg_sort, and the group
order that the expression-level sorts (``compiler._eval_sort``) and the
distinct flags (``fn_core``) share. Reference kernels:
polars-ops/src/series/ops/{cum_agg,diff,pct_change,rank}.rs.

Every function runs in *group space*: the rows arranged by one stable
permutation (:func:`group_order`) so that each group's rows are contiguous,
in row order (or ``over(order_by=...)`` order), with the rows the segment's
mask drops in a segment of their own at the end. A function works on its
segments there with scans that reset at each segment's start, and its result
goes back to the rows through the same permutation. Outside a window or a
group-by the kept rows are one segment: a positional function sees only the
rows that survive the mask, as in Polars (the JAX package runs it over the
padded rows, so a filtered row counts there, ROADMAP section 3). No host
read: the scans are ``cumsum`` (with a scatter for the last or next marked
slot, :func:`marked_neighbours`) or log2(rows) doubling steps.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from polars_tpu_torch import datatypes as dt
from polars_tpu_torch.engine import groupby as G
from polars_tpu_torch.engine.cast import cast_val, float_values, order_word, wrap_unsigned
from polars_tpu_torch.engine.common import ROW, SCALAR, Val, reject_series
from polars_tpu_torch.engine.registry import BOOL, FLOAT, SAME, register
from polars_tpu_torch.engine.strings import ensure_ordinal_val, unify_vals
from polars_tpu_torch.errors import InvalidOperationError
from polars_tpu_torch.kernels import argsort as A
from polars_tpu_torch.kernels.argsort import boundaries_from_words

_BIG = 2**31 - 1


@dataclass
class GroupOrder:
    """The group-space arrangement of a context's rows."""

    perm: torch.Tensor  # (n,) int64: slot j holds row perm[j]
    seg: torch.Tensor  # (n,) segment of each slot, ascending; dropped rows last
    start: torch.Tensor  # (n,) int64: first slot of each slot's segment
    end: torch.Tensor  # (n,) int64: last slot of each slot's segment
    kept: torch.Tensor  # (n,) bool: the row mask in group space

    @property
    def n(self) -> int:
        return self.perm.shape[0]

    def to_group(self, t: torch.Tensor | None) -> torch.Tensor | None:
        return None if t is None else t.index_select(0, self.perm)

    def to_rows(self, t: torch.Tensor | None) -> torch.Tensor | None:
        return None if t is None else torch.empty_like(t).index_copy_(0, self.perm, t)


def _iota(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int64, device=device)


def marked_neighbours(marked: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(the last marked slot at or before each slot, -1 where none; the
    first marked slot at or after it, n where none): one ``cumsum`` of the
    marks and one scatter of the marked slots' positions by their rank.
    (``torch.cummax``/``cummin``, which give the same, are sequential scans
    with indices on the card: 35-90 ms each over 15-60M rows on an H100
    80GB HBM3, ``testing/profile_query.py``.)"""
    n = marked.shape[0]
    iota = _iota(n, marked.device)
    count = torch.cumsum(marked, 0)  # marked slots at or before each slot
    pos = torch.full((n + 2,), n, dtype=torch.int64, device=marked.device)  # rank -> slot; n past the last
    pos.index_copy_(0, torch.where(marked, count - 1, n + 1), iota)  # unmarked slots write the spare slot n + 1
    prev = torch.where(count > 0, pos.index_select(0, (count - 1).clamp(min=0)), -1)
    return prev, pos.index_select(0, count - marked.to(torch.int64))


def _bounds(seg: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(start, end) slot of each slot's segment (``seg`` ascending)."""
    n = seg.shape[0]
    if n == 0:
        return _iota(0, seg.device), _iota(0, seg.device)
    first = torch.ones(n, dtype=torch.bool, device=seg.device)
    first[1:] = seg[1:] != seg[:-1]
    last = torch.ones(n, dtype=torch.bool, device=seg.device)
    last[:-1] = first[1:]
    return marked_neighbours(first)[0], marked_neighbours(last)[1]


def group_order(ctx) -> GroupOrder:
    """The context's group order, made once per context. In a window or a
    group-by: one stable sort by (group, order words), the dropped rows'
    group a sentinel that sorts last (a window without ``order_by`` reuses
    the sort that numbered its groups). Outside one: a stable partition of
    the kept rows before the dropped ones by their running counts, no
    sort."""
    if ctx.order is not None:
        return ctx.order
    mask = ctx.rowmask
    n = mask.shape[0]
    g = ctx.groups
    if g is None:
        kept_rank = torch.cumsum(mask, 0) - 1
        total = kept_rank[-1:] + 1 if n else torch.zeros(1, dtype=torch.int64, device=mask.device)
        slot = torch.where(mask, kept_rank, total + torch.cumsum(~mask, 0) - 1)
        perm = torch.empty(n, dtype=torch.int64, device=mask.device).index_copy_(0, slot, _iota(n, mask.device))
        seg = (_iota(n, mask.device) >= total).to(torch.int32)
    else:
        gkey = torch.where(mask, g.gids, _BIG)
        if g.order_words:
            perm = A.stable_argsort_words([gkey, *g.order_words])
        elif g.sort_perm is not None:
            perm = g.sort_perm
        else:
            perm = A.stable_argsort_words([gkey])
        seg = gkey.index_select(0, perm)
    start, end = _bounds(seg)
    ctx.order = GroupOrder(perm, seg, start, end, mask.index_select(0, perm))
    return ctx.order


def row_domain(ctx, v: Val) -> Val:
    """``v`` per row: a scalar is broadcast to the context's rows."""
    reject_series(v)
    if v.domain == SCALAR:
        return v.with_(values=v.values.expand(ctx.rows).contiguous(),
                       validity=None if v.validity is None else v.validity.expand(ctx.rows).contiguous(), domain=ROW)
    if v.domain != ROW:
        raise InvalidOperationError("an order or position function needs a per-row input, not an aggregate")
    return v


def _in_group_space(ctx, v: Val, fn, out_dtype: dt.DataType | None = None, moves=False) -> Val:
    """``fn(order, values, validity)`` over ``v`` in group space, its
    (values, validity) mapped back to the rows. ``moves``: ``fn`` only moves
    ``v``'s values, which keep their dictionary and their nested child."""
    o = group_order(ctx)
    values, validity = fn(o, o.to_group(v.values), o.to_group(v.validity))
    values, validity = o.to_rows(values), o.to_rows(validity)
    if moves:
        return v.with_(values=values, validity=validity, domain=ROW)
    return Val(values, validity, out_dtype or v.dtype, None, ROW)


def _valid_kept(o: GroupOrder, valid: torch.Tensor | None) -> torch.Tensor:
    return o.kept if valid is None else (valid & o.kept)


def _source(o: GroupOrder, n_sh: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(slot ``n_sh`` places before each slot, clamped; whether it lies in
    the same segment)."""
    src = _iota(o.n, o.perm.device) - n_sh
    ok = (src >= o.start) & (src <= o.end)
    return src.clamp(0, max(o.n - 1, 0)), ok


def _zero(t: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=t.dtype, device=t.device)


@register("shift", SAME, elementwise=False)
def _shift(ctx, args, opts):
    v = row_domain(ctx, args[0])
    n_sh = int(opts.get("n", 1))

    def fn(o, vals, valid):
        src, ok = _source(o, n_sh)
        out = torch.where(ok, vals.index_select(0, src), _zero(vals))
        return out, ok & _valid_kept(o, valid).index_select(0, src)

    return _in_group_space(ctx, v, fn, moves=True)


@register("shift_fill", SAME, elementwise=False)
def _shift_fill(ctx, args, opts):
    v = row_domain(ctx, args[0])
    n_sh = int(opts.get("n", 1))
    fill = cast_val(args[1], v.dtype)
    if v.table is not None:  # both on one dictionary
        v, fill = unify_vals(v, fill)
    if v.dtype.is_nested():
        from polars_tpu_torch.engine.fn_nested import on_one_child

        v, fill = on_one_child([v, fill])
    fill = row_domain(ctx, fill)

    def fn(o, vals, valid):
        src, ok = _source(o, n_sh)
        fv = o.to_group(fill.values)
        out = torch.where(ok, vals.index_select(0, src), fv)
        fvalid = torch.ones_like(ok) if fill.validity is None else o.to_group(fill.validity)
        src_valid = torch.ones_like(ok) if valid is None else valid.index_select(0, src)
        out_valid = torch.where(ok, src_valid, fvalid)
        return out, None if valid is None and fill.validity is None else out_valid

    return _in_group_space(ctx, v, fn, moves=True)


def _diff_dtype(dts, opts):
    """Reference: function_expr/schema.rs Diff: an unsigned type widens to a
    signed one, a temporal type becomes a Duration."""
    d = dts[0]
    name = type(d).__name__
    if name == "Datetime":
        return dt.Duration(d.time_unit)
    if name == "Date":
        return dt.Duration("us")
    if name == "Time":
        return dt.Duration("ns")
    return {"UInt8": dt.Int16(), "UInt16": dt.Int32(), "UInt32": dt.Int64(), "UInt64": dt.Int64()}.get(name, d)


@register("diff", _diff_dtype, elementwise=False)
def _diff(ctx, args, opts):
    v = row_domain(ctx, args[0])
    n_sh = int(opts.get("n", 1))
    out_dt = _diff_dtype([v.dtype], opts)
    scale = 1
    if v.dtype.is_temporal():
        # the int64 difference of the epochs; days scale to microseconds
        scale = 86_400_000_000 if isinstance(v.dtype, dt.Date) else 1
        v = v.with_(values=v.values.to(torch.int64), dtype=dt.Int64())
    elif out_dt != v.dtype:
        v = cast_val(v, out_dt)
    if v.table is not None:
        raise InvalidOperationError(f"diff of {v.dtype!r}")

    def fn(o, vals, valid):
        src, ok = _source(o, n_sh)
        vk = _valid_kept(o, valid)
        ok = ok & vk & vk.index_select(0, src)
        out = torch.where(ok, vals - vals.index_select(0, src), _zero(vals))
        return (out * scale if scale != 1 else out), ok

    return _in_group_space(ctx, v, fn, out_dt)


def _ffill_source(o: GroupOrder, valid: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(the last valid slot at or before each slot, clamped; whether one
    lies in the same segment)."""
    src = marked_neighbours(valid)[0]
    return src.clamp(min=0), src >= o.start


def _bfill_source(o: GroupOrder, valid: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(the first valid slot at or after each slot, clamped; whether one
    lies in the same segment)."""
    src = marked_neighbours(valid)[1]
    return src.clamp(max=max(o.n - 1, 0)), src <= o.end


@register("pct_change", FLOAT, elementwise=False)
def _pct_change(ctx, args, opts):
    """Polars' form: the nulls forward-filled first, then ``x / x.shift(n) -
    1`` in floats (a zero before gives an infinity or NaN). The JAX package
    fills nothing and nulls a zero before (ROADMAP section 3)."""
    v = row_domain(ctx, args[0])
    n_sh = int(opts.get("n", 1))
    acc = torch.float32 if isinstance(v.dtype, dt.Float32) else torch.float64

    def fn(o, vals, valid):
        x = float_values(vals, v.dtype, acc)
        vk = _valid_kept(o, valid)
        fsrc, fok = _ffill_source(o, vk)
        x = x.index_select(0, fsrc)
        src, ok = _source(o, n_sh)
        ok = ok & fok & fok.index_select(0, src)
        prev = x.index_select(0, src)
        return torch.where(ok, x / torch.where(ok, prev, 1.0) - 1.0, 0.0), ok

    return _in_group_space(ctx, v, fn, dt.Float32() if acc == torch.float32 else dt.Float64())


def _seg_scan(x: torch.Tensor, o: GroupOrder, op) -> torch.Tensor:
    """Inclusive scan of ``x`` under ``op`` that restarts at each segment:
    log2(n) doubling steps, each combining a slot with the slot ``step``
    before it where that lies in its segment."""
    n = x.shape[0]
    iota = _iota(n, x.device)
    step = 1
    while step < n:
        ok = (iota[step:] - step) >= o.start[step:]
        nxt = x.clone()
        nxt[step:] = torch.where(ok, op(x[step:], x[:-step]), x[step:])
        x, step = nxt, step * 2
    return x


def _cum_sum_dtype(dts, opts):
    d = dts[0]
    if isinstance(d, dt.Boolean):
        return dt.UInt32()
    if type(d).__name__ in ("Int8", "Int16", "UInt8", "UInt16"):
        return dt.Int64()
    return d


def _extreme(dtype: torch.dtype, big: bool):
    if dtype.is_floating_point:
        return float("inf") if big else float("-inf")
    return torch.iinfo(dtype).max if big else torch.iinfo(dtype).min


def _cum(kind: str, dtype_rule):
    @register(f"cum_{kind}", dtype_rule, elementwise=False)
    def _(ctx, args, opts):
        v = row_domain(ctx, args[0])
        reverse = bool(opts.get("reverse", False))
        out_dt = dtype_rule([v.dtype], opts)
        if v.table is not None:
            raise InvalidOperationError(f"cum_{kind} of {v.dtype!r}")

        def fn(o, vals, valid):
            vk = _valid_kept(o, valid)
            out_valid = None if valid is None or kind == "count" else vk
            if reverse:  # the scans run over the slots reversed, segments and all
                vals, vk = torch.flip(vals, [0]), torch.flip(vk, [0])
                seg = torch.flip(o.seg, [0])
                o = GroupOrder(o.perm, seg, *_bounds(seg), vk)
            if kind == "count":
                cs = torch.cumsum(vk, 0)
                out = cs - (cs - vk.to(cs.dtype)).index_select(0, o.start) if vals.shape[0] else cs
            else:
                out = _scan_values(kind, vals, vk, v.dtype, out_dt, o)
            return (torch.flip(out, [0]) if reverse else out), out_valid

        return _in_group_space(ctx, v, fn, out_dt)


def _scan_values(kind: str, vals: torch.Tensor, vk: torch.Tensor, in_dt, out_dt, o: GroupOrder) -> torch.Tensor:
    """The segmented running sum, product, min or max of the valid slots
    (an invalid slot adds the identity). Integer sums are one ``cumsum``
    minus its value before each segment (exact, wrapping); the others
    double."""
    if kind in ("sum", "prod"):
        work = torch.float64 if out_dt.is_float() and not isinstance(out_dt, dt.Float32) else \
            dt.dtype_to_torch(out_dt)
        x = float_values(vals, in_dt, work) if work.is_floating_point else vals.to(work)
        if kind == "sum" and not work.is_floating_point:
            x = torch.where(vk, x, _zero(x))
            cs = torch.cumsum(x, 0)
            out = cs - (cs - x).index_select(0, o.start) if x.shape[0] else cs
        else:
            ident = 0 if kind == "sum" else 1
            x = torch.where(vk, x, torch.full((), ident, dtype=x.dtype, device=x.device))
            out = _seg_scan(x, o, torch.add if kind == "sum" else torch.mul)
        return wrap_unsigned(out.to(dt.dtype_to_torch(out_dt)), out_dt)
    x = order_word(vals.to(torch.int16) if vals.dtype == torch.bool else vals, in_dt)
    big = kind == "min"
    x = torch.where(vk, x, torch.full((), _extreme(x.dtype, big), dtype=x.dtype, device=x.device))
    # a NaN carries on from where it appears, as the JAX package's minimum
    # and maximum do
    out = order_word(_seg_scan(x, o, torch.minimum if kind == "min" else torch.maximum), in_dt)
    return out.to(torch.bool) if vals.dtype == torch.bool else out


_cum("sum", _cum_sum_dtype)
_cum("prod", lambda dts, opts: dt.Int64() if dts[0].is_integer() else dts[0])
_cum("min", SAME)
_cum("max", SAME)
_cum("count", lambda dts, opts: dt.UInt32())


@register("reverse", SAME, elementwise=False)
def _reverse(ctx, args, opts):
    v = row_domain(ctx, args[0])

    def fn(o, vals, valid):
        src = o.start + o.end - _iota(o.n, vals.device)
        return vals.index_select(0, src), None if valid is None else valid.index_select(0, src)

    return _in_group_space(ctx, v, fn, moves=True)


def _fill(ctx, v: Val, limit, forward: bool) -> Val:
    if v.validity is None:
        return v

    def fn(o, vals, valid):
        vk = _valid_kept(o, valid)
        src, ok = (_ffill_source if forward else _bfill_source)(o, vk)
        if limit is not None:
            gap = _iota(o.n, vals.device) - src if forward else src - _iota(o.n, vals.device)
            ok = ok & (gap <= int(limit))
        return torch.where(ok, vals.index_select(0, src), _zero(vals)), ok

    return _in_group_space(ctx, v, fn, moves=True)


@register("forward_fill", SAME, elementwise=False)
def _forward_fill(ctx, args, opts):
    return _fill(ctx, row_domain(ctx, args[0]), opts.get("limit"), True)


@register("backward_fill", SAME, elementwise=False)
def _backward_fill(ctx, args, opts):
    return _fill(ctx, row_domain(ctx, args[0]), opts.get("limit"), False)


def _interpolate_dt(dts, opts):
    # linear of an integer gives Float64; nearest keeps the type (reference:
    # Expr.interpolate return types)
    d = dts[0]
    if opts.get("method", "linear") == "linear" and d.is_integer():
        return dt.Float64()
    return d


@register("interpolate", _interpolate_dt, elementwise=False)
def _interpolate(ctx, args, opts):
    v = row_domain(ctx, args[0])
    method = opts.get("method", "linear")
    out_dt = _interpolate_dt([v.dtype], opts)
    if not v.dtype.is_numeric():
        return v
    if v.validity is None:
        return cast_val(v, out_dt)

    def fn(o, vals, valid):
        vk = _valid_kept(o, valid)
        p, has_prev = _ffill_source(o, vk)
        q, has_next = _bfill_source(o, vk)
        iota = _iota(o.n, vals.device)
        frac = (iota - p).to(torch.float64) / (q - p).clamp(min=1).to(torch.float64)
        if method == "nearest":
            out = torch.where(vk, vals, torch.where(frac < 0.5, vals.index_select(0, p), vals.index_select(0, q)))
        else:  # in f64, then in the output's type
            x = float_values(vals, v.dtype, torch.float64)
            x0, x1 = x.index_select(0, p), x.index_select(0, q)
            out = torch.where(vk, x, x0 + (x1 - x0) * frac).to(dt.dtype_to_torch(out_dt))
        return out, vk | (has_prev & has_next)

    return _in_group_space(ctx, v, fn, out_dt)


# -- orderings ---------------------------------------------------------------------------


def value_words(v: Val, descending: bool = False, nulls_last: bool = False) -> list[torch.Tensor]:
    """(null rank, *order words) of one key, nulls first unless
    ``nulls_last``; the words under a null are zeroed, so that nulls tie.
    Without nulls there is no rank word."""
    from polars_tpu_torch.engine.sort import sort_words_for_key

    words = sort_words_for_key(v, descending, nulls_last, None)
    if v.validity is None:
        return words
    return [words[0], *(torch.where(v.validity, w, _zero(w)) for w in words[1:])]


def sort_in_groups(ctx, keys: list[tuple[Val, bool, bool]], tie: torch.Tensor | None = None):
    """(group order, the stable permutation of group space that sorts each
    segment by ``keys`` (value, descending, nulls last), the words in group
    space). Slots stay in their segments, so each segment's start and end
    hold in both orders."""
    o = group_order(ctx)
    words = [o.seg]
    for k, desc, nl in keys:
        words.extend(o.to_group(w) for w in value_words(k, desc, nl))
    if tie is not None:
        words.append(o.to_group(tie))
    return o, A.stable_argsort_words(words) if o.n else o.perm, words


@register("rank", lambda dts, opts: dt.Float64() if opts.get("method", "average") == "average" else dt.UInt32(),
          elementwise=False)
def _rank(ctx, args, opts):
    """Ranks within each segment, nulls left null (they sort after every
    value of their segment, so they take no rank from it)."""
    v = row_domain(ctx, args[0])
    method = opts.get("method", "average")
    descending = bool(opts.get("descending", False))
    tie = None
    if method == "random":
        # the JAX package's seeded hash of the row position breaks ties
        seed = opts.get("seed")
        seed = 0 if seed is None else int(seed)
        h = ((_iota(ctx.rows, v.values.device) + (seed * 2654435761 & 0xFFFFFFFF)) * 2654435761) & 0xFFFFFFFF
        h = h ^ (h >> 16)
        h = (h * 0x45D9F3B) & 0xFFFFFFFF
        h = h ^ (h >> 16)
        tie = torch.where(h >= 2**31, h - 2**32, h)
        method = "ordinal"
    o, perm2, words = sort_in_groups(ctx, [(v, descending, True)], tie)
    n = o.n
    iota = _iota(n, v.values.device)
    pos = iota - o.start + 1  # 1-based in the segment, in sorted order
    if method == "ordinal":
        rank_sorted = pos
    else:
        newval = boundaries_from_words(words, perm2) if n else iota.bool()
        last = torch.ones_like(newval)
        last[:-1] = newval[1:]
        run_start, run_end = marked_neighbours(newval)[0], marked_neighbours(last)[1]
        if method == "min":
            rank_sorted = run_start - o.start + 1
        elif method == "max":
            rank_sorted = run_end - o.start + 1
        elif method == "dense":
            d = torch.cumsum(newval, 0)
            rank_sorted = d - d.index_select(0, o.start) + 1 if n else d
        else:
            rank_sorted = (run_start + run_end - 2 * o.start + 2).to(torch.float64) * 0.5
    out_g = torch.empty_like(rank_sorted).index_copy_(0, perm2, rank_sorted)
    out_dt = dt.Float64() if method == "average" and tie is None else dt.UInt32()
    return Val(o.to_rows(out_g), v.validity, out_dt, None, ROW)


@register("arg_sort", dt.UInt32(), elementwise=False)
def _arg_sort(ctx, args, opts):
    """The positions, within each segment, that sort it. Outside a window
    they count the kept rows only (the JAX package gives positions among
    the padded rows, ROADMAP section 3)."""
    v = row_domain(ctx, args[0])
    o, perm2, _ = sort_in_groups(ctx, [(v, bool(opts.get("descending", False)),
                                        bool(opts.get("nulls_last", False)))])
    return Val(o.to_rows(perm2 - o.start), None, dt.UInt32(), None, ROW)


@register("arg_sort_by", dt.UInt32(), elementwise=False)
def _arg_sort_by(ctx, args, opts):
    """Positions that sort each segment by several keys, nulls first
    (reference: pl.arg_sort_by, polars-ops arg_sort_multiple)."""
    keys = [row_domain(ctx, a) for a in args]
    desc = opts.get("descending", (False,) * len(keys))
    desc = (desc,) * len(keys) if isinstance(desc, bool) else tuple(desc)
    o, perm2, _ = sort_in_groups(ctx, [(k, d, False) for k, d in zip(keys, desc)])
    return Val(o.to_rows(perm2 - o.start), None, dt.UInt32(), None, ROW)


@register("row_position", dt.UInt32(), elementwise=False)
def _row_position(ctx, args, opts):
    """Each row's position within its segment (``arg_unique`` keeps those
    of the first distinct values)."""
    row_domain(ctx, args[0])
    o = group_order(ctx)
    return Val(o.to_rows(_iota(o.n, o.perm.device) - o.start), None, dt.UInt32(), None, ROW)


def reorder_in_groups(ctx, v: Val, keys: list[tuple[Val, bool, bool]]) -> Val:
    """``v``'s values sorted within each segment by ``keys``: the k-th row
    of a segment takes the segment's k-th value in key order (the
    expression-level ``sort`` and ``sort_by``)."""
    v = row_domain(ctx, v)
    o, perm2, _ = sort_in_groups(ctx, keys)
    src = o.perm.index_select(0, perm2)
    values = o.to_rows(v.values.index_select(0, src))
    validity = None if v.validity is None else o.to_rows(v.validity.index_select(0, src))
    return v.with_(values=values, validity=validity, domain=ROW)


# -- fill strategies and peaks --------------------------------------------------------


@register("fill_null_with_strategy", SAME, elementwise=False)
def _fill_null_with_strategy(ctx, args, opts):
    v = args[0]
    strategy = opts.get("strategy")
    if v.validity is None:
        return v
    if strategy in ("forward", "backward"):
        return _fill(ctx, row_domain(ctx, v), opts.get("limit"), strategy == "forward")
    if v.dtype.is_nested():
        raise InvalidOperationError(f"fill_null(strategy={strategy!r}) is not defined for {v.dtype!r}")
    if strategy in ("zero", "one"):
        fill = torch.full((), 1 if strategy == "one" else 0, dtype=v.values.dtype, device=v.values.device)
        return Val(torch.where(v.validity, v.values, fill), None, v.dtype, v.table, v.domain)
    # min, max, mean: each group's (outside a group, all kept rows') value;
    # a group without one keeps its nulls
    from polars_tpu_torch.engine.compiler import group_of

    v = row_domain(ctx, v)
    if v.table is not None:
        if strategy == "mean":
            raise InvalidOperationError(f"fill_null(strategy='mean') is not defined for {v.dtype!r}")
        v = ensure_ordinal_val(v)  # the text's order
    g = group_of(ctx)
    mask = ctx.rowmask & v.validity
    if strategy == "mean":  # an integer mean truncates into the column's type
        m, has = G.seg_mean(float_values(v.values, v.dtype, torch.float64), mask, g.gids, g.capacity)
        fill = m.to(v.values.dtype)
    else:
        fill = G.seg_extreme(strategy, v, mask, g.gids, g.capacity)
        has = G.seg_count(mask, g.gids, g.capacity) > 0
    ids = g.gids.clamp(0, g.capacity - 1).long()
    return Val(torch.where(v.validity, v.values, fill.index_select(0, ids)), v.validity | has.index_select(0, ids),
               v.dtype, v.table, ROW)


def _peak(ctx, v: Val, is_max: bool) -> Val:
    """Reference peak semantics (polars-ops/src/chunked_array/peaks.rs):
    each value against its neighbours in the segment, where a missing
    neighbour is the literal 0, null comparisons combined by Kleene AND."""

    def fn(o, vals, valid):
        n = o.n
        iota = _iota(n, vals.device)
        has_prev = iota - 1 >= o.start
        has_next = iota + 1 <= o.end
        pi, ni = (iota - 1).clamp(0, max(n - 1, 0)), (iota + 1).clamp(0, max(n - 1, 0))
        x = order_word(vals.to(torch.int8) if vals.dtype == torch.bool else vals, v.dtype)
        pv = torch.where(has_prev, x.index_select(0, pi), _zero(x))
        nv = torch.where(has_next, x.index_select(0, ni), _zero(x))
        if valid is None:
            p_ok = n_ok = self_ok = torch.ones(n, dtype=torch.bool, device=vals.device)
        else:
            p_ok = torch.where(has_prev, valid.index_select(0, pi), True)
            n_ok = torch.where(has_next, valid.index_select(0, ni), True)
            self_ok = valid
        lv, rv = (pv < x, nv < x) if is_max else (pv > x, nv > x)
        l_ok, r_ok = p_ok & self_ok, n_ok & self_ok
        out_ok = (l_ok & r_ok) | (l_ok & ~lv) | (r_ok & ~rv)
        return (lv | ~l_ok) & (rv | ~r_ok) & out_ok, out_ok

    return _in_group_space(ctx, v, fn, dt.Boolean())


@register("peak_min", BOOL, elementwise=False)
def _peak_min(ctx, args, opts):
    return _peak(ctx, row_domain(ctx, args[0]), False)


@register("peak_max", BOOL, elementwise=False)
def _peak_max(ctx, args, opts):
    return _peak(ctx, row_domain(ctx, args[0]), True)


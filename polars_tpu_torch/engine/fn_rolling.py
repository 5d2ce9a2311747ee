"""Rolling, exponentially weighted and cumulative windows as expressions (the
port of ``polars_tpu/engine/fn_position.py``'s ``_rolling``, ``_rolling_by``,
``_rolling_order``, ``_lin_scan``, ``_ewm_impl``, ``ewm_sum``,
``_ewm_by_core``, ``interpolate_by`` and ``cumulative_eval``; reference
kernels: polars-compute/src/{rolling,ewm}, polars-time/src/windows).

Row windows, EWMs, ``interpolate_by`` and ``cumulative_eval`` run in the
group space of ``fn_position.group_order``: no window crosses a group of
``over`` or of a group-by, and without either a function sees only the rows
the segment's mask keeps. Time windows (``rolling_*_by``, ``ewm_*_by``) sort
the rows by (group, time) once per context (``rolling.TimeOrder``). The
window arithmetic is ``engine/rolling.py``'s. The median, quantile and rank
over time windows are host functions (``engine/hostops.py``), as in the JAX
package. Nothing here reads the device.
"""

from __future__ import annotations

import math

import torch

from polars_tpu_torch import datatypes as dt
from polars_tpu_torch.engine import rolling as R
from polars_tpu_torch.engine.cast import float_values
from polars_tpu_torch.engine.common import ROW, Val
from polars_tpu_torch.engine.fn_position import (
    _cum_sum_dtype, _in_group_space, _iota, _scan_values, _valid_kept, marked_neighbours, row_domain,
    sort_in_groups,
)
from polars_tpu_torch.engine.registry import FLOAT, SAME, raises, register
from polars_tpu_torch.errors import InvalidOperationError
from polars_tpu_torch.plan.exprs import cum_eval_kind

_F64 = torch.float64


def _storage(values: torch.Tensor, out_dt: dt.DataType) -> torch.Tensor:
    return values.to(dt.dtype_to_torch(out_dt))


def _check_weights(ctx, v: Val, kind: str, w: int, wts) -> None:
    if len(wts) != w:
        raise InvalidOperationError(f"rolling_{kind}: weights length {len(wts)} must equal window_size {w}")
    if v.validity is not None:  # the reference panics on its nulls path
        ctx.add_flag((ctx.rowmask & ~v.validity).any(),
                     f"rolling_{kind}: weights are not supported on columns with null values")


# -- row windows ------------------------------------------------------------------------------


def _rolling_dt(kind: str):
    def rule(dts, opts):
        if kind in ("sum", "min", "max") and opts.get("weights") is None:
            return dts[0]
        if kind == "rank":
            return dt.Float64()
        return FLOAT(dts, opts)

    return rule


def _weighted(kind: str, o, x: torch.Tensor, ok: torch.Tensor, wts, center: bool):
    """(the weighted ``kind`` of each slot's window, its count): a pass per
    offset, each weight with its offset (a window cut by its segment's start
    uses the weights' tail). The variance is the weighted mean of squared
    deviations from the weighted mean (the reference's single pass, whose
    ddof it ignores, in two)."""
    shifts = R.row_shifts(len(wts), center)
    cnt = torch.zeros(o.n, dtype=torch.int64, device=x.device)
    s = torch.zeros(o.n, dtype=_F64, device=x.device)
    wsum = torch.zeros_like(s)
    ext = torch.full_like(s, math.inf if kind == "min" else -math.inf)
    for wi, sh in zip(wts, shifts):
        xv, m = R.shifted(o, x, ok, sh)
        cnt += m
        if kind in ("min", "max"):
            op = torch.minimum if kind == "min" else torch.maximum
            ext = torch.where(m, op(ext, xv * float(wi)), ext)
        else:
            s += torch.where(m, xv * float(wi), 0.0)
            wsum += m.to(_F64) * float(wi)
    if kind in ("min", "max"):
        return ext, cnt
    if kind == "sum":
        return s, cnt
    mean = s / torch.where(wsum == 0.0, 1.0, wsum)
    if kind == "mean":
        return mean, cnt
    if kind not in ("var", "std"):
        raise InvalidOperationError(f"rolling_{kind} does not support weights")
    sq = torch.zeros_like(s)
    for wi, sh in zip(wts, shifts):
        xv, m = R.shifted(o, x, ok, sh)
        sq += torch.where(m, float(wi) * (xv - mean) ** 2, 0.0)
    var = sq / torch.where(wsum == 0.0, 1.0, wsum)
    return (var.sqrt() if kind == "std" else var), cnt


def _shape_moments(kind: str, o, x: torch.Tensor, ok: torch.Tensor, w: int, center: bool, opts):
    """Skewness or kurtosis of each slot's window: the mean from prefix
    sums, then the central moments in a pass per offset."""
    lo, hi = R.row_bounds(o, w, center)
    mean, cnt, _ = R.SlotColumn(x, ok, o.start, dt.Float64()).agg("mean", lo, hi)
    m2, mk = torch.zeros_like(mean), torch.zeros_like(mean)
    p = 3 if kind == "skew" else 4
    for sh in R.row_shifts(w, center):
        xv, m = R.shifted(o, x, ok, sh)
        d = torch.where(m, xv - mean, 0.0)
        m2 += d * d
        mk += d**p
    c = cnt.clamp(min=1).to(_F64)
    m2, mk = m2 / c, mk / c
    bias = bool(opts.get("bias", True))
    if kind == "skew":
        out = mk / m2.clamp(min=1e-300) ** 1.5
        if not bias:
            out = out * torch.sqrt(c * (c - 1)) / (c - 2).clamp(min=1)
        return out, cnt
    out = mk / m2.clamp(min=1e-300) ** 2
    if not bias:  # scipy.stats.kurtosis(bias=False)
        out = ((c * c - 1) * out - 3 * (c - 1) ** 2) / ((c - 2) * (c - 3)).clamp(min=1) + 3
    return (out - 3.0 if opts.get("fisher", True) else out), cnt


def _rolling(kind: str):
    rule = _rolling_dt(kind)

    @register(f"rolling_{kind}", rule, elementwise=False)
    def _(ctx, args, opts):
        v = row_domain(ctx, args[0])
        if v.table is not None:
            raise InvalidOperationError(f"rolling_{kind} of {v.dtype!r}")
        w = int(opts["window_size"])
        minp = opts.get("min_samples") or w
        center = bool(opts.get("center", False))
        wts = opts.get("weights")
        if wts is not None:
            _check_weights(ctx, v, kind, w, wts)
        out_dt = rule([v.dtype], opts)

        def fn(o, vals, valid):
            ok = _valid_kept(o, valid)
            extra = None
            if wts is not None:
                out, cnt = _weighted(kind, o, float_values(vals, v.dtype, _F64), ok, wts, center)
            elif kind in ("skew", "kurtosis"):
                out, cnt = _shape_moments(kind, o, float_values(vals, v.dtype, _F64), ok, w, center, opts)
            else:
                lo, hi = R.row_bounds(o, w, center)
                out, cnt, extra = R.SlotColumn(vals, ok, o.start, v.dtype).agg(
                    kind, lo, hi, ddof=int(opts.get("ddof", 1)), max_width=w)
            out_ok = cnt >= minp
            return _storage(out, out_dt), out_ok if extra is None else out_ok & extra

        return _in_group_space(ctx, v, fn, out_dt)


for _k in ("sum", "mean", "min", "max", "std", "var", "skew", "kurtosis"):
    _rolling(_k)


def _weighted_quantile(sv: torch.Tensor, sw: torch.Tensor, wsum: torch.Tensor, q: float, method: str):
    """Reference ``compute_wq`` (polars-compute no_nulls/quantile.rs,
    StatsBase's definition) over windows sorted along dim 0: the cumulative
    weight walked to ``h = q * (wsum - w_first) + w_first``. ``wsum`` is each
    window's own weight total (the JAX package takes every weight's, so a
    window cut by its segment's start comes out NaN, ROADMAP section 3)."""
    w, m = sv.shape
    cols = torch.arange(m, device=sv.device)
    S = torch.cumsum(sw, 0)
    h = q * (wsum - sw[0]) + sw[0]
    over = S > h[None, :]
    K = torch.where(over.any(0), over.to(torch.int8).argmax(0), w - 1)
    vk = sv[K, cols]
    km1 = (K - 1).clamp(min=0)
    v_old = torch.where(K > 0, sv[km1, cols], 0.0)
    s_old = torch.where(K > 0, S[km1, cols], 0.0)
    s = S[K, cols]
    if method == "lower":
        out = v_old
    elif method == "higher":
        out = vk
    elif method == "midpoint":
        out = (vk + v_old) * 0.5
    elif method == "linear":
        denom = s - s_old
        out = v_old + torch.where(denom > 0, (h - s_old) / torch.where(denom > 0, denom, 1.0), 0.0) * (vk - v_old)
    elif method == "equiprobable":
        out = torch.where(s > torch.ceil(wsum * q) - 1.0, vk, v_old)
    else:  # nearest
        out = torch.where((s - h) > (h - s_old), v_old, vk)
    return torch.where(h == s_old, v_old, out)


def _order_windows(kind: str, opts, o, x: torch.Tensor, ok: torch.Tensor, w: int, center: bool) -> torch.Tensor:
    """Median, quantile or rank of each slot's window, from its values
    sorted (``rolling.stacked_windows``: a block of slots at a time)."""
    wts = opts.get("weights")
    q = 0.5 if kind == "median" else float(opts.get("quantile", 0.5))
    interp = opts.get("interpolation", "nearest")
    method = opts.get("method", "average")
    desc = bool(opts.get("descending", False))
    me = (w - 1) - ((w - 1) // 2 if center else 0)  # the slot's own row in the stack

    def fn(vs, mm, slots):
        cnt = mm.sum(0)
        masked = torch.where(mm, vs, math.inf)
        m = vs.shape[1]
        cols = torch.arange(m, device=vs.device)
        if kind in ("median", "quantile") and wts is not None:
            wfull = torch.where(mm, torch.tensor([float(a) for a in wts], dtype=_F64, device=vs.device)[:, None], 0.0)
            order = torch.sort(masked, dim=0, stable=True).indices
            sw = torch.gather(wfull, 0, order)
            return _weighted_quantile(torch.gather(masked, 0, order), sw, sw.sum(0), q,
                                      "linear" if kind == "median" else interp)
        if kind in ("median", "quantile"):
            sv = torch.sort(masked, dim=0).values

            def at(i):
                return sv[i.clamp(0, w - 1), cols]

            if kind == "median":
                return (at((cnt - 1).clamp(min=0) // 2) + at(cnt // 2)) * 0.5
            posf = q * (cnt - 1).clamp(min=0).to(_F64)
            lo, hi = at(posf.floor().long()), at(posf.ceil().long())
            if interp == "linear":
                return lo + (posf - posf.floor()) * (hi - lo)
            if interp in ("lower", "higher", "midpoint"):
                return {"lower": lo, "higher": hi, "midpoint": (lo + hi) * 0.5}[interp]
            return at(torch.round(posf).long())
        cur = x.index_select(0, slots)[None, :]
        below = (vs > cur) if desc else (vs < cur)
        less = (mm & below).sum(0).to(_F64)
        eq = (mm & (vs == cur)).sum(0).to(_F64)
        if method == "average":
            return less + (eq + 1.0) * 0.5
        if method == "min":
            return less + 1.0
        if method == "max":
            return less + eq
        if method == "ordinal":
            return less + (mm[:me] & (vs[:me] == cur)).sum(0).to(_F64) + 1.0
        if method == "dense":
            order = torch.sort(masked, dim=0).indices
            sv, sm = torch.gather(masked, 0, order), torch.gather(mm, 0, order)
            head = torch.ones_like(sm)
            head[1:] = sv[1:] != sv[:-1]
            sbelow = (sv > cur) if desc else (sv < cur)
            return (head & sbelow & sm).sum(0).to(_F64) + 1.0
        raise InvalidOperationError(f"rolling_rank method {method!r} is not supported")

    return R.stacked_windows(o, x, ok, w, center, fn)


def _rolling_order(kind: str):
    rule = _rolling_dt(kind)

    @register(f"rolling_{kind}", rule, elementwise=False)
    def _(ctx, args, opts):
        v = row_domain(ctx, args[0])
        w = int(opts["window_size"])
        minp = opts.get("min_samples") or w
        center = bool(opts.get("center", False))
        wts = opts.get("weights")
        if kind == "rank" and opts.get("method", "average") not in ("average", "min", "max", "ordinal", "dense"):
            raise InvalidOperationError(f"rolling_rank method {opts.get('method')!r} is not supported")
        if wts is not None:
            if kind == "rank":
                raise InvalidOperationError("rolling_rank does not support weights")
            _check_weights(ctx, v, kind, w, wts)
            if sum(float(a) for a in wts) == 0.0:
                raise InvalidOperationError("Weighted quantile is undefined if weights sum to 0")
        out_dt = rule([v.dtype], opts)

        def fn(o, vals, valid):
            ok = _valid_kept(o, valid)
            x = float_values(vals, v.dtype, _F64)
            out = _order_windows(kind, opts, o, x, ok, w, center)
            lo, hi = R.row_bounds(o, w, center)
            cnt = R.SlotColumn(vals, ok, o.start, v.dtype).agg("count", lo, hi)[0]
            return _storage(out, out_dt), cnt >= minp

        return _in_group_space(ctx, v, fn, out_dt)


for _k in ("median", "quantile", "rank"):
    _rolling_order(_k)


# -- time windows ----------------------------------------------------------------------------


def _time_order(ctx, b: Val, valid: torch.Tensor, name: str) -> R.TimeOrder:
    """The rows ``valid`` marks sorted by (group, ``b``). With groups the
    composite key's stride is the index's span, on the device: an overflow
    fails the segment at its count read."""
    if ctx.groups is None:
        return R.TimeOrder(b.values, valid, None, None)
    stride = R.group_stride(b.values, valid)
    ctx.add_flag(stride > R.KEY_LIMIT // max(ctx.groups.capacity, 1),
                 f"{name} over groups: time span times group count exceeds the composite key range")
    return R.TimeOrder(b.values, valid, ctx.groups.gids, stride)


def by_order(ctx, b: Val, name: str) -> R.TimeOrder:
    """:func:`_time_order` of the kept rows with an index (``order.valid``),
    made once per context and index, so that the windows over one index
    share their sort."""
    if ctx.time_orders is None:
        ctx.time_orders = []
    gid = None if ctx.groups is None else ctx.groups.gids
    for (bv, bm, rm, gg), order in ctx.time_orders:
        if bv is b.values and bm is b.validity and rm is ctx.rowmask and gg is gid:
            return order
    order = _time_order(ctx, b, ctx.rowmask if b.validity is None else ctx.rowmask & b.validity, name)
    ctx.time_orders.append(((b.values, b.validity, ctx.rowmask, gid), order))
    return order


def _index(b: Val, name: str) -> None:
    if not (b.dtype.is_temporal() or b.dtype.is_integer()):
        raise InvalidOperationError(f"{name} needs a temporal/integer 'by' column, got {b.dtype}")


def _rolling_by_dt(kind: str):
    def rule(dts, opts):
        if kind == "count":
            return dt.UInt32()
        if kind in ("sum", "min", "max", "first", "last"):
            return dts[0]
        return FLOAT(dts, opts)

    return rule


def _rolling_by(kind: str):
    rule = _rolling_by_dt(kind)

    @register(f"rolling_{kind}_by", rule, elementwise=False)
    def _(ctx, args, opts):
        v, b = row_domain(ctx, args[0]), row_domain(ctx, args[1])
        name = f"rolling_{kind}_by"
        _index(b, name)
        ticks = R.interval_ticks(opts["window_size"], b.dtype)
        order = by_order(ctx, b, name)
        lo, hi = order.bounds(ticks, -ticks, opts.get("closed") or "right")
        out, cnt, extra = order.column(v.values, v.validity, v.dtype).agg(
            kind, lo, hi, ddof=int(opts.get("ddof", 1)), max_width=order.n)
        ok = (cnt >= max(int(opts.get("min_samples") or 1), 1)) & order.valid
        out_dt = rule([v.dtype], opts)
        return Val(_storage(out, out_dt), ok if extra is None else ok & extra, out_dt,
                   v.table if kind in ("min", "max", "first", "last") else None, ROW)


for _k in ("sum", "mean", "min", "max", "std", "var", "count", "first", "last"):
    _rolling_by(_k)


register("rolling_median_by", lambda dts, opts: dt.Float64(), elementwise=False)(
    raises("rolling_median_by runs on the host (engine/hostops.py)"))
register("rolling_map", SAME, elementwise=False)(
    raises("rolling_map runs on the host (engine/hostops.py)"))
register("rolling_quantile_by", lambda dts, opts: dt.Float64(), elementwise=False)(
    raises("rolling_quantile_by runs on the host (engine/hostops.py)"))
register("rolling_rank_by", lambda dts, opts: dt.Float64() if opts.get("method", "average") == "average"
         else dt.UInt32(), elementwise=False)(raises("rolling_rank_by runs on the host (engine/hostops.py)"))


# -- exponentially weighted windows ---------------------------------------------------------------


_SCAN_BLOCK = 1024


def _doubling(y: torch.Tensor, f: torch.Tensor) -> None:
    """Doubling steps along the last dimension, in place: each slot's
    (factor, bias) composed with the pair ``step`` slots before it; a zero
    factor keeps its bias alone, so a NaN before a segment cannot leak into
    it (0 * NaN)."""
    n, step = y.shape[-1], 1
    while step < n:
        fs = f[..., step:]
        ny = torch.where(fs == 0.0, y[..., step:], y[..., step:] + fs * y[..., :-step])
        nf = fs * f[..., :-step]
        y[..., step:], f[..., step:] = ny, nf
        step *= 2


def lin_scan(bias: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """The inclusive scan ``y[i] = bias[i] + factor[i] * y[i-1]`` (a zero
    factor cuts the history before it: a segment's start), in two levels:
    doubling steps within blocks of 1,024 slots, the same scan over the
    blocks' ends (one slot per block), then each slot takes its block's
    carry times its composed factor. log2(1024) full-length steps instead
    of log2(n)."""
    n = bias.shape[0]
    if n <= _SCAN_BLOCK:
        y, f = bias.clone(), factor.clone()
        _doubling(y, f)
        return y
    pad = -n % _SCAN_BLOCK
    y = torch.cat([bias, bias.new_zeros(pad)]).view(-1, _SCAN_BLOCK)
    f = torch.cat([factor, factor.new_ones(pad)]).view(-1, _SCAN_BLOCK)
    _doubling(y, f)
    carry = lin_scan(y[:, -1].contiguous(), f[:, -1].contiguous())  # each block's end, all history included
    prev = torch.cat([carry.new_zeros(1), carry[:-1]])[:, None]
    y = torch.where(f == 0.0, y, y + f * prev)
    return y.reshape(-1)[:n]


def ewm_alpha(opts, fname: str) -> float:
    com, span, half_life, alpha = opts.get("com"), opts.get("span"), opts.get("half_life"), opts.get("alpha")
    if alpha is not None:
        return float(alpha)
    if com is not None:
        return 1.0 / (1.0 + com)
    if span is not None:
        return 2.0 / (span + 1.0)
    if half_life is not None:
        return 1.0 - 2.0 ** (-1.0 / half_life)
    raise InvalidOperationError(f"{fname} requires com/span/half_life/alpha")


def _seg_count(o, marks: torch.Tensor) -> torch.Tensor:
    """The running count of ``marks`` within each slot's segment."""
    cs = torch.cumsum(marks, 0)
    return cs - (cs - marks.to(cs.dtype)).index_select(0, o.start) if o.n else cs


def _ewm(ctx, v: Val, opts, want: str) -> Val:
    """EWM mean and variance as the reference's exact state recurrences
    (polars-compute/src/ewm/{mean,cov}.rs), each update ``y' = f * y + b``
    with coefficients of its position, so that each state variable is one
    :func:`lin_scan` (the weights never divided by (1 - alpha)^n, which
    overflows over long groups). For ``adjust=False`` the weight restarts at
    1 and the weight sums renormalize by the new weight at each valid step."""
    a = ewm_alpha(opts, f"ewm_{want}")
    adjust = bool(opts.get("adjust", True))
    bias = bool(opts.get("bias", False))
    ignore_nulls = bool(opts.get("ignore_nulls", False))
    minp = max(int(opts.get("min_samples", 1) or 1), 1)
    ow = 1.0 if adjust else a

    def fn(o, vals, valid):
        x = float_values(vals, v.dtype, _F64)
        vk = _valid_kept(o, valid)
        bnd = _iota(o.n, x.device) == o.start
        cnt = _seg_count(o, vk)
        first = vk & (cnt == 1)
        upd = vk & ~first
        # a slot decays the weights where it holds a value, or, unless
        # ignore_nulls, wherever it is kept; never at the first value
        dec = 1.0 - a * ((vk if ignore_nulls else o.kept) & ~first).to(_F64)
        xc = torch.where(vk, x, 0.0)

        def scan(b, f):
            return lin_scan(b, torch.where(bnd, 0.0, f))

        if adjust:
            w_acc = scan(first.to(_F64) + ow * upd.to(_F64), dec)
        else:
            w_acc = scan(vk.to(_F64), torch.where(vk, 0.0, dec))
        w_prev = torch.where(bnd, 0.0, torch.roll(w_acc, 1))
        w_pre = torch.where(upd, w_prev * (1.0 - a), 0.0)
        nw = w_pre + ow
        c = torch.where(first, 1.0, torch.where(vk, ow / nw, 0.0))
        mean = scan(torch.where(vk, c * xc, 0.0), torch.where(vk, 1.0 - c, 1.0))
        ok = vk & (cnt >= minp)
        if want == "mean":
            return mean, ok
        ff = scan(torch.where(vk, mean, 0.0), (~vk).to(_F64))  # the last valid slot's mean
        delta = xc - torch.where(bnd, 0.0, torch.roll(ff, 1))
        cov_bias = torch.where(upd, (w_pre * c * c + ow * (1.0 - c) ** 2) * delta * delta / nw, 0.0)
        cov_factor = torch.where(first, 0.0, torch.where(upd, w_pre / nw, 1.0))
        out = scan(cov_bias, cov_factor).clamp(min=0.0)
        if not bias:  # weight_sum and weight_square_sum (cov.rs:74-107)
            nwdiv = nw if adjust is False else torch.ones_like(nw)
            nwdiv = torch.where(upd, nwdiv, 1.0)
            W = scan(torch.where(first, 1.0, torch.where(upd, ow / nwdiv, 0.0)),
                     torch.where(first, 0.0, torch.where(upd, dec / nwdiv, dec)))
            W2 = scan(torch.where(first, 1.0, torch.where(upd, ow * ow / (nwdiv * nwdiv), 0.0)),
                      torch.where(first, 0.0, torch.where(upd, dec * dec / (nwdiv * nwdiv), dec * dec)))
            denom = W * W - W2
            out = torch.where(denom > 0.0, W * W / denom.clamp(min=1e-300) * out, 0.0)
            ok = ok & (denom > 0.0)
        return (out.sqrt() if want == "std" else out), ok

    out_dt = FLOAT([v.dtype], opts)
    res = _in_group_space(ctx, v, fn, out_dt)
    return res.with_(values=_storage(res.values, out_dt))


@register("ewm_mean", FLOAT, elementwise=False)
def _ewm_mean(ctx, args, opts):
    return _ewm(ctx, row_domain(ctx, args[0]), opts, "mean")


@register("ewm_var", FLOAT, elementwise=False)
def _ewm_var(ctx, args, opts):
    return _ewm(ctx, row_domain(ctx, args[0]), opts, "var")


@register("ewm_std", FLOAT, elementwise=False)
def _ewm_std(ctx, args, opts):
    return _ewm(ctx, row_domain(ctx, args[0]), opts, "std")


@register("ewm_sum", FLOAT, elementwise=False)
def _ewm_sum(ctx, args, opts):
    """``y = x + (1 - alpha) * y_prev`` per segment, a null decaying the sum
    unless ``ignore_nulls``."""
    v = row_domain(ctx, args[0])
    a = ewm_alpha(opts, "ewm_sum")
    ignore_nulls = bool(opts.get("ignore_nulls", False))
    minp = int(opts.get("min_samples", 1) or 1)

    def fn(o, vals, valid):
        x = float_values(vals, v.dtype, _F64)
        vk = _valid_kept(o, valid)
        bnd = _iota(o.n, x.device) == o.start
        factor = 1.0 - a * (vk if ignore_nulls else o.kept).to(_F64)
        y = lin_scan(torch.where(vk, x, 0.0), torch.where(bnd, 0.0, factor))
        cnt = _seg_count(o, vk)
        ok = (cnt > 0) & (cnt >= minp)
        return y, ok if valid is None else ok & vk

    out_dt = FLOAT([v.dtype], opts)
    res = _in_group_space(ctx, v, fn, out_dt)
    return res.with_(values=_storage(res.values, out_dt))


def _ewm_by(ctx, args, opts, *, normalize: bool) -> Val:
    """EWM over time: ``alpha = 1 - 2^(-dt / half_life)`` between a row and
    the previous one of its group in time order (reference: polars-ops
    ewm_by.rs), one :func:`lin_scan` over the rows sorted by (group, time),
    a group's first row seeding it."""
    v, b = row_domain(ctx, args[0]), row_domain(ctx, args[1])
    name = "ewm_mean_by" if normalize else "ewm_sum_by"
    _index(b, name)
    tau = float(R.interval_ticks(opts["half_life"], b.dtype))
    valid = ctx.rowmask
    for m in (v.validity, b.validity):
        if m is not None:
            valid = valid & m
    order = _time_order(ctx, b, valid, name)
    perm, n = order.perm, order.n
    xs = float_values(v.values, v.dtype, _F64).index_select(0, perm)
    ts = b.values.to(torch.int64).index_select(0, perm)
    vs = valid.index_select(0, perm)
    bnd = _iota(n, xs.device) == order.start
    dtp = torch.zeros(n, dtype=_F64, device=xs.device)
    if n:
        dtp[1:] = (ts[1:] - ts[:-1]).to(_F64)
    alpha = torch.where(bnd, 1.0, 1.0 - torch.exp2(-dtp / tau))
    contrib = torch.where(vs, alpha * xs if normalize else xs, 0.0)
    factor = torch.where(bnd, 0.0, torch.where(vs, 1.0 - alpha, 1.0))
    y = lin_scan(contrib, factor)
    out_dt = FLOAT([v.dtype], opts)
    out = torch.empty_like(y).index_copy_(0, perm, y)
    return Val(_storage(out, out_dt), valid, out_dt, None, ROW)


@register("ewm_mean_by", FLOAT, elementwise=False)
def _ewm_mean_by(ctx, args, opts):
    return _ewm_by(ctx, args, opts, normalize=True)


@register("ewm_sum_by", FLOAT, elementwise=False)
def _ewm_sum_by(ctx, args, opts):
    return _ewm_by(ctx, args, opts, normalize=False)


# -- interpolate_by and cumulative_eval ------------------------------------------------------------


@register("interpolate_by", FLOAT, elementwise=False)
def _interpolate_by(ctx, args, opts):
    """Linear interpolation of the nulls between their neighbours in the
    order of ``by`` within each segment, positioned by ``by`` (reference:
    polars-ops interpolate_by.rs). A row with a null ``by`` is not filled."""
    v, b = row_domain(ctx, args[0]), row_domain(ctx, args[1])
    out_dt = FLOAT([v.dtype], opts)
    o, perm2, _ = sort_in_groups(ctx, [(b, False, True)])
    n = o.n
    src = o.perm.index_select(0, perm2)  # the row at each slot, by sorted within segments
    kept = o.kept.index_select(0, perm2)
    bvalid = kept if b.validity is None else kept & b.validity.index_select(0, src)
    vk = bvalid if v.validity is None else bvalid & v.validity.index_select(0, src)
    x = float_values(v.values, v.dtype, _F64).index_select(0, src)
    t = float_values(b.values, b.dtype, _F64).index_select(0, src)
    p, q = marked_neighbours(vk)
    has = (p >= o.start) & (q <= o.end)
    pc, qc = p.clamp(min=0), q.clamp(max=max(n - 1, 0))
    x0, x1, t0, t1 = x.index_select(0, pc), x.index_select(0, qc), t.index_select(0, pc), t.index_select(0, qc)
    frac = (t - t0) / torch.where(t1 == t0, 1.0, t1 - t0)
    out = torch.where(vk, x, x0 + (x1 - x0) * frac)
    ok = vk | (has & bvalid)
    rows = torch.empty_like(src).index_copy_(0, src, _iota(n, src.device))  # each row's slot
    return Val(_storage(out.index_select(0, rows), out_dt), ok.index_select(0, rows), out_dt, None, ROW)


def _cum_eval_dt(dts, opts):
    kind = cum_eval_kind(opts.get("expr"))
    if kind == "mean":
        return dt.Float64()
    if kind == "sum":
        return _cum_sum_dtype(dts, opts)
    return dts[0]


@register("cumulative_eval", _cum_eval_dt, elementwise=False)
def _cumulative_eval(ctx, args, opts):
    """``x.cumulative_eval(pl.element().sum())`` and the min, max and mean:
    one segmented scan over each prefix (every other inner expression runs on
    the host, ``engine/hostops.py``). A NaN does not count for min and max
    (a prefix of NaN alone gives NaN); ``min_samples`` counts positions."""
    kind = cum_eval_kind(opts.get("expr"))
    if kind is None:
        raise InvalidOperationError("cumulative_eval of this expression runs on the host (engine/hostops.py)")
    v = row_domain(ctx, args[0])
    if v.table is not None or not (v.dtype.is_numeric() or isinstance(v.dtype, dt.Boolean)):
        raise InvalidOperationError(f"cumulative_eval of {v.dtype!r}")
    minp = int(opts.get("min_samples", 1) or 1)
    out_dt = _cum_eval_dt([v.dtype], opts)

    def fn(o, vals, valid):
        vk = _valid_kept(o, valid)
        cnt = _seg_count(o, vk)
        if kind == "sum":
            out, ok = _scan_values("sum", vals, vk, v.dtype, out_dt, o), torch.ones_like(vk)
        elif kind == "mean":
            out = _scan_values("sum", vals, vk, v.dtype, dt.Float64(), o) / cnt.clamp(min=1).to(_F64)
            ok = cnt > 0
        else:
            nan = torch.isnan(vals) if vals.is_floating_point() else torch.zeros_like(vk)
            out = _scan_values(kind, vals, vk & ~nan, v.dtype, out_dt, o)
            if vals.is_floating_point():
                out = torch.where((cnt > 0) & (_seg_count(o, vk & ~nan) == 0), float("nan"), out)
            ok = cnt > 0
        if minp > 1:
            ok = ok & (_iota(o.n, vk.device) - o.start + 1 >= minp)
        return _storage(out, out_dt), ok

    return _in_group_space(ctx, v, fn, out_dt)

"""List, Array and Struct values in a segment (the port of
``polars_tpu/engine/fn_nested.py`` and of the eager list operations of
``polars_tpu/ops/list_ops.py``: the registry specs of the ``list.``,
``arr.`` and ``struct.`` functions, ``concat_list``, ``as_struct``, and the
helpers that explode and implode).

A List or Array value holds int64 ``(start << 32) | length`` words into its
flat child (``Val.child``); rows may share a range of the child (a gather,
or ``str.split`` over a dictionary). A function over the lists works in
*element space*: :func:`elements` lists every element of every valid row,
grouped by its row in row order (one host read for their count, then a
``repeat_interleave`` on the device; made once per value and context).
A reduction per list runs the group-by's segmented reductions with the
owning row as the group id at capacity = rows (kernel K1 for sums and
counts: each list reduces as a segment of its own, where the JAX package
takes differences of prefix sums over the whole child, which cancel). A
function that keeps some elements compacts them with kernel K2 and counts
them per row with K1; a sort, ``unique`` or a set operation sorts
(row, value) words. The result is a new child in row order.

The Series namespaces run through these same functions over a one-column
frame (``core/series_ns.py``), so the eager and the lazy path share them;
the JAX package's ``ops/list_ops.py`` has no separate counterpart here.

A Struct value holds row ids into its field values (``Val.child``, one Val
per field); a gather or a filter moves the ids only.
"""

from __future__ import annotations

import dataclasses

import torch

from polars_tpu_torch import datatypes as dt
from polars_tpu_torch.engine import groupby as G
from polars_tpu_torch.engine.common import GROUP, ROW, SCALAR, EvalCtx, GroupCtx, Val, combine_validity
from polars_tpu_torch.engine.registry import raises, register
from polars_tpu_torch.errors import ComputeError, InvalidOperationError, SchemaError, ShapeError
from polars_tpu_torch.kernels.argsort import boundaries_from_words, stable_argsort_words
from polars_tpu_torch.kernels.compact import compact_count, compact_scatter

LEN_MASK = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# layout
# ---------------------------------------------------------------------------


def unpack(values: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(starts, lengths) of packed words, int64."""
    v = values.to(torch.int64)
    return v >> 32, v & LEN_MASK


def pack(starts: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    return (starts.to(torch.int64) << 32) | lens.to(torch.int64)


def _iota(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int64, device=device)


def gather_val(v: Val, idx: torch.Tensor, valid: torch.Tensor | None = None) -> Val:
    """``v`` at ``idx`` (a nested value's child stays: its words or ids
    move); ``valid`` nulls where it is False."""
    n = v.values.shape[0]
    if n == 0:
        values = torch.zeros(idx.shape[0], dtype=v.values.dtype, device=idx.device)
        return v.with_(values=values, validity=torch.zeros(idx.shape[0], dtype=torch.bool, device=idx.device),
                       domain=ROW)
    i = idx.clamp(0, n - 1)
    validity = None if v.validity is None else v.validity.index_select(0, i)
    return v.with_(values=v.values.index_select(0, i), validity=combine_validity(validity, valid), domain=ROW)


@dataclasses.dataclass
class Elements:
    """Every element of the valid rows of a list value, grouped by row."""

    owner: torch.Tensor  # (T,) int64: the row of each element
    idx: torch.Tensor  # (T,) int64: its place in the child
    pos: torch.Tensor  # (T,) int64: its place in its list
    lens: torch.Tensor  # (n,) int64: elements per row (0 where the row is null)
    offs: torch.Tensor  # (n,) int64: each row's first element
    total: int

    @property
    def n(self) -> int:
        return self.lens.shape[0]

    @property
    def gids(self) -> torch.Tensor:
        return self.owner.to(torch.int32)


def elements(ctx: EvalCtx | None, v: Val) -> Elements:
    """The elements of ``v``'s valid rows (one host read: their count)."""
    key = (id(v.values), None if v.validity is None else id(v.validity))
    memo = None
    if ctx is not None:
        if ctx.lists is None:
            ctx.lists = {}
        memo = ctx.lists
        hit = memo.get(key)  # the tensors are kept, so their ids are not reused while it lives
        if hit is not None and hit[0] is v.values and hit[1] is v.validity:
            return hit[2]
    starts, lens = unpack(v.values)
    if v.validity is not None:
        lens = torch.where(v.validity, lens, 0)
    n, dev = lens.shape[0], lens.device
    offs = torch.cumsum(lens, 0) - lens
    total = int(lens.sum()) if n else 0
    owner = torch.repeat_interleave(_iota(n, dev), lens, output_size=total)
    pos = _iota(total, dev) - offs.index_select(0, owner)
    el = Elements(owner, starts.index_select(0, owner) + pos, pos, lens, offs, total)
    if memo is not None:
        memo[key] = (v.values, v.validity, el)
    return el


def element_val(v: Val, el: Elements) -> Val:
    """The elements' values (with their own child where they nest)."""
    return gather_val(v.child, el.idx)


def make_list(v: Val, lens: torch.Tensor, child: Val, dtype: dt.DataType | None = None) -> Val:
    """A list value over ``child`` with ``v``'s rows and validity: row r
    holds ``lens[r]`` elements, the child in row order, one list after
    another."""
    return Val(pack(torch.cumsum(lens, 0) - lens, lens), v.validity, dtype or v.dtype, None, v.domain,
               child.with_(domain=ROW))


def compact_val(e: Val, keep: torch.Tensor) -> Val:
    """``e``'s values where ``keep`` holds, in order (kernel K2; one host
    read of the count)."""
    keep = keep.contiguous()
    offs = compact_count(keep)
    count = int(offs[-1])
    cols = [e.values.contiguous()] + ([] if e.validity is None else [e.validity.contiguous()])
    outs = compact_scatter(cols, keep, offs, count)
    return e.with_(values=outs[0], validity=None if e.validity is None else outs[1], domain=ROW)


def filter_elements(v: Val, el: Elements, e: Val, keep: torch.Tensor) -> Val:
    """The list of the elements ``e`` (in element space) where ``keep``:
    K2 compacts them, K1 counts them per row."""
    return make_list(v, G.seg_count(keep, el.gids, el.n), compact_val(e, keep))


def _ok(e: Val) -> torch.Tensor:
    if e.validity is None:
        return torch.ones(e.values.shape[0], dtype=torch.bool, device=e.values.device)
    return e.validity


def _row_val(v: Val, values: torch.Tensor, validity, dtype: dt.DataType, table=None) -> Val:
    return Val(values, combine_validity(validity, v.validity), dtype, table, v.domain)


# ---------------------------------------------------------------------------
# dtype rules
# ---------------------------------------------------------------------------


def _in(dts, opts) -> dt.DataType:
    d = dts[0]
    if not isinstance(d, (dt.List, dt.Array)):
        raise InvalidOperationError(f"a list function needs a List or Array, got {d!r}")
    return d.inner


def _same(dts, opts):
    _in(dts, opts)
    return dts[0] if isinstance(dts[0], dt.List) else dt.List(dts[0].inner)


def _keep_dt(dts, opts):  # a function that keeps the width of an Array
    _in(dts, opts)
    return dts[0]


def _sum_dt(dts, opts):
    inner = _in(dts, opts)
    return inner if inner.is_float() else dt.Int64()


def _mean_dt(dts, opts):
    inner = _in(dts, opts)
    return dt.Float32() if isinstance(inner, dt.Float32) else dt.Float64()


def _u32(dts, opts):
    _in(dts, opts)
    return dt.UInt32()


def _bool(dts, opts):
    _in(dts, opts)
    return dt.Boolean()


def _diff_dt(dts, opts):
    inner = _in(dts, opts)
    if inner.is_float():
        return dts[0]
    if inner.is_temporal():
        return dt.List(dt.Duration(getattr(inner, "time_unit", "ms")))
    return dt.List(dt.Int64())


# ---------------------------------------------------------------------------
# reductions per list
# ---------------------------------------------------------------------------


@register("list.len", _u32)
def _list_len(ctx, args, opts):
    v = args[0]
    return _row_val(v, v.values.to(torch.int64) & LEN_MASK, None, dt.UInt32())


def _numeric_elements(ctx, v: Val, name: str) -> tuple[Elements, Val]:
    inner = _in([v.dtype], None)
    if not (inner.is_numeric() or isinstance(inner, (dt.Boolean, dt.Null))):
        raise InvalidOperationError(f"list.{name} needs a numeric inner dtype, got {inner!r}")
    el = elements(ctx, v)
    return el, element_val(v, el)


@register("list.sum", _sum_dt)
def _list_sum(ctx, args, opts):
    v = args[0]
    el, e = _numeric_elements(ctx, v, "sum")
    out_dt = _sum_dt([v.dtype], opts)
    s = G.seg_sum(e.values.to(dt.dtype_to_torch(out_dt)), _ok(e), el.gids, el.n)
    return _row_val(v, s, None, out_dt)  # an empty or all-null list sums to 0, as in Polars


@register("list.mean", _mean_dt)
def _list_mean(ctx, args, opts):
    v = args[0]
    el, e = _numeric_elements(ctx, v, "mean")
    out_dt = _mean_dt([v.dtype], opts)
    x = e.values if e.values.dtype in (torch.float32, torch.float64) else e.values.to(torch.float64)
    m, has = G.seg_mean(x, _ok(e), el.gids, el.n)
    return _row_val(v, m.to(dt.dtype_to_torch(out_dt)), has, out_dt)


def _extreme(kind: str):
    @register(f"list.{kind}", _in)
    def impl(ctx, args, opts):
        from polars_tpu_torch.engine.strings import ensure_ordinal_val

        v = args[0]
        el = elements(ctx, v)
        e = ensure_ordinal_val(element_val(v, el))
        ok = _ok(e)
        has = G.seg_count(ok, el.gids, el.n) > 0
        return _row_val(v, G.seg_extreme(kind, e, ok, el.gids, el.n), has, e.dtype, e.table)

    return impl


_extreme("min")
_extreme("max")


def _moment(kind: str):
    @register(f"list.{kind}", _mean_dt)
    def impl(ctx, args, opts):
        v = args[0]
        el, e = _numeric_elements(ctx, v, kind)
        out_dt = _mean_dt([v.dtype], opts)
        x = e.values.to(torch.float64)
        var, ok = G.seg_var(x, _ok(e), el.gids, el.n, int(opts.get("ddof", 1)))
        out = var if kind == "var" else torch.sqrt(var.clamp(min=0))
        return _row_val(v, out.to(dt.dtype_to_torch(out_dt)), ok, out_dt)

    return impl


_moment("var")
_moment("std")


@register("list.median", _mean_dt)
def _list_median(ctx, args, opts):
    v = args[0]
    el, e = _numeric_elements(ctx, v, "median")
    out_dt = _mean_dt([v.dtype], opts)
    q, has = G.seg_quantile(e.with_(dtype=dt.Float64(), values=e.values.to(torch.float64)), _ok(e), el.gids,
                            el.n, 0.5, "linear")
    return _row_val(v, q.to(dt.dtype_to_torch(out_dt)), has, out_dt)


@register("list.n_unique", _u32)
def _list_n_unique(ctx, args, opts):
    v = args[0]
    el = elements(ctx, v)
    e = element_val(v, el)
    ones = torch.ones(el.total, dtype=torch.bool, device=el.owner.device)
    return _row_val(v, G.seg_nunique(e, ones, el.gids, el.n), None, dt.UInt32())


def _arg_extreme(kind: str):
    @register(f"list.{kind}", _u32)
    def impl(ctx, args, opts):
        from polars_tpu_torch.engine.strings import ensure_ordinal_val

        v = args[0]
        el = elements(ctx, v)
        e = ensure_ordinal_val(element_val(v, el))
        ok = _ok(e)
        ext = G.seg_extreme("min" if kind == "arg_min" else "max", e, ok, el.gids, el.n)
        hit = ok & _same_value(e.values, ext.index_select(0, el.owner) if el.total else ext[:0])
        idx, has = G.seg_first_idx(hit, el.gids, el.n)
        pos = el.pos.index_select(0, idx.clamp(0, max(el.total - 1, 0))) if el.total else idx.to(torch.int64)
        return _row_val(v, pos, has, dt.UInt32())

    return impl


def _same_value(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    eq = a == b
    if a.dtype.is_floating_point:
        eq = eq | (torch.isnan(a) & torch.isnan(b))
    return eq


_arg_extreme("arg_min")
_arg_extreme("arg_max")


def _any_all(kind: str):
    @register(f"list.{kind}", _bool)
    def impl(ctx, args, opts):
        v = args[0]
        el = elements(ctx, v)
        e = element_val(v, el)
        x = e.values.to(torch.bool)
        fn = G.seg_any if kind == "any" else G.seg_all
        return _row_val(v, fn(x, _ok(e), el.gids, el.n), None, dt.Boolean())

    return impl


_any_all("any")
_any_all("all")


def _matches(ctx, v: Val, item: Val) -> tuple[Elements, torch.Tensor]:
    from polars_tpu_torch.engine.compiler import compare_vals

    el = elements(ctx, v)
    e = element_val(v, el)
    if isinstance(item.dtype, dt.Null):
        return el, ~_ok(e)
    x = item if item.domain == SCALAR else gather_val(item, el.owner)  # each element's row's item
    eq = compare_vals("==", e, x)
    hit = eq.values.to(torch.bool).expand(el.total)
    if eq.validity is not None:
        hit = hit & eq.validity.expand(el.total)
    return el, hit


@register("list.contains", _bool)
def _list_contains(ctx, args, opts):
    v, item = args[0], args[1]
    el, hit = _matches(ctx, v, item)
    return _row_val(v, G.seg_any(hit, hit, el.gids, el.n), None, dt.Boolean())


@register("list.count_matches", _u32)
def _list_count_matches(ctx, args, opts):
    v, item = args[0], args[1]
    el, hit = _matches(ctx, v, item)
    return _row_val(v, G.seg_count(hit, el.gids, el.n), None, dt.UInt32())


def list_get(v: Val, index: Val | int, null_on_oob: bool, ctx: EvalCtx | None) -> Val:
    """Each row's element at ``index`` (negative from the end): null past
    the end with ``null_on_oob``, else a failure at the segment's count
    read. No element space: the packed words give the place."""
    starts, lens = unpack(v.values)
    if isinstance(index, Val):
        i = index.values.to(torch.int64)
        ivalid = index.validity
    else:
        i = torch.full_like(lens, int(index))
        ivalid = None
    i = torch.where(i < 0, i + lens, i)
    inb = (i >= 0) & (i < lens)
    if not null_on_oob and ctx is not None:
        bad = ~inb
        for m in (v.validity, ivalid, ctx.rowmask if v.domain == ROW and ctx.rowmask.shape == bad.shape else None):
            if m is not None:
                bad = bad & m
        ctx.add_flag(bad.any(), "get index is out of bounds", ComputeError)
    e = gather_val(v.child, starts + i.clamp(min=0), inb)
    return Val(e.values, combine_validity(e.validity, v.validity, ivalid), e.dtype, e.table, v.domain, e.child)


@register("list.get", _in)
def _list_get(ctx, args, opts):
    v = args[0]
    index = args[1] if len(args) > 1 else int(opts["index"])
    return list_get(v, index, bool(opts.get("null_on_oob", False)), ctx)


@register("list.item", _in)
def _list_item(ctx, args, opts):
    v = args[0]
    _, lens = unpack(v.values)
    bad = lens > 1 if opts.get("allow_empty") else lens != 1
    if v.validity is not None:
        bad = bad & v.validity
    if v.domain == ROW and ctx.rowmask.shape == bad.shape:
        bad = bad & ctx.rowmask
    ctx.add_flag(bad.any(), "aggregation 'item' expected a list of length 1", ComputeError)
    return list_get(v, 0, True, ctx)


# ---------------------------------------------------------------------------
# functions that rebuild the lists
# ---------------------------------------------------------------------------


def _order_words(el: Elements, e: Val, descending: bool = False, nulls_last: bool = False) -> list:
    """(row, value order words): a stable sort by them sorts each list."""
    from polars_tpu_torch.engine.fn_position import value_words

    return [el.owner, *value_words(e, descending, nulls_last)]


def _runs(el: Elements, e: Val) -> tuple[torch.Tensor, torch.Tensor]:
    """(the first element of each run of equal values within a row, in
    element order; the sort that made the runs). Nulls are one value, and
    so is NaN (the order words make NaN one value and -0.0 equal 0.0)."""
    words = _order_words(el, e)
    perm = stable_argsort_words(words)
    first_sorted = boundaries_from_words(words, perm)
    first = torch.empty_like(first_sorted).index_copy_(0, perm, first_sorted)
    return first, perm


@register("list.sort", _keep_dt)
def _list_sort(ctx, args, opts):
    v = args[0]
    el = elements(ctx, v)
    e = element_val(v, el)
    perm = stable_argsort_words(_order_words(el, e, bool(opts.get("descending")), bool(opts.get("nulls_last"))))
    return make_list(v, el.lens, gather_val(e, perm))


@register("list.reverse", _keep_dt)
def _list_reverse(ctx, args, opts):
    v = args[0]
    el = elements(ctx, v)
    e = element_val(v, el)
    src = el.offs.index_select(0, el.owner) + el.lens.index_select(0, el.owner) - 1 - el.pos
    return make_list(v, el.lens, gather_val(e, src))


@register("list.unique", _same)
def _list_unique(ctx, args, opts):
    v = args[0]
    el = elements(ctx, v)
    e = element_val(v, el)
    first, perm = _runs(el, e)
    if opts.get("maintain_order"):
        # the first of each run in element order
        _, pos_first = _first_of_runs(el, e)
        return filter_elements(v, el, e, pos_first)
    return filter_elements(v, el, gather_val(e, perm), first.index_select(0, perm))


def _first_of_runs(el: Elements, e: Val) -> tuple[torch.Tensor, torch.Tensor]:
    """(run id of each element, the element that is its run's first in
    element order)."""
    first, perm = _runs(el, e)
    run_sorted = torch.cumsum(first.index_select(0, perm), 0) - 1
    run = torch.empty_like(run_sorted).index_copy_(0, perm, run_sorted)
    nruns = int(run_sorted[-1]) + 1 if el.total else 0
    lead = torch.full((max(nruns, 1),), el.total, dtype=torch.int64, device=run.device)
    lead = lead.scatter_reduce(0, run, _iota(el.total, run.device), "amin", include_self=True)
    return run, _iota(el.total, run.device) == lead.index_select(0, run)


def _range_slice(v: Val, first: torch.Tensor, length: torch.Tensor) -> Val:
    """Each row's sublist [first, first + length) of its list (clamped): new
    packed words over the same child."""
    starts, lens = unpack(v.values)
    first = first.clamp(min=0).minimum(lens)
    length = length.clamp(min=0).minimum(lens - first)
    return v.with_(values=pack(starts + first, length))


@register("list.slice", _same)
def _list_slice(ctx, args, opts):
    v = args[0]
    _, lens = unpack(v.values)
    off = int(opts.get("offset", 0))
    length = opts.get("length")
    first = (lens + off).clamp(min=0) if off < 0 else torch.full_like(lens, off)
    return _range_slice(v, first, lens if length is None else torch.full_like(lens, int(length)))


@register("list.head", _same)
def _list_head(ctx, args, opts):
    v = args[0]
    _, lens = unpack(v.values)
    return _range_slice(v, torch.zeros_like(lens), torch.full_like(lens, int(opts.get("n", 5))))


@register("list.tail", _same)
def _list_tail(ctx, args, opts):
    v = args[0]
    _, lens = unpack(v.values)
    n = int(opts.get("n", 5))
    return _range_slice(v, (lens - n).clamp(min=0), torch.full_like(lens, n))


@register("list.gather_every", _same)
def _list_gather_every(ctx, args, opts):
    v = args[0]
    el = elements(ctx, v)
    n, off = int(opts.get("n", 1)), int(opts.get("offset", 0))
    keep = (el.pos >= off) & ((el.pos - off) % n == 0)
    return filter_elements(v, el, element_val(v, el), keep)


def _shifted(el: Elements, e: Val, n: int) -> Val:
    """Each element replaced by the one ``n`` places before it in its list
    (null where there is none)."""
    src = el.pos - n
    ok = (src >= 0) & (src < el.lens.index_select(0, el.owner))
    return gather_val(e, _iota(el.total, el.owner.device) - n, ok)


@register("list.shift", _keep_dt)
def _list_shift(ctx, args, opts):
    v = args[0]
    el = elements(ctx, v)
    return make_list(v, el.lens, _shifted(el, element_val(v, el), int(opts.get("n", 1))))


@register("list.diff", _diff_dt)
def _list_diff(ctx, args, opts):
    from polars_tpu_torch.engine.compiler import _arith

    v = args[0]
    el = elements(ctx, v)
    e = element_val(v, el)
    n = int(opts.get("n", 1))
    out_dt = _diff_dt([v.dtype], opts)
    values, validity = _arith("-", e, _shifted(el, e, n), out_dt.inner)
    out = make_list(v, el.lens, Val(values, validity, out_dt.inner), out_dt)
    if opts.get("null_behavior", "ignore") == "drop":
        _, lens = unpack(out.values)
        return _range_slice(out, torch.full_like(lens, n), lens)
    return out


@register("list.drop_nulls", _same)
def _list_drop_nulls(ctx, args, opts):
    v = args[0]
    el = elements(ctx, v)
    e = element_val(v, el)
    return filter_elements(v, el, e, _ok(e))


def element_ctx(ctx: EvalCtx, el: Elements, e: Val, grouped: bool) -> EvalCtx:
    """A context over the elements (``pl.element()`` is the column ""); in
    one group per list when ``grouped``."""
    dev = el.owner.device
    groups = None
    if grouped:
        groups = GroupCtx(gids=el.gids, num_groups=torch.tensor(el.n, dtype=torch.int32, device=dev),
                          capacity=el.n, group_valid=torch.ones(el.n, dtype=torch.bool, device=dev),
                          counts=el.lens, sort_perm=_iota(el.total, dev))
    return EvalCtx(cols={"": e}, rowmask=torch.ones(el.total, dtype=torch.bool, device=dev), groups=groups,
                   memo={}, flags=ctx.flags)


def _eval_dt(dts, opts):
    from polars_tpu_torch.core.schema import Schema
    from polars_tpu_torch.plan.schema_resolve import expr_dtype

    return dt.List(expr_dtype(opts["expr"], Schema([("", _in(dts, opts))])))


@register("list.eval", _eval_dt)
def _list_eval(ctx, args, opts):
    """``expr`` over each list's elements: an elementwise one over all the
    elements at once, any other in one group per list (an aggregation gives
    a list of one value)."""
    from polars_tpu_torch.engine.compiler import eval_expr
    from polars_tpu_torch.plan import exprs as E

    v = args[0]
    el = elements(ctx, v)
    node = opts["expr"]
    out_dt = _eval_dt([v.dtype], opts)
    if E.changes_length(node):  # a filter or slice in each list: the elements it keeps
        from polars_tpu_torch.engine.compiler import _agg_input

        r, keep = _agg_input(node, element_ctx(ctx, el, element_val(v, el), True))
        return filter_elements(v.with_(dtype=out_dt), el, r, keep)
    grouped = not E.is_elementwise(node)
    r = eval_expr(node, element_ctx(ctx, el, element_val(v, el), grouped))
    if r.domain == SCALAR:
        r = r.with_(values=r.values.expand(el.total),
                    validity=None if r.validity is None else r.validity.expand(el.total), domain=ROW)
    if r.domain == GROUP:  # one value per list
        return one_per_list(r).with_(validity=v.validity, dtype=out_dt, domain=v.domain)
    return make_list(v, el.lens, r, out_dt)


@register("list.filter", _same)
def _list_filter(ctx, args, opts):
    from polars_tpu_torch.engine.compiler import eval_expr

    v = args[0]
    el = elements(ctx, v)
    e = element_val(v, el)
    p = eval_expr(opts["expr"], element_ctx(ctx, el, e, False))
    keep = p.values.to(torch.bool).expand(el.total)
    if p.validity is not None:
        keep = keep & p.validity.expand(el.total)
    return filter_elements(v, el, e, keep)


def _as_list(x: Val) -> Val:
    """A list argument: a value that is not a list is a list of one."""
    if isinstance(x.dtype, (dt.List, dt.Array)):
        return x.with_(dtype=dt.List(x.dtype.inner))
    n = x.values.shape[0]
    child = x.with_(domain=ROW)
    return Val(pack(_iota(n, x.values.device), torch.ones(n, dtype=torch.int64, device=x.values.device)),
               None, dt.List(x.dtype), None, x.domain, child)


def _rows_of(vals: list[Val]) -> list[Val]:
    """List arguments of one row count: a scalar list repeats."""
    rows = max(v.values.shape[0] for v in vals)
    out = []
    for v in vals:
        if v.values.shape[0] != rows:
            if v.values.shape[0] != 1:
                raise ShapeError("list arguments have different lengths")
            v = v.with_(values=v.values.expand(rows),
                        validity=None if v.validity is None else v.validity.expand(rows))
        out.append(v)
    return out


def concat_rows(ctx, vals: list[Val], dtype: dt.DataType | None = None) -> tuple[Val, torch.Tensor, Elements]:
    """Row by row, the lists of ``vals`` one after another (a null list
    makes the row null): (the list, the side each element came from, the
    elements of the result)."""
    from polars_tpu_torch.engine.strings import concat_vals
    from polars_tpu_torch.plan.schema_resolve import supertype

    vals = _rows_of([_as_list(x) for x in vals])
    inner = dtype.inner if dtype is not None else None
    for x in vals:
        inner = x.dtype.inner if inner is None else supertype(inner, x.dtype.inner)
    validity = combine_validity(*(x.validity for x in vals))
    row_ok = None if validity is None else validity
    els = [elements(ctx, x.with_(validity=row_ok)) for x in vals]
    lens = sum(e.lens for e in els)
    offs = torch.cumsum(lens, 0) - lens
    parts, dests, sides = [], [], []
    before = torch.zeros_like(lens)
    for k, (x, el) in enumerate(zip(vals, els)):
        parts.append(element_val(x, el))
        dests.append(offs.index_select(0, el.owner) + before.index_select(0, el.owner) + el.pos)
        sides.append(torch.full((el.total,), k, dtype=torch.int8, device=lens.device))
        before = before + el.lens
    cat = concat_vals(parts, inner)
    dest = torch.cat(dests)
    src = torch.empty_like(dest).index_copy_(0, dest, _iota(dest.shape[0], dest.device))
    out = Val(pack(offs, lens), validity, dt.List(inner), None, vals[0].domain, gather_val(cat, src))
    side = torch.cat(sides).index_select(0, src)
    total = int(dest.shape[0])
    owner = torch.repeat_interleave(_iota(lens.shape[0], lens.device), lens, output_size=total)
    el = Elements(owner, _iota(total, lens.device), _iota(total, lens.device) - offs.index_select(0, owner),
                  lens, offs, total)
    return out, side, el


@register("list.concat", _same)
def _list_concat(ctx, args, opts):
    return concat_rows(ctx, list(args))[0]


def _concat_list_dt(dts, opts):
    from polars_tpu_torch.plan.schema_resolve import supertype

    inner = None
    for d in dts:
        i = d.inner if isinstance(d, (dt.List, dt.Array)) else d
        inner = i if inner is None else supertype(inner, i)
    return dt.List(inner if inner is not None else dt.Null())


@register("concat_list", _concat_list_dt)
def _concat_list(ctx, args, opts):
    return concat_rows(ctx, list(args), _concat_list_dt([a.dtype for a in args], opts))[0]


def _set_op(kind: str):
    @register(f"list.{kind}", _same)
    def impl(ctx, args, opts):
        out, side, el = concat_rows(ctx, list(args[:2]))
        e = element_val(out, el)
        run, lead = _first_of_runs(el, e)
        nruns = int(run.max()) + 1 if el.total else 1
        in_a = torch.zeros(nruns, dtype=torch.bool, device=run.device).index_put_((run[side == 0],),
                                                                               torch.ones(1, dtype=torch.bool,
                                                                                          device=run.device))
        in_b = torch.zeros(nruns, dtype=torch.bool, device=run.device).index_put_((run[side == 1],),
                                                                               torch.ones(1, dtype=torch.bool,
                                                                                          device=run.device))
        a, b = in_a.index_select(0, run), in_b.index_select(0, run)
        want = {"set_union": torch.ones_like(a), "set_intersection": a & b, "set_difference": a & ~b,
                "set_symmetric_difference": a ^ b}[kind]
        return filter_elements(out, el, e, lead & want)

    return impl


for _k in ("set_union", "set_intersection", "set_difference", "set_symmetric_difference"):
    _set_op(_k)


@register("list.gather", _same)
def _list_gather(ctx, args, opts):
    """Each row's elements at its indices: a literal index list (the same
    for every row; an empty one gives empty lists, where the JAX package
    fails) or a List column of them."""
    v = args[0]
    null_on_oob = bool(opts.get("null_on_oob", False))
    starts, lens = unpack(v.values)
    if len(args) > 1:
        ix = args[1]
        iel = elements(ctx, ix.with_(validity=combine_validity(ix.validity, v.validity)))
        iv = element_val(ix, iel)
        owner, i, ivalid = iel.owner, iv.values.to(torch.int64), iv.validity
        out_lens = iel.lens
    else:
        idx = torch.tensor(list(opts.get("indices", ())), dtype=torch.int64, device=lens.device)
        k = idx.shape[0]
        out_lens = torch.where(_ok(v), k, 0) if v.validity is not None else torch.full_like(lens, k)
        total = int(out_lens.sum()) if k else 0
        owner = torch.repeat_interleave(_iota(lens.shape[0], lens.device), out_lens, output_size=total)
        i = idx.repeat(total // k) if k else idx
        ivalid = None
    ln = lens.index_select(0, owner)
    i = torch.where(i < 0, i + ln, i)
    inb = (i >= 0) & (i < ln)
    if not null_on_oob:
        bad = ~inb if ivalid is None else (~inb & ivalid)
        if v.domain == ROW and ctx.rowmask.shape == lens.shape:
            bad = bad & ctx.rowmask.index_select(0, owner)
        ctx.add_flag(bad.any(), "gather indices are out of bounds", ComputeError)
    e = gather_val(v.child, starts.index_select(0, owner) + i.clamp(min=0), combine_validity(inb, ivalid))
    return make_list(v, out_lens, e)


@register("list.sample", _same)
def _list_sample(ctx, args, opts):
    """A sample of each list: ``n`` elements or a ``fraction`` of each
    list's length, without replacement, in a random order (``shuffle``) or
    in list order, from a generator seeded by ``seed``; with replacement,
    one draw per element of the output."""
    v = args[0]
    if opts.get("with_replacement"):
        return _sample_with_replacement(ctx, v, opts)
    el = elements(ctx, v)
    e = element_val(v, el)
    gen = torch.Generator(device=el.owner.device)
    gen.manual_seed(int(opts["seed"]) if opts.get("seed") is not None else 0)
    rand = torch.rand(el.total, generator=gen, device=el.owner.device, dtype=torch.float64)
    perm = stable_argsort_words([el.owner, rand])
    if opts.get("fraction") is not None:
        want = torch.floor(el.lens.to(torch.float64) * float(opts["fraction"])).to(torch.int64)
    else:
        want = torch.full_like(el.lens, int(opts.get("n") or 0))
    if (want > el.lens).any():
        raise ShapeError("cannot take a larger sample than the list's length without replacement")
    rank = el.pos  # the sorted elements keep their rows' ranges
    chosen = rank < want.index_select(0, el.owner)
    if not opts.get("shuffle"):
        # the chosen elements back in list order
        picked = torch.zeros(el.total, dtype=torch.bool, device=rank.device).index_copy_(0, perm, chosen)
        return filter_elements(v, el, e, picked)
    return filter_elements(v, el, gather_val(e, perm), chosen)


def _sample_with_replacement(ctx, v: Val, opts: dict) -> Val:
    """Each list's ``n`` (or ``fraction`` of its length) elements drawn with
    replacement: one ``torch.rand`` per output element from a generator
    seeded by ``seed``, on the device; one host read of the output's size.
    A valid empty list asked for elements fails at the segment's count
    read, as Polars raises."""
    starts, lens = unpack(v.values)
    if v.validity is not None:
        lens = torch.where(v.validity, lens, 0)
    if opts.get("fraction") is not None:
        want = torch.floor(lens.to(torch.float64) * float(opts["fraction"])).to(torch.int64)
    else:
        want = torch.full_like(lens, int(opts.get("n") or 0))
    empty = (want > 0) & (lens == 0)
    if v.validity is not None:
        want, empty = torch.where(v.validity, want, 0), empty & v.validity
    ctx.add_flag(empty.any(), "cannot take a sample from an empty list", ShapeError)
    n, dev = lens.shape[0], lens.device
    total = int(want.sum()) if n else 0
    owner = torch.repeat_interleave(_iota(n, dev), want, output_size=total)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(opts["seed"]) if opts.get("seed") is not None else 0)
    ln = lens.index_select(0, owner)
    draw = torch.floor(torch.rand(total, generator=gen, device=dev, dtype=torch.float64) * ln.to(torch.float64))
    pick = torch.minimum(draw.to(torch.int64), (ln - 1).clamp(min=0))
    return make_list(v, want, gather_val(v.child, starts.index_select(0, owner) + pick))


def _to_array_dt(dts, opts):
    return dt.Array(_in(dts, opts), int(opts["width"]))


@register("list.to_array", _to_array_dt)
def _list_to_array(ctx, args, opts):
    v = args[0]
    _, lens = unpack(v.values)
    bad = lens != int(opts["width"])
    if v.validity is not None:
        bad = bad & v.validity
    ctx.add_flag(bad.any(), f"not all lists have the array width {int(opts['width'])}", ComputeError)
    return v.with_(dtype=_to_array_dt([v.dtype], opts))


@register("list.to_list", lambda dts, opts: dt.List(_in(dts, opts)))
def _arr_to_list(ctx, args, opts):
    return args[0].with_(dtype=dt.List(_in([args[0].dtype], None)))


def _to_struct_dt(dts, opts):
    inner = _in(dts, opts)
    fields = opts.get("fields")
    if fields is None:
        n = int(opts.get("upper_bound") or 0)
        if not n:
            raise InvalidOperationError("list.to_struct needs `fields` or `upper_bound` (its schema is fixed "
                                        "before the data is read)")
        fields = [f"field_{i}" for i in range(n)]
    return dt.Struct([(f, inner) for f in fields])


@register("list.to_struct", _to_struct_dt)
def _list_to_struct(ctx, args, opts):
    v = args[0]
    out_dt = _to_struct_dt([v.dtype], opts)
    fields = tuple(list_get(v.with_(validity=None), i, True, ctx).with_(domain=ROW)
                   for i in range(len(out_dt.fields)))
    n = v.values.shape[0]
    return Val(_iota(n, v.values.device), v.validity, out_dt, None, v.domain, fields)


def _join_dt(dts, opts):
    _in(dts, opts)
    return dt.String()


register("list.join", _join_dt)(raises("list.join runs on the host between segments (engine/hostops.py)"))
register("struct.json_encode", dt.String())(
    raises("struct.json_encode runs on the host between segments (engine/hostops.py)"))
register("str.json_decode", lambda dts, opts: opts.get("dtype") or dt.Unknown(), elementwise=False)(
    raises("str.json_decode runs on the host between segments (engine/hostops.py)"))


# ---------------------------------------------------------------------------
# explode and implode
# ---------------------------------------------------------------------------


def _explode_dt(dts, opts):
    d = dts[0]
    return d.inner if isinstance(d, (dt.List, dt.Array)) else d


@register("explode", _explode_dt, elementwise=False)
def _explode(ctx, args, opts):
    raise InvalidOperationError("explode changes the length of its column: it applies in a select")


def explode_piece(v: Val, keep: torch.Tensor | None) -> tuple[Val, torch.Tensor]:
    """An exploded column of a select: (its elements, all kept), over the
    rows ``keep`` holds (a scalar list is one row)."""
    if not isinstance(v.dtype, (dt.List, dt.Array)):
        if keep is None:
            return v, None
        return v, keep
    owner, pos = explode_index(v, keep)
    return exploded(v, owner, pos), torch.ones(owner.shape[0], dtype=torch.bool, device=owner.device)


def explode_index(v: Val, rowmask: torch.Tensor | None) -> tuple[torch.Tensor, torch.Tensor]:
    """(the row of each output row, its place in the row's list) of an
    explode: each kept row gives its elements, a null or empty list one
    null, as in Polars (one host read: the output's length)."""
    eff = explode_lens(v)
    if rowmask is not None:
        eff = torch.where(rowmask, eff, 0)
    n, dev = eff.shape[0], eff.device
    offs = torch.cumsum(eff, 0) - eff
    total = int(eff.sum()) if n else 0
    owner = torch.repeat_interleave(_iota(n, dev), eff, output_size=total)
    return owner, _iota(total, dev) - offs.index_select(0, owner)


def exploded(v: Val, owner: torch.Tensor, pos: torch.Tensor) -> Val:
    """The elements of an explode (null past a row's list)."""
    starts, lens = unpack(v.values)
    has = pos < lens.index_select(0, owner)
    if v.validity is not None:
        has = has & v.validity.index_select(0, owner)
    return gather_val(v.child, starts.index_select(0, owner) + pos, has)


def explode_lens(v: Val) -> torch.Tensor:
    """Output rows per row of an explode: its length, or 1 where it is null
    or empty."""
    _, lens = unpack(v.values)
    ok = lens > 0 if v.validity is None else (v.validity & (lens > 0))
    return torch.where(ok, lens, 1)


def one_per_list(v: Val) -> Val:
    """Each row's value as a list of one."""
    n = v.values.shape[0]
    ones = torch.ones(n, dtype=torch.int64, device=v.values.device)
    return Val(pack(_iota(n, v.values.device), ones), None, dt.List(v.dtype), None, v.domain, v.with_(domain=ROW))


def implode(ctx: EvalCtx, v: Val, domain: str) -> Val:
    """The rows of each group (outside a group-by, of the one group) as one
    list, in row order: the child is the rows in group order (the group-by's
    own sort where it has one), each group's list its count of rows from its
    offset."""
    from polars_tpu_torch.engine import fn_position as P
    from polars_tpu_torch.engine.compiler import group_of

    gctx = group_of(ctx)
    if v.domain == SCALAR:
        v = P.row_domain(ctx, v)
    o = P.group_order(ctx)
    counts = G.group_counts(gctx, ctx.rowmask)
    offs = torch.cumsum(counts, 0) - counts
    return Val(pack(offs, counts), None, dt.List(v.dtype), None, domain, gather_val(v, o.perm))


# ---------------------------------------------------------------------------
# structs
# ---------------------------------------------------------------------------


def _as_struct_dt(dts, opts):
    names = opts.get("names") or [f"field_{i}" for i in range(len(dts))]
    return dt.Struct(list(zip(names, dts)))


@register("as_struct", _as_struct_dt)
def _as_struct(ctx, args, opts):
    """``pl.struct``: row ids over the fields, each field per row."""
    from polars_tpu_torch.engine.fn_position import row_domain

    fields = tuple(row_domain(ctx, a) if a.domain == SCALAR else a for a in args)
    doms = {f.domain for f in fields}
    if len(doms) > 1:
        raise ShapeError("the fields of a struct have different lengths")
    n = fields[0].values.shape[0]
    return Val(_iota(n, ctx.device), None, _as_struct_dt([a.dtype for a in args], opts), None, doms.pop(), fields)


def struct_field(v: Val, name: str) -> Val:
    """The field ``name`` of each row (null where the struct is null)."""
    if not isinstance(v.dtype, dt.Struct):
        raise InvalidOperationError(f"struct.field needs a Struct, got {v.dtype!r}")
    for f, c in zip(v.dtype.fields, v.child):
        if f.name == name:
            out = gather_val(c, v.values, v.validity)
            return out.with_(domain=v.domain)
    raise SchemaError(f"the struct has no field {name!r}: {[f.name for f in v.dtype.fields]}")


def _field_dt(dts, opts):
    d = dts[0]
    if not isinstance(d, dt.Struct):
        raise InvalidOperationError(f"struct.field needs a Struct, got {d!r}")
    for f in d.fields:
        if f.name == opts["name"]:
            return f.dtype
    raise SchemaError(f"the struct has no field {opts['name']!r}: {[f.name for f in d.fields]}")


@register("struct.field", _field_dt)
def _struct_field(ctx, args, opts):
    return struct_field(args[0], opts["name"])


def _rename_dt(dts, opts):
    d = dts[0]
    if not isinstance(d, dt.Struct):
        raise InvalidOperationError(f"struct.rename_fields needs a Struct, got {d!r}")
    names = list(opts["names"])
    return dt.Struct([(names[i] if i < len(names) else f.name, f.dtype) for i, f in enumerate(d.fields)])


@register("struct.rename_fields", _rename_dt)
def _struct_rename(ctx, args, opts):
    return args[0].with_(dtype=_rename_dt([args[0].dtype], opts))


def _drop_dt(dts, opts):
    d = dts[0]
    if not isinstance(d, dt.Struct):
        raise InvalidOperationError(f"struct.drop needs a Struct, got {d!r}")
    drop = set(opts["names"])
    missing = [n for n in opts["names"] if n not in {f.name for f in d.fields}]
    if missing:  # as Polars (and the JAX package): a field that is not there is an error
        raise ComputeError(f"struct has no field(s) {missing}")
    return dt.Struct([(f.name, f.dtype) for f in d.fields if f.name not in drop])


def _map_names_dt(dts, opts):
    d = dts[0]
    if not isinstance(d, dt.Struct):
        raise InvalidOperationError(f"name.*_fields needs a Struct, got {d!r}")
    fn = opts["function"]
    return dt.Struct([(fn(f.name), f.dtype) for f in d.fields])


@register("struct.map_field_names", _map_names_dt)
def _struct_map_names(ctx, args, opts):
    """``name.prefix_fields``/``suffix_fields``/``map_fields``: the fields
    renamed, the values kept."""
    return args[0].with_(dtype=_map_names_dt([args[0].dtype], opts))


@register("struct.drop", _drop_dt)
def _struct_drop(ctx, args, opts):
    v = args[0]
    drop = set(opts["names"])
    keep = [(f, c) for f, c in zip(v.dtype.fields, v.child) if f.name not in drop]
    return v.with_(dtype=dt.Struct([(f.name, f.dtype) for f, _ in keep]), child=tuple(c for _, c in keep))


def _with_fields_dt(dts, opts):
    from polars_tpu_torch.core.schema import Schema
    from polars_tpu_torch.plan import exprs as E
    from polars_tpu_torch.plan.schema_resolve import expr_dtype

    d = dts[0]
    if not isinstance(d, dt.Struct):
        raise InvalidOperationError(f"struct.with_fields needs a Struct, got {d!r}")
    fields = {f.name: f.dtype for f in d.fields}
    schema = Schema(list(fields.items()))
    for node in opts["exprs"]:
        fields[E.output_name(node) or "literal"] = expr_dtype(node, schema)
    return dt.Struct(list(fields.items()))


@register("struct.with_fields", _with_fields_dt)
def _struct_with_fields(ctx, args, opts):
    """Fields added or replaced, each an expression over the struct's
    fields (``pl.field``) evaluated per row."""
    from polars_tpu_torch.engine.compiler import eval_expr
    from polars_tpu_torch.plan import exprs as E

    v = args[0]
    n = v.values.shape[0]
    cols = {f.name: struct_field(v.with_(validity=None), f.name).with_(domain=ROW) for f in v.dtype.fields}
    sub = EvalCtx(cols=dict(cols), rowmask=torch.ones(n, dtype=torch.bool, device=v.values.device), memo={},
                  flags=ctx.flags)
    for node in opts["exprs"]:
        r = eval_expr(node, sub)
        if r.domain == SCALAR:
            r = r.with_(values=r.values.expand(n), validity=None if r.validity is None else r.validity.expand(n))
        cols[E.output_name(node) or "literal"] = r.with_(domain=ROW)
    out_dt = _with_fields_dt([v.dtype], opts)
    return Val(_iota(n, v.values.device), v.validity, out_dt, None, v.domain,
               tuple(cols[f.name] for f in out_dt.fields))


def struct_equal(op: str, a: Val, b: Val) -> Val:
    """``==``/``!=`` of two structs: every field equal (a null field equals
    a null field)."""
    from polars_tpu_torch.engine.compiler import compare_vals

    if [f.name for f in a.dtype.fields] != [f.name for f in b.dtype.fields]:
        raise InvalidOperationError(f"cannot compare structs {a.dtype!r} and {b.dtype!r}")
    out = None
    for f in a.dtype.fields:
        x, y = struct_field(a.with_(validity=None), f.name), struct_field(b.with_(validity=None), f.name)
        eq = compare_vals("eq_missing", x, y)
        out = eq.values if out is None else out & eq.values
    dom = a.domain if a.domain != SCALAR else b.domain
    if op == "!=":
        out = ~out
    return Val(out, combine_validity(a.validity, b.validity), dt.Boolean(), None, dom)


def list_equal(op: str, a: Val, b: Val, dom: str) -> Val:
    """``==``/``!=`` of two List or Array values by their content (a null
    element equals a null element): both ranked together over one child
    (``kernels/nested_keys.joint_words``); null where either side is."""
    from polars_tpu_torch.kernels.nested_keys import joint_words
    from polars_tpu_torch.plan.schema_resolve import supertype

    ra, rb = joint_words([a, b], supertype(a.dtype, b.dtype))
    out = None
    for x, y in zip(ra, rb):
        eq = x == y
        out = eq if out is None else out & eq
    if op == "!=":
        out = ~out
    validity = combine_validity(a.validity, b.validity)
    if validity is not None and validity.shape != out.shape:
        validity = validity.expand(out.shape)
    return Val(out, validity, dt.Boolean(), None, dom)


def on_one_child(vals: list[Val]) -> list[Val]:
    """Nested values of one dtype over one child, so that a row of any of
    them can take another's place (when/then, coalesce, a shift's fill):
    where their children differ, the children one after another and each
    value's words shifted past those before it. A value without a child
    (a null literal) has no valid row and takes the shared one."""
    kids = [v.child for v in vals if v.child is not None]
    if all(k is kids[0] for k in kids):
        return [v.with_(child=kids[0] if kids else None) for v in vals]
    held = [v for v in vals if v.child is not None]
    both = concat_nested([v.with_(domain=ROW) for v in held], held[0].dtype)
    out, at = [], 0
    for v in vals:
        if v.child is None:
            out.append(v.with_(child=both.child))
            continue
        n = v.values.shape[0]
        out.append(v.with_(values=both.values[at:at + n], child=both.child))
        at += n
    return out


def concat_nested(vals: list[Val], target: dt.DataType) -> Val:
    """Nested row values one after another (a vertical concat): the
    children are concatenated, each piece's words shifted by the children
    before it (a Struct's ids likewise, field by field)."""
    from polars_tpu_torch.engine.strings import concat_vals

    validity = None
    if any(v.validity is not None for v in vals):
        validity = torch.cat([_ok(v) for v in vals])
    if isinstance(target, dt.Struct):
        shifted, base = [], 0
        for v in vals:
            shifted.append(v.values.to(torch.int64) + base)
            base += v.child[0].values.shape[0] if v.child else 0
        fields = tuple(concat_vals([v.child[i] for v in vals], f.dtype) for i, f in enumerate(target.fields))
        return Val(torch.cat(shifted), validity, target, None, ROW, fields)
    shifted, base = [], 0
    for v in vals:
        starts, lens = unpack(v.values)
        shifted.append(pack(starts + base, lens))
        base += v.child.values.shape[0]
    return Val(torch.cat(shifted), validity, target, None, ROW, concat_vals([v.child for v in vals], target.inner))

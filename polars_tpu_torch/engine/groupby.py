"""Group machinery: key -> group-id assignment + segmented reductions (the
port of ``polars_tpu/engine/groupby.py``).

The dense (perfect-hash) path maps dictionary-coded and bool keys to slots
of a small key domain, ranks the occupied slots and never sorts. The sorted
path (any other keys) sorts the rows by their order-encoded key words, marks
where a key differs from the previous row and numbers the groups in key
order; its capacity is the row count. Group sums and counts go through
kernel K1 (``kernels/groupagg.py``), and so do the boundaries that
``n_unique`` counts after a sort, the two passes of ``var`` and ``std``,
``any`` and ``all`` (counts of true and false rows) and the group sizes
that place ``median`` and ``quantile`` in a sort by (group, value); min/max
and the first and last rows use ``Tensor.scatter_reduce``, as the JAX
package has no kernel for them, and an integer ``product`` multiplies
exactly in a segmented scan (:func:`seg_prod`). The
only data-dependent value, ``num_groups``, stays on the device until the
segment's compaction.
"""

from __future__ import annotations

import torch

from polars_tpu_torch.engine.cast import float_values, order_word
from polars_tpu_torch.engine.common import GroupCtx, Val
from polars_tpu_torch.kernels.argsort import boundaries_from_words, key_words, stable_argsort_words
from polars_tpu_torch.kernels.nested_keys import val_words
from polars_tpu_torch.kernels.fastmath import div_any
from polars_tpu_torch.kernels.groupagg import groupagg_sums


def _big(dtype: torch.dtype):
    if dtype == torch.bool:
        return True
    if dtype.is_floating_point:
        return float("inf")
    return torch.iinfo(dtype).max


def _small(dtype: torch.dtype):
    if dtype == torch.bool:
        return False
    if dtype.is_floating_point:
        return float("-inf")
    return torch.iinfo(dtype).min


# ---------------------------------------------------------------------------
# group id assignment
# ---------------------------------------------------------------------------


def dense_group_ctx(keys: list[Val], rowmask: torch.Tensor, sizes: list[int]) -> GroupCtx:
    """Perfect-hash grouping for small dictionary-coded key domains.

    ``sizes[i]`` is the exclusive upper bound of key i's code (+1 slot for
    null). Capacity = prod(sizes[i] + 1); the caller bounds it.
    """
    cap = 1
    gid = torch.zeros(rowmask.shape, dtype=torch.int32, device=rowmask.device)
    for k, size in zip(keys, sizes):
        code = k.values.to(torch.int32) + 1  # 0 reserved for null
        if k.validity is not None:
            code = torch.where(k.validity, code, 0)
        gid = gid * (size + 1) + code.clamp(0, size)
        cap *= size + 1
    # occupied slots (one K1 count pass), ranked to dense group ids
    slot_counts = seg_count(rowmask, gid, cap)
    occupied = slot_counts > 0
    rank = torch.cumsum(occupied, 0, dtype=torch.int32) - 1
    num_groups = rank[-1] + 1
    dense_gid = rank.index_select(0, gid)
    group_valid = torch.arange(cap, device=rowmask.device) < num_groups
    # slot of each dense group: occupied slots first, in slot order
    slots = torch.argsort((~occupied).to(torch.int8), stable=True)
    return GroupCtx(
        gids=dense_gid,
        num_groups=num_groups,
        capacity=cap,
        group_valid=group_valid,
        counts=slot_counts.index_select(0, slots),  # the row counts, kept for len/count/mean
        slots=slots,
    )


def one_group_ctx(rowmask: torch.Tensor) -> GroupCtx:
    """Every row in group 0 of capacity 1: aggregations outside a group-by
    (the JAX package's ``_group_of``), so that K1 sums them as it sums a
    group-by's."""
    dev = rowmask.device
    return GroupCtx(
        gids=torch.zeros(rowmask.shape, dtype=torch.int32, device=dev),
        num_groups=torch.ones((), dtype=torch.int32, device=dev),
        capacity=1,
        group_valid=torch.ones(1, dtype=torch.bool, device=dev),
    )


def sorted_group_ctx(keys: list[Val], rowmask: torch.Tensor) -> GroupCtx:
    """Sort-based grouping over order-encoded key words: rows outside the
    mask sort last, nulls first within a key. Groups are numbered in key
    order; capacity is the row count.

    A key without nulls contributes no null word (a constant word does not
    change the stable sort or the boundaries), and a null key's value word is
    zeroed, so that all its nulls form one group whatever lies under them."""
    n = rowmask.shape[0]
    words: list[torch.Tensor] = [(~rowmask).to(torch.int8)]  # masked rows last
    for k in keys:
        kw = val_words(k)
        if k.validity is not None:
            words.append((~k.validity).to(torch.int8))  # nulls first
            kw = [torch.where(k.validity, w, torch.zeros((), dtype=w.dtype, device=w.device)) for w in kw]
        words.extend(kw)
    perm = stable_argsort_words(words)
    valid_sorted = rowmask.index_select(0, perm)
    boundary = valid_sorted & boundaries_from_words(words[1:], perm)
    # rows outside the mask (sorted last) keep their own position as id:
    # never a group's, and spread over the slots for the scatters that
    # read every row
    pos = torch.arange(n, dtype=torch.int32, device=rowmask.device)
    gid_sorted = torch.where(valid_sorted, torch.cumsum(boundary, 0, dtype=torch.int32) - 1, pos)
    num_groups = boundary.sum(dtype=torch.int32)
    gids = torch.empty(n, dtype=torch.int32, device=rowmask.device).index_copy_(0, perm, gid_sorted)
    return GroupCtx(
        gids=gids,
        num_groups=num_groups,
        capacity=n,
        group_valid=torch.arange(n, device=rowmask.device) < num_groups,
        sort_perm=perm,
    )


def reorder_by_first_occurrence(ctx: GroupCtx, rowmask: torch.Tensor) -> GroupCtx:
    """Renumber the groups by their first row (``maintain_order=True``);
    per-group tables the context carries are permuted alike."""
    cap = ctx.capacity
    first_row, has = seg_first_idx(rowmask, ctx.gids, cap)
    first_row = torch.where(has, first_row, 2**31 - 1)
    order = stable_argsort_words([first_row])  # new id -> old id; empty slots last
    inv = torch.empty(cap, dtype=torch.int32, device=rowmask.device).index_copy_(
        0, order, torch.arange(cap, dtype=torch.int32, device=rowmask.device)
    )
    return GroupCtx(
        gids=inv.index_select(0, ctx.gids.clamp(0, cap - 1)),  # ids of masked rows are never read
        num_groups=ctx.num_groups,
        capacity=cap,
        group_valid=ctx.group_valid,
        counts=None if ctx.counts is None else ctx.counts.index_select(0, order),
        slots=None if ctx.slots is None else ctx.slots.index_select(0, order),
    )


def group_counts(ctx: GroupCtx, rowmask: torch.Tensor) -> torch.Tensor:
    """Rows per group (int64), from one K1 count pass on first use."""
    if ctx.counts is None:
        ctx.counts = seg_count(rowmask, ctx.gids, ctx.capacity)
    return ctx.counts


# ---------------------------------------------------------------------------
# segmented reductions (GroupedReduction analogue, polars-expr/src/reduce/)
# ---------------------------------------------------------------------------


def _k1(gids: torch.Tensor, columns: list, mask: torch.Tensor, cap: int, acc: torch.dtype) -> torch.Tensor:
    """K1's (cap, k) sums; a group-by over no rows (capacity 0) has no
    group, and K1 takes capacity >= 1."""
    if cap == 0:
        return torch.zeros((0, len(columns)), dtype=acc, device=gids.device)
    return groupagg_sums(gids, columns, mask, cap)


def seg_sum(values: torch.Tensor, mask: torch.Tensor, gids: torch.Tensor, cap: int) -> torch.Tensor:
    """Per-group sum of ``values`` over ``mask``, in the input dtype (floats
    accumulate in f64, integers in i64 and wrap back like a native sum)."""
    acc = torch.float64 if values.dtype.is_floating_point else torch.int64
    return _k1(gids, [values.to(acc).contiguous()], mask, cap, acc)[:, 0].to(values.dtype)


def seg_sums(columns: list[torch.Tensor], mask: torch.Tensor, gids: torch.Tensor, cap: int) -> torch.Tensor:
    """(cap, k) per-group f64 sums of several f64 columns over ``mask``: one
    K1 call."""
    return _k1(gids, [c.contiguous() for c in columns], mask, cap, torch.float64)


def seg_count(mask: torch.Tensor, gids: torch.Tensor, cap: int) -> torch.Tensor:
    """Per-group count of ``mask`` rows, int64."""
    return _k1(gids, [None], mask, cap, torch.int64)[:, 0]


# up to this many groups, a min or max reduces each group by itself.
# ``testing/bench_minmax.py`` times both ways on an H100 (PERF.md): over
# 120M rows the loop costs 1.2 ms a group whatever the data; the scatter
# takes 51 ms at 64 slots on random f64 values but 1.2 s on a rising row
# number (5.0 s at 6 slots), whose every atomic changes its slot. At 64 the
# loop is at worst 1.5x the scatter's time; at 128, 2.3x.
_FEW_GROUPS = 64


def _scatter_extreme(x: torch.Tensor, gids: torch.Tensor, mask: torch.Tensor, cap: int, reduce: str, ident):
    """Per-group ``reduce`` of ``x``; callers put ``ident`` in the rows outside
    ``mask``, so those rows may land in any slot: their ids are only clamped
    into range, not sent to one slot, whose atomics would serialize. A few
    groups (a select's one group, a dense group-by of up to ``_FEW_GROUPS``)
    reduce one by one, for the same reason (see ``_FEW_GROUPS``)."""
    work = x.to(torch.uint8) if x.dtype == torch.bool else x
    if cap <= _FEW_GROUPS and work.shape[0]:
        return extreme_per_group(work, gids, cap, reduce, ident).to(x.dtype)
    return extreme_by_scatter(work, gids, cap, reduce, ident).to(x.dtype)


def extreme_per_group(work: torch.Tensor, gids: torch.Tensor, cap: int, reduce: str, ident) -> torch.Tensor:
    """``reduce`` of each group by a full reduction of its own (``cap`` passes
    over the rows, no atomics); ``work`` has at least one row."""
    pick = torch.amax if reduce == "amax" else torch.amin
    if cap == 1:
        return pick(work).reshape(1)
    fill = torch.full((), ident, dtype=work.dtype, device=work.device)
    ids = gids.clamp(0, cap - 1)
    return torch.stack([pick(torch.where(ids == g, work, fill)) for g in range(cap)])


def extreme_by_scatter(work: torch.Tensor, gids: torch.Tensor, cap: int, reduce: str, ident) -> torch.Tensor:
    """``reduce`` of each group in one ``scatter_reduce_`` pass (atomics into
    ``cap`` slots)."""
    out = torch.full((cap,), ident, dtype=work.dtype, device=work.device)
    return out.scatter_reduce_(0, gids.clamp(0, cap - 1).long(), work, reduce, include_self=True)


def seg_min(values: torch.Tensor, mask: torch.Tensor, gids: torch.Tensor, cap: int) -> torch.Tensor:
    big = _big(values.dtype)
    x = torch.where(mask, values, big)
    if values.dtype.is_floating_point:
        # NaN is greatest (total order): never the min unless the group is all-NaN
        x = torch.where(torch.isnan(x), big, x)
    return _scatter_extreme(x, gids, mask, cap, "amin", big)


def seg_max(values: torch.Tensor, mask: torch.Tensor, gids: torch.Tensor, cap: int) -> torch.Tensor:
    small = _small(values.dtype)
    x = torch.where(mask, values, small)
    if not values.dtype.is_floating_point:
        return _scatter_extreme(x, gids, mask, cap, "amax", small)
    # NaN is greatest: a group containing NaN has max NaN
    has_nan = seg_count(mask & torch.isnan(values), gids, cap) > 0
    x = torch.where(torch.isnan(x), small, x)
    out = _scatter_extreme(x, gids, mask, cap, "amax", small)
    return torch.where(has_nan, float("nan"), out)


def seg_extreme(kind: str, v: Val, mask: torch.Tensor, gids: torch.Tensor, cap: int) -> torch.Tensor:
    """Per-group ``"min"`` or ``"max"`` of a value in its logical order:
    UInt64 bit patterns reduce with their sign bit flipped, and flip back."""
    fn = seg_min if kind == "min" else seg_max
    return order_word(fn(order_word(v.values, v.dtype), mask, gids, cap), v.dtype)


def seg_first_idx(mask: torch.Tensor, gids: torch.Tensor, cap: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(row index of the first masked row per group, has_any mask)."""
    big = 2**31 - 1
    iota = torch.arange(mask.shape[0], dtype=torch.int32, device=mask.device)
    idx = _scatter_extreme(torch.where(mask, iota, big), gids, mask, cap, "amin", big)
    has = idx != big
    return torch.where(has, idx, 0), has


def seg_last_idx(mask: torch.Tensor, gids: torch.Tensor, cap: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(row index of the last masked row per group, has_any mask)."""
    iota = torch.arange(mask.shape[0], dtype=torch.int32, device=mask.device)
    idx = _scatter_extreme(torch.where(mask, iota, -1), gids, mask, cap, "amax", -1)
    has = idx >= 0
    return torch.where(has, idx, 0), has


def seg_nunique(v: Val, mask: torch.Tensor, gids: torch.Tensor, cap: int) -> torch.Tensor:
    """Distinct values per group (int64), nulls counting as one value: one
    stable sort by (group, null, key words), whose boundaries K1 counts per
    group. Rows outside ``mask`` take group ``cap``, sort last and count
    nowhere; the key words under a null are zeroed, so that all nulls of a
    group are one value whatever lies under them (the JAX package counts
    nulls of different storage apart, ROADMAP §3)."""
    g = torch.where(mask, gids, cap)
    words = [g]
    kw = val_words(v)
    if v.validity is not None:
        words.append((~v.validity).to(torch.int8))
        kw = [torch.where(v.validity, w, torch.zeros((), dtype=w.dtype, device=w.device)) for w in kw]
    words.extend(kw)
    perm = stable_argsort_words(words)
    gs = g.index_select(0, perm).contiguous()
    boundary = (gs < cap) & boundaries_from_words(words, perm)
    return seg_count(boundary, gs, cap)


def seg_mean(values: torch.Tensor, mask: torch.Tensor, gids: torch.Tensor, cap: int):
    """(per-group mean, has_any): f64 unless the input is f32."""
    acc_t = torch.float32 if values.dtype == torch.float32 else torch.float64
    s = seg_sum(values.to(acc_t), mask, gids, cap)
    c = seg_count(mask, gids, cap)
    return div_any(s, c.clamp(min=1).to(acc_t)), c > 0


def seg_var(values: torch.Tensor, mask: torch.Tensor, gids: torch.Tensor, cap: int, ddof: int):
    """(per-group variance, defined): two passes, the mean first and then
    the squares of the differences from it (the JAX package's form; one
    pass of sums of squares loses digits). Two K1 sums and one K1 count;
    f64 unless the input is f32. Defined where the group has more than
    ``ddof`` values."""
    acc = torch.float32 if values.dtype == torch.float32 else torch.float64
    v = values.to(acc)
    c = seg_count(mask, gids, cap)
    mean = div_any(seg_sum(v, mask, gids, cap), c.clamp(min=1).to(acc))
    centered = v - mean.index_select(0, gids.clamp(0, cap - 1).long())
    ss = seg_sum(torch.where(mask, centered * centered, torch.zeros((), dtype=acc, device=v.device)), mask, gids, cap)
    return div_any(ss, (c - ddof).clamp(min=1).to(acc)), (c - ddof) > 0


def seg_any(values: torch.Tensor, mask: torch.Tensor, gids: torch.Tensor, cap: int) -> torch.Tensor:
    """Per group: some ``mask`` row is true (a K1 count)."""
    return seg_count(mask & values, gids, cap) > 0


def seg_all(values: torch.Tensor, mask: torch.Tensor, gids: torch.Tensor, cap: int) -> torch.Tensor:
    """Per group: no ``mask`` row is false (a K1 count)."""
    return seg_count(mask & ~values, gids, cap) == 0


def seg_quantile(v: Val, mask: torch.Tensor, gids: torch.Tensor, cap: int, q: float, interpolation: str):
    """(per-group quantile ``q`` as f64, has_any): :func:`seg_quantiles` of
    one ``q``."""
    out, has = seg_quantiles(v, mask, gids, cap, [q], interpolation)
    return out[:, 0], has


def seg_quantiles(v: Val, mask: torch.Tensor, gids: torch.Tensor, cap: int, qs: list[float], interpolation: str):
    """((cap, len(qs)) per-group quantiles as f64, has_any): one stable sort
    by (group, value), NaN greatest, with the rows outside ``mask`` last;
    each group's run starts at the sum of the sizes before it (K1 counts),
    and the interpolation picks or blends the values at the positions
    ``(n-1) * q`` rounds to (``nearest`` rounds half to even, as the JAX
    package does)."""
    n = mask.shape[0]
    counts = seg_count(mask, gids, cap)
    if n == 0:
        return torch.zeros((cap, len(qs)), dtype=torch.float64, device=mask.device), counts > 0
    g = torch.where(mask, gids, cap)
    perm = stable_argsort_words([g, *key_words(v.values, v.dtype)])
    ordered = float_values(v.values.index_select(0, perm), v.dtype, torch.float64)
    offsets = (torch.cumsum(counts, 0) - counts).unsqueeze(1)
    c = counts.clamp(min=1).unsqueeze(1)
    pos = (c - 1).to(torch.float64) * torch.tensor(qs, dtype=torch.float64, device=mask.device)

    def at(k: torch.Tensor) -> torch.Tensor:
        return ordered.index_select(0, (offsets + k.to(torch.int64)).clamp(0, n - 1).reshape(-1)).reshape(k.shape)

    if interpolation == "nearest":
        out = at(torch.round(pos))
    elif interpolation == "lower":
        out = at(torch.floor(pos))
    elif interpolation == "higher":
        out = at(torch.ceil(pos))
    elif interpolation == "midpoint":
        out = (at(torch.floor(pos)) + at(torch.ceil(pos))) * 0.5
    else:  # linear
        lo_i = torch.floor(pos)
        lo, hi = at(lo_i), at(torch.minimum(lo_i + 1, (c - 1).to(torch.float64)))
        out = lo + (hi - lo) * (pos - lo_i)
    return out, counts > 0


def seg_prod(values: torch.Tensor, mask: torch.Tensor, gids: torch.Tensor, cap: int) -> torch.Tensor:
    """Per-group product of ``values`` (int64, wrapping as a native integer
    product, or f64 with IEEE's rules: inf * 0 is NaN); 1 for an empty
    group. A few groups multiply one by one; more groups sort by group and
    run a segmented scan in log2(rows) doubling steps, whose last row per
    group is its product. No host read."""
    one = torch.ones((), dtype=values.dtype, device=values.device)
    x = torch.where(mask, values, one)
    if cap <= _FEW_GROUPS:
        if cap == 1:
            return torch.prod(x).reshape(1)
        ids = gids.clamp(0, cap - 1)
        return torch.stack([torch.prod(torch.where(ids == g, x, one)) for g in range(cap)])
    n = x.shape[0]
    g = torch.where(mask, gids, cap)
    perm = stable_argsort_words([g])
    gs, xs = g.index_select(0, perm), x.index_select(0, perm)
    step = 1
    while step < n:
        nxt = xs.clone()
        nxt[step:] = torch.where(gs[step:] == gs[:-step], xs[step:] * xs[:-step], xs[step:])
        xs, step = nxt, step * 2
    counts = seg_count(mask, gids, cap)
    last = (torch.cumsum(counts, 0) - 1).clamp(0, max(n - 1, 0))
    picked = xs.index_select(0, last) if n else torch.ones(cap, dtype=values.dtype, device=values.device)
    return torch.where(counts > 0, picked, one)

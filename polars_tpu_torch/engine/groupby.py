"""Group machinery: key -> group-id assignment + segmented reductions (the
port of ``polars_tpu/engine/groupby.py``).

The dense (perfect-hash) path maps dictionary-coded and bool keys to slots
of a small key domain, ranks the occupied slots and never sorts. The sorted
path (any other keys) sorts the rows by their order-encoded key words, marks
where a key differs from the previous row and numbers the groups in key
order; its capacity is the row count. Group sums and counts go through
kernel K1 (``kernels/groupagg.py``); min/max and first rows use
``Tensor.scatter_reduce``, as the JAX package has no kernel for them. The
only data-dependent value, ``num_groups``, stays on the device until the
segment's compaction.
"""

from __future__ import annotations

import torch

from polars_tpu_torch.engine.cast import order_word
from polars_tpu_torch.engine.common import GroupCtx, Val
from polars_tpu_torch.kernels.argsort import boundaries_from_words, key_words, stable_argsort_words
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
        kw = key_words(k.values, k.dtype)
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


def seg_sum(values: torch.Tensor, mask: torch.Tensor, gids: torch.Tensor, cap: int) -> torch.Tensor:
    """Per-group sum of ``values`` over ``mask``, in the input dtype (floats
    accumulate in f64, integers in i64 and wrap back like a native sum)."""
    acc = torch.float64 if values.dtype.is_floating_point else torch.int64
    return groupagg_sums(gids, [values.to(acc).contiguous()], mask, cap)[:, 0].to(values.dtype)


def seg_count(mask: torch.Tensor, gids: torch.Tensor, cap: int) -> torch.Tensor:
    """Per-group count of ``mask`` rows, int64."""
    return groupagg_sums(gids, [None], mask, cap)[:, 0]


def _scatter_extreme(x: torch.Tensor, gids: torch.Tensor, mask: torch.Tensor, cap: int, reduce: str, ident):
    """Per-group ``reduce`` of ``x``; callers put ``ident`` in the rows outside
    ``mask``, so those rows may land in any slot: their ids are only clamped
    into range, not sent to one slot, whose atomics would serialize. One
    group (a select's min or max) is a plain reduction for the same reason."""
    work = x.to(torch.uint8) if x.dtype == torch.bool else x
    if cap == 1 and work.shape[0]:
        return (work.amax() if reduce == "amax" else work.amin()).reshape(1).to(x.dtype)
    idx = gids.clamp(0, cap - 1).long()
    out = torch.full((cap,), ident, dtype=work.dtype, device=x.device)
    out.scatter_reduce_(0, idx, work, reduce, include_self=True)
    return out.to(x.dtype)


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


def seg_mean(values: torch.Tensor, mask: torch.Tensor, gids: torch.Tensor, cap: int):
    """(per-group mean, has_any): f64 unless the input is f32."""
    acc_t = torch.float32 if values.dtype == torch.float32 else torch.float64
    s = seg_sum(values.to(acc_t), mask, gids, cap)
    c = seg_count(mask, gids, cap)
    return div_any(s, c.clamp(min=1).to(acc_t)), c > 0

"""Expression evaluator: AST node -> tensors (the port of
``polars_tpu/engine/compiler.py``'s ``eval_expr``, trimmed to columns,
literals (numeric, bool, null, temporal, Decimal and string; lists as
literal Series), casts, arithmetic (temporal arithmetic on integer epochs,
as the JAX package's ``_arith`` and ``_temporal_pair``; Decimal in scaled
int64, rounded half to even) and comparison with Polars
type promotion, string comparison across dictionaries, Kleene ``&``/``|``, when/then/otherwise,
registered functions (``engine/registry.py``), aliases, the aggregations,
per group or, outside a group-by, over one group of capacity 1, windows
(``over``) and the expression-level sort, sort_by, filter, slice and
gather).

A filter or slice under an aggregation narrows the rows it sees
(:func:`_agg_input`); outside one, it and a gather change the column's
length, and a select evaluates such a column as a *piece*
(:func:`eval_piece`): its values over some row space with the mask of the
rows it keeps.

Where the JAX package traces into one XLA program, the port runs each op
eagerly on the tensors of the segment; ``Val.domain`` still tracks per-row,
per-group and scalar values.
"""

from __future__ import annotations

import dataclasses
import decimal as _decimal
import math

import numpy as np
import torch

from polars_tpu_torch import datatypes as dt
from polars_tpu_torch.engine import fn_position as P
from polars_tpu_torch.engine import groupby as G
from polars_tpu_torch.engine.cast import cast_val, float_values, int_scalar, order_word, wrap_unsigned
from polars_tpu_torch.engine.common import (
    GROUP, ROW, SCALAR, SERIES, EvalCtx, GroupCtx, Val, broadcast_pair, col_to_val, combine_validity, empty_child,
    flag_rows, reject_series, take_lut,
)
from polars_tpu_torch.engine.registry import get_spec
from polars_tpu_torch.engine.strings import ensure_ordinal_val, unify_vals
from polars_tpu_torch.errors import ColumnNotFoundError, ComputeError, InvalidOperationError, ShapeError
from polars_tpu_torch.kernels.argsort import stable_argsort_words
from polars_tpu_torch.kernels.fastmath import div_any, floordiv_any, floordiv_u64, mod_any, mod_u64
from polars_tpu_torch.plan import exprs as E
from polars_tpu_torch.plan.schema_resolve import binary_dtype, dyn_literal_value, fit_dyn_dtype, supertype
from polars_tpu_torch.utils import strtable

_CMP = {"==", "!=", "<", "<=", ">", ">="}


def eval_expr(node: E.ENode, ctx: EvalCtx) -> Val:
    if isinstance(node, E.EColumn):
        try:
            return ctx.cols[node.name]
        except KeyError:
            raise ColumnNotFoundError(f"{node.name!r} not found; available: {list(ctx.cols)}") from None
    if ctx.precomputed is not None and node in ctx.precomputed:
        return ctx.precomputed[node]
    # common-subexpression memo: structurally equal subtrees evaluate once
    if ctx.memo is not None and node in ctx.memo:
        return ctx.memo[node]
    val = _eval_expr_uncached(node, ctx)
    if ctx.memo is not None:
        ctx.memo[node] = val
    return val


def _eval_expr_uncached(node: E.ENode, ctx: EvalCtx) -> Val:
    if isinstance(node, E.ELiteral):
        return _eval_literal(node, ctx)
    if isinstance(node, E.ESeriesLit):
        return _eval_series_literal(node, ctx)
    if isinstance(node, E.EAlias):
        return eval_expr(node.input, ctx)
    if isinstance(node, E.ECast):
        return _eval_cast(node, ctx)
    if isinstance(node, E.EBinary):
        return _eval_binary(node, ctx)
    if isinstance(node, E.ETernary):
        return _eval_ternary(node, ctx)
    if isinstance(node, E.EAgg):
        return _eval_agg(node, ctx)
    if isinstance(node, E.ELen):
        return Val(G.group_counts(group_of(ctx), ctx.rowmask), None, dt.UInt32(), None, _agg_domain(ctx))
    if isinstance(node, E.EFunction):
        spec = get_spec(node.name)
        args = [eval_expr(i, ctx) for i in node.inputs]
        if len(args) > 1:
            args = _adapt_dyn_literal_vals(node.inputs, args)
        return spec.impl(ctx, args, dict(node.options))
    if isinstance(node, E.EWindow):
        return _eval_window(node, ctx)
    if isinstance(node, E.ESort):
        v = eval_expr(node.input, ctx)
        return P.reorder_in_groups(ctx, v, [(P.row_domain(ctx, v), node.descending, node.nulls_last)])
    if isinstance(node, E.ESortBy):
        keys = [P.row_domain(ctx, eval_expr(b, ctx)) for b in node.by]
        return P.reorder_in_groups(ctx, eval_expr(node.input, ctx), list(zip(keys, node.descending, node.nulls_last)))
    if isinstance(node, E.EGather) and ctx.groups is None:
        v, keep = eval_piece(node, ctx)
        if keep is None:
            return v
    if isinstance(node, E.EGather):
        return _gather_in_groups(node, ctx)
    if isinstance(node, (E.EFilter, E.ESlice)):
        raise InvalidOperationError(
            f"{type(node).__name__[1:].lower()} changes the length of its column: it applies in a select or under "
            "an aggregation")
    raise InvalidOperationError(f"cannot evaluate {type(node).__name__}")


# ---------------------------------------------------------------------------
# columns of another length (select context)
# ---------------------------------------------------------------------------


def _group_sources(ctx: EvalCtx, idx: Val) -> tuple[torch.Tensor, torch.Tensor]:
    """(for each row, the row its group's gather reads there; where it takes
    part). Per-row indices: each kept row's own index, within its group
    (negative from the group's end), a null index a null element. A literal
    of m indices: the k-th row of a group in group order takes the k-th
    index, and the rows past m take no part. An index past its group's end
    fails the segment at its count read."""
    o = P.group_order(ctx)
    n = o.n
    pos = torch.arange(n, dtype=torch.int64, device=ctx.device) - o.start
    size = o.end - o.start + 1
    if idx.domain == ROW:
        i = o.to_group(idx.values.to(torch.int64))
        ok = o.kept if idx.validity is None else o.kept & o.to_group(idx.validity)
    else:
        lit = idx.values.reshape(-1).to(torch.int64)
        m = lit.shape[0]
        at = pos.clamp(0, max(m - 1, 0))
        i = lit.index_select(0, at) if m else pos
        ok = o.kept & (pos < m)
        if idx.validity is not None and m:
            ok = ok & idx.validity.reshape(-1).index_select(0, at)
    i = torch.where(i < 0, i + size, i)
    ctx.add_flag((ok & ((i < 0) | (i >= size))).any(), "gather indices are out of bounds", ComputeError)
    src = o.perm.index_select(0, torch.minimum(o.start + i.clamp(min=0), o.end).clamp(0, max(n - 1, 0))) \
        if n else pos
    return o.to_rows(src), o.to_rows(ok)


def _gathered(v: Val, src: torch.Tensor, ok: torch.Tensor) -> Val:
    """``v`` at the rows ``src``, null where ``ok`` does not hold."""
    if v.values.shape[0] == 0:
        return v.with_(values=v.values.new_zeros(src.shape[0]), validity=torch.zeros_like(ok), domain=ROW)
    validity = ok if v.validity is None else ok & v.validity.index_select(0, src)
    return v.with_(values=v.values.index_select(0, src), validity=validity, domain=ROW)


def _gather_in_groups(node: E.EGather, ctx: EvalCtx) -> Val:
    """A gather in each group: in a group-by, a List per group of its rows
    at the indices (negative from the group's end), in the group's row
    order; in a window, one index gives each group's value at it, which
    its rows take, and per-row indices or several indices (as many as the
    group's rows) give each row its own. An index past a group's end fails
    the segment at its count read."""
    from polars_tpu_torch.engine.fn_nested import pack

    v = P.row_domain(ctx, eval_expr(node.input, ctx))
    idx = eval_expr(node.indices, ctx)
    g = ctx.groups
    if idx.domain == ROW or (ctx.in_window and idx.domain == SERIES):
        if ctx.in_window and idx.domain == SERIES:
            o = P.group_order(ctx)
            live = o.to_rows(o.kept)
            ctx.add_flag((live & (o.to_rows(o.end - o.start + 1) != idx.values.shape[0])).any(),
                         "the length of the window expression did not match that of the group", ComputeError)
        src, ok = _group_sources(ctx, idx)
        out = _gathered(v, src, ok)
        if ctx.in_window:
            return out
        # a List per group: the group's rows in group order, each its gather
        o = P.group_order(ctx)
        counts = G.group_counts(g, ctx.rowmask)
        child = out.with_(values=o.to_group(out.values), validity=o.to_group(out.validity))
        return Val(pack(torch.cumsum(counts, 0) - counts, counts), None, dt.List(v.dtype), None, GROUP, child)
    o = P.group_order(ctx)
    counts = G.group_counts(g, ctx.rowmask)
    cap, dev = g.capacity, ctx.device
    i = idx.values.reshape(-1).to(torch.int64)
    m = i.shape[0]
    first = torch.cumsum(counts, 0) - counts  # each group's first slot in group order
    at = i.reshape(1, -1).expand(cap, m)
    at = torch.where(at < 0, at + counts.reshape(-1, 1), at)
    bad = ((at < 0) | (at >= counts.reshape(-1, 1))).any(dim=1) & g.group_valid
    ctx.add_flag(bad.any(), "gather indices are out of bounds", ComputeError)
    slots = (first.reshape(-1, 1) + at.clamp(min=0)).reshape(-1).clamp(0, max(o.n - 1, 0))
    rows = o.perm.index_select(0, slots) if o.n else slots
    child = v.with_(values=v.values.index_select(0, rows) if o.n else v.values.new_zeros(rows.shape[0]),
                    validity=None if v.validity is None else v.validity.index_select(0, rows), domain=ROW)
    if ctx.in_window:
        return child.with_(domain=GROUP)
    starts = torch.arange(cap, dtype=torch.int64, device=dev) * m
    return Val(pack(starts, torch.full((cap,), m, dtype=torch.int64, device=dev)), None, dt.List(v.dtype), None,
               GROUP, child)


def _sub_ctx(ctx: EvalCtx, rowmask: torch.Tensor, known: dict) -> EvalCtx:
    """A context over the same rows and groups with another row mask, where
    the nodes of ``known`` have their values."""
    groups = ctx.groups
    if groups is not None and rowmask is not ctx.rowmask:
        # the cached counts and the numbering sort belong to the other mask
        groups = dataclasses.replace(groups, counts=None, sort_perm=None)
    cols = {**ctx.cols, **{c.name: v for c, v in known.items() if isinstance(c, E.EColumn)}}
    return EvalCtx(cols=cols, rowmask=rowmask, groups=groups, precomputed=known, memo={}, flags=ctx.flags)


def _kept_positions(keep: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(the row of each rank among the kept rows, in rank order, then
    anything; the kept count as a (1,) tensor)."""
    n = keep.shape[0]
    rank = torch.cumsum(keep, 0) - 1
    pos = torch.zeros(n + 1, dtype=torch.int64, device=keep.device)
    pos.index_copy_(0, torch.where(keep, rank, n), torch.arange(n, device=keep.device))
    count = rank[-1:] + 1 if n else torch.zeros(1, dtype=torch.int64, device=keep.device)
    return pos[:n], count


def _to_prefix(v: Val, keep: torch.Tensor, rows: int) -> tuple[Val, torch.Tensor]:
    """``v``'s kept values moved to its first rows, padded to ``rows``; and
    their count."""
    pos, count = _kept_positions(keep)
    values = v.values.index_select(0, pos)
    validity = None if v.validity is None else v.validity.index_select(0, pos)
    pad = rows - values.shape[0]
    if pad:
        values = torch.cat([values, values.new_zeros(pad)])
        validity = None if validity is None else torch.cat([validity, validity.new_zeros(pad)])
    return v.with_(values=values, validity=validity, domain=ROW), count


def align_pieces(ctx: EvalCtx, pieces: list[tuple[Val, torch.Tensor | None]]):
    """Pieces of different row spaces or masks side by side: the r-th kept
    value of each is row r (scalars broadcast). Their counts must agree; a
    mismatch fails the segment at its count read. Gives (values, one mask)."""
    keeps = [k for _, k in pieces if k is not None]
    if not keeps:
        return [v for v, _ in pieces], None
    if all(k is keeps[0] for k in keeps):
        return [v for v, _ in pieces], keeps[0]
    rows = max(k.shape[0] for k in keeps)
    out, counts = [], []
    for v, k in pieces:
        if k is None:
            out.append(v)
            continue
        pv, c = _to_prefix(v, k, rows)
        out.append(pv)
        counts.append(c)
    for c in counts[1:]:
        ctx.add_flag((c != counts[0]).any(), "the columns of a select have different lengths", ComputeError)
    return out, torch.arange(rows, device=keeps[0].device) < counts[0]


def _as_piece(v: Val, ctx: EvalCtx) -> tuple[Val, torch.Tensor | None]:
    if v.domain == SCALAR:
        return v, None
    if v.domain == SERIES:  # a literal list: its own rows, all kept
        return v.with_(domain=ROW), torch.ones(v.values.shape[0], dtype=torch.bool, device=v.values.device)
    if v.domain != ROW:
        raise ShapeError("an aggregate where a column of another length is built")
    return v, ctx.rowmask


def eval_piece(node: E.ENode, ctx: EvalCtx) -> tuple[Val, torch.Tensor | None]:
    """``node`` in a select, where it may change its column's length: (its
    values over a row space, the mask of the rows it keeps there), or (a
    scalar, None). A filter narrows the mask; a slice keeps a window of the
    kept rows by rank; a gather reads the kept rows at the indices (an index
    out of range fails the segment at its count read), in the indices' row
    space. Any other node evaluates over its children's pieces, aligned by
    rank where they differ."""
    if not E.changes_length(node):
        return _as_piece(eval_expr(node, ctx), ctx)
    if isinstance(node, E.EFilter):
        v, keep = eval_piece(node.input, ctx)
        if keep is None:
            raise InvalidOperationError("filter() of a scalar")
        p = eval_expr(node.by, ctx)
        pv = p.values.to(torch.bool)
        if p.validity is not None:
            pv = pv & p.validity
        if p.domain not in (ROW, SCALAR) or pv.shape[0] not in (1, keep.shape[0]):
            raise ShapeError("filter(): the predicate's length differs from the column's")
        return v, keep & pv
    if isinstance(node, E.ESlice):
        v, keep = eval_piece(node.input, ctx)
        if keep is None:
            raise InvalidOperationError("slice of a scalar")
        rank = torch.cumsum(keep, 0)
        total = rank[-1:] if rank.shape[0] else torch.zeros(1, dtype=torch.int64, device=keep.device)
        start = (total + node.offset).clamp(min=0) if node.offset < 0 else total.clamp(max=node.offset)
        stop = total if node.length is None else torch.minimum(start + node.length, total)
        return v, keep & (rank > start) & (rank <= stop)
    if isinstance(node, E.EWindow):  # mapping_strategy="explode"
        return _window_explode(node, ctx)
    if isinstance(node, E.EFunction) and node.name == "explode":
        from polars_tpu_torch.engine.fn_nested import explode_piece

        v, keep = eval_piece(node.inputs[0], ctx)
        return explode_piece(v, keep)
    if isinstance(node, E.EGather):
        v, keep = eval_piece(node.input, ctx)
        idx, ikeep = eval_piece(node.indices, ctx)
        if keep is None:
            raise InvalidOperationError("gather from a scalar")
        if not (idx.dtype.is_integer() or isinstance(idx.dtype, dt.Null)):
            raise InvalidOperationError(f"gather indices must be integers, got {idx.dtype!r}")
        pos, count = _kept_positions(keep)
        i = idx.values.to(torch.int64)
        i = torch.where(i < 0, i + count, i)
        bad = (i < 0) | (i >= count)
        if idx.validity is not None:
            bad = bad & idx.validity
        ctx.add_flag((bad if ikeep is None else bad & ikeep).any(), "gather indices are out of bounds", ComputeError)
        rows = pos.index_select(0, i.clamp(0, max(pos.shape[0] - 1, 0))) if pos.shape[0] else i.clamp(0, 0)
        values = v.values.index_select(0, rows) if pos.shape[0] else v.values.new_zeros(i.shape[0])
        validity = combine_validity(None if v.validity is None else v.validity.index_select(0, rows), idx.validity)
        return v.with_(values=values, validity=validity, domain=idx.domain if ikeep is None else ROW), ikeep
    kids = node.children()
    pieces = [eval_piece(c, ctx) for c in kids]
    vals, keep = align_pieces(ctx, pieces)
    sub = _sub_ctx(ctx, ctx.rowmask if keep is None else keep, dict(zip(kids, vals)))
    return _as_piece(eval_expr(node, sub), sub)


# ---------------------------------------------------------------------------
# windows
# ---------------------------------------------------------------------------


def _eval_window(node: E.EWindow, ctx: EvalCtx) -> Val:
    """``function.over(partition_by, order_by=...)`` (the JAX package's
    ``_eval_window``): the function evaluated in the groups of the keys
    (null keys one group), in ``order_by`` order within a group; a group's
    value is gathered back to its rows, a per-row value keeps its row, a
    scalar broadcasts. The groups of one key tuple are made once per
    context, and so is the group order of one (keys, order) pair: windows
    over the same keys share their sorts."""
    if node.mapping_strategy == "explode":
        raise InvalidOperationError("over(mapping_strategy='explode') changes the column's length: it applies in "
                                    "a select")
    inner = _window_ctx(node, ctx)
    res = eval_expr(node.function, inner)
    reject_series(res)
    if node.mapping_strategy == "join":  # each row takes its group's values as a List
        from polars_tpu_torch.engine.fn_nested import implode, one_per_list

        res = one_per_list(res) if res.domain == GROUP else implode(inner, res, GROUP)
    if res.domain == GROUP:
        return _group_to_rows(res, inner)
    return res


def _window_ctx(node: E.EWindow, ctx: EvalCtx) -> EvalCtx:
    """The context of a window's function: the groups of its keys, made
    once per key tuple, with its ``order_by`` words."""
    if ctx.groups is not None:
        raise InvalidOperationError("over() inside a group-by aggregation is not supported")
    if ctx.windows is None:
        ctx.windows = {}
    inner = ctx.windows.get((node.partition_by, node.order_by, node.order_descending))
    if inner is None:
        base = ctx.windows.get(node.partition_by)
        if base is None:
            keys = [P.row_domain(ctx, eval_expr(k, ctx)) for k in node.partition_by]
            base = ctx.windows[node.partition_by] = G.sorted_group_ctx(keys, ctx.rowmask)
        gctx = base
        if node.order_by:
            desc = node.order_descending or (False,) * len(node.order_by)
            words: list = []
            for ob, d in zip(node.order_by, desc):
                words.extend(P.value_words(P.row_domain(ctx, eval_expr(ob, ctx)), bool(d), False))
            gctx = dataclasses.replace(base, order_words=words)
        inner = EvalCtx(cols=ctx.cols, rowmask=ctx.rowmask, groups=gctx, memo={}, flags=ctx.flags, in_window=True)
        ctx.windows[(node.partition_by, node.order_by, node.order_descending)] = inner
    return inner


def _window_explode(node: E.EWindow, ctx: EvalCtx) -> tuple[Val, torch.Tensor]:
    """``over(mapping_strategy="explode")`` as a piece of its own length:
    each group's results one after another, the groups in the order of
    their first rows (``group_by(..., maintain_order=True).agg(...)
    .explode(...)``), a group's rows in row order. Per-row results are
    moved by one stable sort of the kept rows by their group's first row;
    one result per group fills the first ``num_groups`` slots of the
    window's group space (capacity = rows)."""
    inner = _window_ctx(node, ctx)
    res = eval_expr(node.function, inner)
    reject_series(res)
    gctx, rowmask = inner.groups, ctx.rowmask
    first, has = G.seg_first_idx(rowmask, gctx.gids, gctx.capacity)
    n = rowmask.shape[0]
    if res.domain == GROUP:
        order = stable_argsort_words([torch.where(has, first, n)])  # groups by their first row
        keep = torch.arange(gctx.capacity, device=rowmask.device) < gctx.num_groups
        return res.with_(values=res.values.index_select(0, order), domain=ROW,
                         validity=None if res.validity is None else res.validity.index_select(0, order)), keep
    if res.domain == SCALAR:
        res = res.with_(values=res.values.expand(n), domain=ROW,
                        validity=None if res.validity is None else res.validity.expand(n))
    dropped = (~rowmask).to(torch.int8)
    src = stable_argsort_words([dropped, first.index_select(0, gctx.gids.clamp(0, max(n - 1, 0)).long())])
    dst = stable_argsort_words([dropped])  # the kept rows' places, in order

    def moved(t: torch.Tensor) -> torch.Tensor:
        return torch.empty_like(t).index_copy_(0, dst, t.index_select(0, src))

    return res.with_(values=moved(res.values), validity=None if res.validity is None else moved(res.validity)), \
        rowmask


def _eval_cast(node: E.ECast, ctx: EvalCtx) -> Val:
    """A cast; with ``strict``, a non-null value it makes null (out of range,
    NaN to an integer, text that does not parse) fails the segment at its
    count read (a validation flag, the JAX package's cast flag channel), so
    the check adds no host read."""
    v = eval_expr(node.input, ctx)
    target = dt.parse_into_dtype(node.dtype)
    out = cast_val(v, target)
    if node.strict and out.validity is not None and out.validity is not v.validity:
        lost = ~out.validity
        if v.domain == GROUP and ctx.groups is not None:
            lost = lost & ctx.groups.group_valid
        flag_rows(ctx, v, lost, f"conversion from `{v.dtype!r}` to `{target!r}` failed in a strict cast "
                                "(a value out of range or that does not parse); use strict=False for nulls")
    return out


# ---------------------------------------------------------------------------
# literals
# ---------------------------------------------------------------------------


def _lit_dtype(value) -> dt.DataType:
    if isinstance(value, bool):
        return dt.Boolean()
    if isinstance(value, int):
        if 2**63 <= value < 2**64:
            return dt.UInt64()  # the one integer type that holds it
        return dt.Int32() if -(2**31) <= value < 2**31 else dt.Int64()
    if isinstance(value, float):
        return dt.Float64()
    if isinstance(value, _decimal.Decimal):
        exp = value.as_tuple().exponent
        return dt.Decimal(38, -exp if isinstance(exp, int) and exp < 0 else 0)
    raise NotImplementedError(f"literal {value!r} is not ported yet (port queue: expression breadth)")


def _eval_literal(node: E.ELiteral, ctx: EvalCtx) -> Val:
    value = node.value
    dtype = dt.parse_into_dtype(node.dtype) if node.dtype is not None else None
    if value is None:
        d = dtype if dtype is not None else dt.Null()
        table = None
        if isinstance(d, (dt.String, dt.Categorical, dt.Enum, dt.Binary)):  # an empty dictionary
            table = strtable.enum_table(d.categories) if isinstance(d, dt.Enum) else strtable.empty_table()
        tdt = torch.int32 if isinstance(d, dt.Null) or table is not None else dt.dtype_to_torch(d)
        return Val(
            torch.zeros(1, dtype=tdt, device=ctx.device),
            torch.zeros(1, dtype=torch.bool, device=ctx.device), d, table, SCALAR, empty_child(d, ctx.device),
        )
    if isinstance(value, str):
        if dtype is not None and dtype.is_temporal():
            iv = torch.tensor([parse_temporal_literal(value, dtype)], dtype=dt.dtype_to_torch(dtype), device=ctx.device)
            return Val(iv, None, dtype, None, SCALAR)
        if dtype is not None and not isinstance(dtype, (dt.String, dt.Categorical, dt.Enum)):
            raise NotImplementedError(
                f"{dtype!r} literals are not ported yet (port queue: expression breadth)")
        # a one-entry sorted dictionary; code 0 (an Enum's: its category's position)
        table = strtable.StringTable(np.asarray([value], object), sorted_order=True)
        out = Val(torch.zeros(1, dtype=torch.int32, device=ctx.device), None, dtype or dt.String(), table, SCALAR)
        return enum_remap(out, strtable.enum_table(dtype.categories)) if isinstance(dtype, dt.Enum) else out
    if isinstance(value, _decimal.Decimal):  # scaled to its dtype's scale, half to even
        d = dtype if isinstance(dtype, dt.Decimal) else _lit_dtype(value)
        scaled = int(value.scaleb(d.scale).to_integral_value(_decimal.ROUND_HALF_EVEN))
        return Val(torch.tensor([scaled], dtype=torch.int64, device=ctx.device), None, d, None, SCALAR)
    d = dtype if dtype is not None else _lit_dtype(value)
    return Val(int_scalar(value, d, ctx.device), None, d, None, SCALAR)


def parse_temporal_literal(value: str, dtype: dt.DataType) -> int:
    """An ISO date or datetime string as the epoch integer of ``dtype``. A
    string with a UTC offset is that instant; without one, it is the wall
    clock of ``dtype``'s time zone (the earlier instant where the clock
    repeats an hour), or naive."""
    if isinstance(dtype, dt.Date):
        return int(np.datetime64(value, "D").astype(np.int64))
    if isinstance(dtype, dt.Datetime):
        import datetime as _pydt

        try:
            parsed = _pydt.datetime.fromisoformat(value)
        except ValueError:
            parsed = None
        if parsed is None or (parsed.tzinfo is None and not dtype.time_zone):
            return int(np.datetime64(value, dtype.time_unit).astype(np.int64))
        if parsed.tzinfo is None:
            from polars_tpu_torch.kernels.timezone import zone

            parsed = parsed.replace(tzinfo=zone(dtype.time_zone))
        delta = parsed - _pydt.datetime(1970, 1, 1, tzinfo=_pydt.timezone.utc)
        micros = (delta.days * 86_400 + delta.seconds) * 1_000_000 + delta.microseconds
        return micros * dt.TICKS_PER_SECOND[dtype.time_unit] // 1_000_000
    raise InvalidOperationError(f"cannot parse temporal literal for {dtype!r}")


def _eval_series_literal(node: E.ESeriesLit, ctx: EvalCtx) -> Val:
    """A literal Series on the frame's device: a scalar when it holds one
    value (as in the JAX package), else its own (m,) tensor, which only
    ``is_in`` consumes (the JAX package pads it to the frame's rows)."""
    v = _val_to(col_to_val(node.column), ctx.device)
    return v.with_(domain=SCALAR if len(node.column) == 1 else SERIES)


def _val_to(v: Val, device) -> Val:
    """``v`` and its child on ``device`` (a literal's nested value keeps
    its elements or fields)."""
    child = v.child
    if isinstance(child, tuple):
        child = tuple(_val_to(c, device) for c in child)
    elif child is not None:
        child = _val_to(child, device)
    validity = None if v.validity is None else v.validity.to(device)
    return v.with_(values=v.values.to(device), validity=validity, child=child)


# ---------------------------------------------------------------------------
# binary ops
# ---------------------------------------------------------------------------


def _adapt_dyn_literal_vals(nodes, vals):
    """Untyped numeric literals take the first concrete numeric operand's
    dtype, as schema_resolve.adapt_dyn_literal_dtypes resolves them."""
    target = None
    for n, v in zip(nodes, vals):
        if dyn_literal_value(n) is None and v.dtype.is_numeric():
            target = v.dtype
            break
    if target is None:
        return list(vals)
    out = list(vals)
    for i, n in enumerate(nodes):
        lv = dyn_literal_value(n)
        if lv is None:
            continue
        nd = fit_dyn_dtype(lv, target)
        if nd is not None and nd != out[i].dtype:
            out[i] = Val(int_scalar(lv, nd, out[i].values.device), None, nd, None, SCALAR)
    return out


def _eval_binary(node: E.EBinary, ctx: EvalCtx) -> Val:
    op = node.op
    a = eval_expr(node.left, ctx)
    b = eval_expr(node.right, ctx)
    a, b = _adapt_dyn_literal_vals((node.left, node.right), (a, b))
    if {a.domain, b.domain} == {ROW, GROUP}:
        a, b = _group_to_rows(a, ctx), _group_to_rows(b, ctx)
    a, b, dom = broadcast_pair(a, b)
    if op in ("&", "|", "^") and all(isinstance(v.dtype, (dt.Boolean, dt.Null)) for v in (a, b)):
        return _kleene(op, a, b, dom)
    if op in ("eq_missing", "ne_missing"):
        return _eq_missing(op, a, b, dom)
    if op in _CMP:
        return _eval_compare(op, a, b, dom)
    if a.table is not None or b.table is not None:
        if op == "+" and a.table is not None and b.table is not None:
            return _string_add(a, b, dom)
        raise InvalidOperationError(f"operator {op!r} not supported for strings")
    out_dt = binary_dtype(op, a.dtype, b.dtype)
    if op == "**" and out_dt.is_integer():
        # an integer power has the base's type: a negative exponent fails
        # the segment at its count read, as in the JAX package
        flag_rows(ctx, b, b.values < 0, "exponent of an integer pow must be >= 0; cast to Float64 for negative "
                                        "exponents")
    lit = dyn_literal_value(node.right)
    pow_bits = int(lit).bit_length() if op == "**" and isinstance(lit, int) and lit >= 0 else 63
    values, validity = _arith(op, a, b, out_dt, pow_bits, ctx)
    if validity is not None and validity.shape != values.shape:
        validity = validity.expand(values.shape)
    return Val(values, validity, out_dt, None, dom)


# ``+`` of two string columns builds the text of every pair of their
# dictionaries' values on the host: at most this many pairs
_STRING_ADD_PAIRS = 1 << 16


def _string_add(a: Val, b: Val, dom: str) -> Val:
    """``a + b`` of two strings (null where either is): with a literal side,
    the other's dictionary mapped once (``map_over_table``); two columns
    through a host table of each pair of their dictionaries' values, read
    by one gather at ``i * |b| + j``. Larger pairs go through
    ``pl.concat_str``, which works per distinct pair of codes."""
    from polars_tpu_torch.engine.strings import map_over_table

    if _scalar_one_table(b):
        lit = b.table.values[0]
        out = map_over_table(a, lambda u: u + lit, memo=("+", lit), out_dtype=dt.String())
        return out.with_(validity=_broadcast_validity(out.validity, b.validity, out.values), domain=dom)
    if _scalar_one_table(a):
        lit = a.table.values[0]
        out = map_over_table(b, lambda u: lit + u, memo=("+r", lit), out_dtype=dt.String())
        return out.with_(validity=_broadcast_validity(out.validity, a.validity, out.values), domain=dom)
    n1, n2 = len(a.table), len(b.table)
    if n1 * n2 > _STRING_ADD_PAIRS:
        raise InvalidOperationError(
            f"`+` of two string columns with {n1} and {n2} distinct values: use pl.concat_str")

    def run():
        t1, t2 = a.table.values.tolist(), b.table.values.tolist()
        pairs = np.asarray([x + y for x in t1 for y in t2] or [""], dtype=object)
        return strtable.encode_strings(pairs)[::2]

    codes, table = a.table.memo(("+pairs", b.table.ident), run)
    i = a.values.to(torch.int64).clamp(0, max(n1 - 1, 0))
    j = b.values.to(torch.int64).clamp(0, max(n2 - 1, 0))
    values = take_lut(codes, i * max(n2, 1) + j).to(torch.int32)
    return Val(values, _broadcast_validity(a.validity, b.validity, values), dt.String(), table, dom)


def _broadcast_validity(x, y, values: torch.Tensor):
    validity = combine_validity(x, y)
    return validity.expand(values.shape) if validity is not None and validity.shape != values.shape else validity


def _arith(op: str, a: Val, b: Val, out_dt: dt.DataType, pow_bits: int = 63, ctx: EvalCtx | None = None):
    if isinstance(out_dt, dt.Decimal):
        return _decimal_arith(op, a, b, out_dt, ctx)
    if out_dt.is_temporal() or a.dtype.is_temporal() or b.dtype.is_temporal():
        return _temporal_arith(op, a, b, out_dt)
    if not out_dt.is_numeric():
        raise InvalidOperationError(f"cannot apply {op!r} to {a.dtype!r} and {b.dtype!r}")
    validity = combine_validity(a.validity, b.validity)
    if op == "**":
        if out_dt.is_integer():  # exact, wrapping like the native type
            values = _int_pow(a.values.to(torch.int64), b.values.to(torch.int64).clamp(min=0), pow_bits)
            return wrap_unsigned(values.to(dt.dtype_to_torch(out_dt)), out_dt), validity
        ft = dt.dtype_to_torch(out_dt)
        return torch.pow(float_values(a.values, a.dtype, ft), float_values(b.values, b.dtype, ft)), validity
    st = out_dt if op == "/" else supertype(a.dtype, b.dtype)
    av = cast_val(a, st).values
    bv = cast_val(b, st).values
    if op == "+":
        values = av + bv
    elif op == "-":
        values = av - bv
    elif op == "*":
        values = av * bv
    elif op == "/":
        values = div_any(av, bv)
    elif op == "//":
        if st.is_float():
            values = floordiv_any(av, bv)
        else:
            div = floordiv_u64 if isinstance(st, dt.UInt64) else floordiv_any
            values = div(av, torch.where(bv == 0, 1, bv))
            validity = combine_validity(validity, bv != 0)
    elif op == "%":
        if st.is_float():
            values = mod_any(av, bv)
        else:
            mod = mod_u64 if isinstance(st, dt.UInt64) else mod_any
            values = mod(av, torch.where(bv == 0, 1, bv))
            validity = combine_validity(validity, bv != 0)
    elif op in ("&", "|", "^"):
        values = {"&": torch.bitwise_and, "|": torch.bitwise_or, "^": torch.bitwise_xor}[op](av, bv)
    else:
        raise NotImplementedError(f"operator {op!r} is not ported yet (port queue: expression breadth)")
    tdt = dt.dtype_to_torch(out_dt)
    if values.dtype != tdt:
        values = values.to(tdt)
    # UInt16/UInt32 live in a wider signed tensor: wrap like the native type
    return wrap_unsigned(values, out_dt), validity


def _decimal_arith(op: str, a: Val, b: Val, out_dt: dt.Decimal, ctx: EvalCtx):
    """``+ - * / %`` of Decimals (an integer operand has scale 0) in int64
    scaled by 10^scale, as the JAX package's ``compiler.py:388-420`` and
    Polars' ``arithmetic/decimal.rs``: both sides at the output scale, a
    product divided back by 10^scale and a quotient's dividend scaled up,
    each rounded half to even; a division or remainder by zero is null; a
    remainder takes the divisor's sign, as Polars' integer ``%``. A sum or
    product whose scaled value leaves int64 fails the segment at its count
    read (the JAX package wraps; Polars has 128 bits)."""
    if op not in ("+", "-", "*", "/", "%"):
        raise InvalidOperationError(f"operator {op!r} is not defined for {a.dtype!r} and {b.dtype!r}")
    s = out_dt.scale

    def rescaled(v: Val) -> tuple[torch.Tensor, torch.Tensor | bool]:
        vs = v.dtype.scale if isinstance(v.dtype, dt.Decimal) else 0
        x = v.values.to(torch.int64)
        return _mul_checked(x, torch.full_like(x, 10 ** (s - vs))) if vs < s else (x, False)

    (av, abad), (bv, bbad) = rescaled(a), rescaled(b)
    validity = combine_validity(a.validity, b.validity)
    if op in ("+", "-"):
        out = av + bv if op == "+" else av - bv
        # two's complement: a sum overflows where both operands have one sign and the result the other
        bad = (((av ^ out) & ((bv if op == "+" else ~bv) ^ out)) < 0) | abad | bbad
    elif op == "*":
        out, bad = _decimal_product(av, bv, 10**s)
        bad = bad | abad | bbad
    elif op == "%":
        nz = bv != 0
        return mod_any(av, torch.where(nz, bv, 1)), combine_validity(validity, nz)
    else:
        nz = bv != 0
        return _div_half_even(av * (10**s), torch.where(nz, bv, 1)), combine_validity(validity, nz)
    _decimal_overflow_flag(ctx, bad, validity, a.domain if a.domain != SCALAR else b.domain, out_dt)
    return out, validity


def _decimal_overflow_flag(ctx: EvalCtx, bad: torch.Tensor, validity, domain: str, out_dt: dt.Decimal) -> None:
    """A validation flag where a Decimal result left int64 on a row that counts."""
    if validity is not None:
        bad = bad & validity
    if domain == ROW and bad.shape == ctx.rowmask.shape:
        bad = bad & ctx.rowmask
    ctx.add_flag(bad.any(), f"decimal overflow: a {out_dt!r} result does not fit in 64 bits", ComputeError)


def _mul_checked(x: torch.Tensor, y: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(x * y wrapped in int64, where it overflowed)."""
    p = x * y
    nz = x != 0
    back = torch.div(p, torch.where(nz, x, 1), rounding_mode="trunc")
    return p, (nz & (back != y)) | ((x == -1) & (y == torch.iinfo(torch.int64).min))


def _decimal_product(av: torch.Tensor, bv: torch.Tensor, d: int) -> tuple[torch.Tensor, torch.Tensor]:
    """round_half_even(av * bv / d) in int64 without the product itself
    leaving int64: with av = aq d + ar and bv = bq d + br (floor division),
    av bv / d = aq bq d + aq br + ar bq + ar br / d; and where that leaves
    int64."""
    aq, ar = floordiv_any(av, d), mod_any(av, d)
    bq, br = floordiv_any(bv, d), mod_any(bv, d)
    t, bad = _mul_checked(ar, br)  # in [0, d^2): exact for scales up to 9
    k, b1 = _mul_checked(aq, bq)
    k, b2 = _mul_checked(k, torch.full_like(k, d))
    p1, b3 = _mul_checked(aq, br)
    p2, b4 = _mul_checked(ar, bq)
    bad = bad | b1 | b2 | b3 | b4
    for term in (p1, p2, floordiv_any(t, d)):
        out = k + term
        bad = bad | (((k ^ out) & (term ^ out)) < 0)
        k = out
    r = mod_any(t, d)  # the floor quotient's remainder in [0, d): round half to even
    up = (2 * r > d) | ((2 * r == d) & (k % 2 != 0))
    out = k + up.to(torch.int64)
    return out, bad | ((k == torch.iinfo(torch.int64).max) & up)


def _div_half_even(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """``num / den`` of int64s rounded to the nearest integer, ties to even
    (``den`` nonzero)."""
    q = torch.div(num, den, rounding_mode="trunc")
    r = num - q * den
    twice = (2 * r).abs()
    away = (twice > den.abs()) | ((twice == den.abs()) & (q % 2 != 0))
    step = torch.where((num < 0) != (den < 0), -1, 1)
    return torch.where(away & (r != 0), q + step, q)


def _group_to_rows(v: Val, ctx: EvalCtx) -> Val:
    """A per-group value read at each row's group, where it meets a per-row
    one inside an aggregation (``col - col.mean()`` in a group-by)."""
    if v.domain != GROUP or ctx.groups is None:
        return v
    ids = ctx.groups.gids.clamp(0, ctx.groups.capacity - 1).long()
    return v.with_(values=v.values.index_select(0, ids),
                   validity=None if v.validity is None else v.validity.index_select(0, ids), domain=ROW)


def _int_pow(base: torch.Tensor, exp: torch.Tensor, bits: int) -> torch.Tensor:
    """``base ** exp`` in int64 by repeated squaring over the ``bits`` low
    bits of ``exp`` (not negative), wrapping as a native integer power; no
    host read."""
    out = torch.ones_like(base.expand(torch.broadcast_shapes(base.shape, exp.shape)))
    b, e = base.expand_as(out), exp.expand_as(out)
    for i in range(bits):
        out = torch.where(((e >> i) & 1) == 1, out * b, out)
        if i + 1 < bits:
            b = b * b
    return out


_US_PER_DAY = 86_400_000_000


def _temporal_arith(op: str, a: Val, b: Val, out_dt: dt.DataType):
    """Temporal arithmetic on integer epochs (the JAX package's ``_arith``):
    differences and sums of instants and durations on one time scale,
    ``Date ± Duration`` as a Date through microseconds floored to days, and
    a Duration times or floor-divided by a number (division by 0 is null)."""
    an, bn = type(a.dtype).__name__, type(b.dtype).__name__
    validity = combine_validity(a.validity, b.validity)
    if isinstance(out_dt, dt.Duration) and op in ("+", "-") and an in ("Date", "Datetime", "Duration", "Time"):
        av, bv = _temporal_pair(a, b, out_dt)
        return (av - bv if op == "-" else av + bv), validity
    if {an, bn} in ({"Date", "Duration"}, {"Datetime", "Duration"}) and op in ("+", "-"):
        work = dt.Datetime("us") if isinstance(out_dt, dt.Date) else out_dt
        av, bv = _temporal_pair(a, b, work)
        values = av + bv if op == "+" else av - bv
        if isinstance(out_dt, dt.Date):
            values = floordiv_any(values, _US_PER_DAY).to(torch.int32)
        return values, validity
    if isinstance(out_dt, dt.Duration) and op in ("*", "/"):
        av, bv = a.values.to(torch.int64), b.values
        if op == "*":
            return (av * bv).to(torch.int64), validity
        values = floordiv_any(av, torch.where(bv == 0, torch.ones((), dtype=bv.dtype, device=bv.device), bv))
        return values.to(torch.int64), combine_validity(validity, bv != 0)
    if op in ("+", "-") and out_dt.is_temporal():  # e.g. Datetime - Date: both in their supertype
        st = supertype(a.dtype, b.dtype)
        av, bv = cast_val(a, st).values, cast_val(b, st).values
        return (av + bv if op == "+" else av - bv), validity
    raise InvalidOperationError(f"cannot apply {op!r} to {a.dtype!r} and {b.dtype!r}")


def _temporal_pair(a: Val, b: Val, out_dt: dt.DataType) -> tuple[torch.Tensor, torch.Tensor]:
    """Both operands as int64 ticks of ``out_dt``'s time unit (microseconds
    without one): days scale up, finer units floor down, Time is
    nanoseconds."""
    unit = getattr(out_dt, "time_unit", "us")
    per = dt.TICKS_PER_SECOND[unit]

    def ticks(v: Val) -> torch.Tensor:
        x = v.values.to(torch.int64)
        if isinstance(v.dtype, dt.Date):
            return x * (86_400 * per)
        if isinstance(v.dtype, (dt.Datetime, dt.Duration)):
            src = dt.TICKS_PER_SECOND[v.dtype.time_unit]
            return x * (per // src) if per >= src else floordiv_any(x, src // per)
        if isinstance(v.dtype, dt.Time):
            return floordiv_any(x, 1_000_000_000 // per)
        return x

    return ticks(a), ticks(b)


def enum_remap(v: Val, etable: strtable.StringTable) -> Val:
    """A dictionary-coded value's codes in an Enum table's code space (its
    category positions); a value outside the categories is null."""
    if v.table is etable:
        return v
    pos = etable.codes_of(v.table.values.tolist())
    codes = take_lut(pos if len(pos) else np.full(1, -1, np.int32), v.values)
    return v.with_(values=codes.clamp(min=0), validity=combine_validity(v.validity, codes >= 0), table=etable)


def _scalar_one_table(v: Val) -> bool:
    """A SCALAR with a one-entry dictionary: a string literal."""
    return v.domain == SCALAR and v.table is not None and len(v.table) == 1


def _compare_vs_scalar_lut(op: str, a: Val, b: Val, dom: str) -> Val:
    """Ordering compare of a dictionary column against ONE host-known string
    through a host bool table over the dictionary (O(|dict|) compares)."""
    flip = {"<": ">", ">": "<", "<=": ">=", ">=": "<="}
    if _scalar_one_table(b) and not _scalar_one_table(a):
        col, lit, opx = a, b.table.values[0], op
    else:
        col, lit, opx = b, a.table.values[0], flip[op]
    vals = col.table.values
    lut = {"<": vals < lit, "<=": vals <= lit, ">": vals > lit, ">=": vals >= lit}[opx]
    values = take_lut(np.asarray(lut, dtype=bool), col.values)
    validity = combine_validity(a.validity, b.validity)
    if validity is not None and validity.shape != values.shape:
        validity = validity.expand(values.shape)
    return Val(values, validity, dt.Boolean(), None, dom)


def _string_codes(op: str, a: Val, b: Val) -> tuple[torch.Tensor, torch.Tensor]:
    """The two operands' codes in one code space. Equality probes the smaller
    dictionary into the larger one's codes (-1 = absent, never equal to a
    valid code); ordering unifies both into one sorted dictionary."""
    if a.table is b.table:
        if op not in ("==", "!="):  # an unordered dictionary: the text's order
            a, b = ensure_ordinal_val(a), ensure_ordinal_val(b)
        return a.values, b.values
    if op in ("==", "!="):
        if len(a.table) == 0 or len(b.table) == 0:  # an empty dictionary: codes never equal
            return a.values, torch.full_like(b.values, -1)
        if len(b.table) <= len(a.table):  # the larger dictionary's lookup, made once per table
            return a.values, take_lut(a.table.codes_of(b.table.values.tolist()), b.values)
        return take_lut(b.table.codes_of(a.table.values.tolist()), a.values), b.values
    _, lmap, rmap = strtable.unify(a.table, b.table, require_ordinal=True)
    return take_lut(lmap, a.values), take_lut(rmap, b.values)


def compare_vals(op: str, a: Val, b: Val) -> Val:
    """``a op b`` of two evaluated values, their domains reconciled."""
    a, b, dom = broadcast_pair(a, b)
    if op in ("eq_missing", "ne_missing"):
        return _eq_missing(op, a, b, dom)
    return _eval_compare(op, a, b, dom)


def _eval_compare(op: str, a: Val, b: Val, dom: str) -> Val:
    if isinstance(a.dtype, dt.Struct) and isinstance(b.dtype, dt.Struct) and op in ("==", "!="):
        from polars_tpu_torch.engine.fn_nested import struct_equal

        return struct_equal(op, a, b)
    if isinstance(a.dtype, (dt.List, dt.Array)) and isinstance(b.dtype, (dt.List, dt.Array)) and op in ("==", "!="):
        from polars_tpu_torch.engine.fn_nested import list_equal

        return list_equal(op, a, b, dom)
    if isinstance(a.dtype, dt.NestedType) or isinstance(b.dtype, dt.NestedType):
        raise InvalidOperationError(f"cannot compare {a.dtype!r} with {b.dtype!r}")
    if (a.table is not None) != (b.table is not None):
        raise InvalidOperationError(f"cannot compare {a.dtype!r} with {b.dtype!r}")
    if a.table is not None:
        if isinstance(a.dtype, dt.Enum) or isinstance(b.dtype, dt.Enum):
            # in the Enum's code space, its category order; a value outside
            # the categories compares as null
            e = a.table if isinstance(a.dtype, dt.Enum) else b.table
            a, b = enum_remap(a, e), enum_remap(b, e)
            av, bv = a.values, b.values
        elif op not in ("==", "!=") and (_scalar_one_table(a) or _scalar_one_table(b)):
            return _compare_vs_scalar_lut(op, a, b, dom)
        else:
            av, bv = _string_codes(op, a, b)
    else:
        st = supertype(a.dtype, b.dtype)
        # UInt64 bit patterns compare as unsigned once their sign bit is flipped
        av, bv = order_word(cast_val(a, st).values, st), order_word(cast_val(b, st).values, st)
    fn = {"==": torch.eq, "!=": torch.ne, "<": torch.lt, "<=": torch.le, ">": torch.gt, ">=": torch.ge}[op]
    values = fn(av, bv)
    validity = combine_validity(a.validity, b.validity)
    if validity is not None and validity.shape != values.shape:
        validity = validity.expand(values.shape)
    return Val(values, validity, dt.Boolean(), None, dom)


def _eq_missing(op: str, a: Val, b: Val, dom: str) -> Val:
    """``==``/``!=`` where null equals null and differs from any value."""
    eq = _eval_compare("==", a.with_(validity=None), b.with_(validity=None), dom).values
    if a.validity is not None or b.validity is not None:
        av = torch.ones_like(eq) if a.validity is None else a.validity.expand(eq.shape)
        bv = torch.ones_like(eq) if b.validity is None else b.validity.expand(eq.shape)
        eq = torch.where(av & bv, eq, ~av & ~bv)
    return Val(eq if op == "eq_missing" else ~eq, None, dt.Boolean(), None, dom)


def _kleene(op: str, a: Val, b: Val, dom: str) -> Val:
    """SQL three-valued logic for boolean &/| (reference:
    polars-compute/src/boolean.rs Kleene kernels)."""
    av = a.values.to(torch.bool)
    bv = b.values.to(torch.bool)
    if op == "^":
        return Val(av ^ bv, combine_validity(a.validity, b.validity), dt.Boolean(), None, dom)
    if a.validity is None and b.validity is None:
        values = (av & bv) if op == "&" else (av | bv)
        return Val(values, None, dt.Boolean(), None, dom)
    an = torch.zeros_like(av) if a.validity is None else ~a.validity
    bn = torch.zeros_like(bv) if b.validity is None else ~b.validity
    if op == "&":
        known_false = (~an & ~av) | (~bn & ~bv)
        validity = known_false | (~an & ~bn)
        values = (av & bv) & ~(an | bn)
    else:
        known_true = (~an & av) | (~bn & bv)
        validity = known_true | (~an & ~bn)
        values = known_true | (av | bv)
    return Val(values, validity, dt.Boolean(), None, dom)


# ---------------------------------------------------------------------------
# ternary
# ---------------------------------------------------------------------------


def _eval_ternary(node: E.ETernary, ctx: EvalCtx) -> Val:
    """when/then/otherwise: a null predicate picks the otherwise branch
    (reference: if_then_else kernels)."""
    p = eval_expr(node.predicate, ctx)
    t = eval_expr(node.truthy, ctx)
    f = eval_expr(node.falsy, ctx)
    reject_series(p, t, f)
    t, f = _adapt_dyn_literal_vals((node.truthy, node.falsy), (t, f))
    t, f = _unify_branches(t, f)
    doms = {p.domain, t.domain, f.domain} - {SCALAR}
    if len(doms) > 1:
        raise ShapeError("mixed domains in when/then/otherwise")
    dom = doms.pop() if doms else SCALAR
    if t.dtype.is_nested():
        from polars_tpu_torch.engine.fn_nested import on_one_child

        t, f = on_one_child([t, f])
    pv = p.values.to(torch.bool)
    if p.validity is not None:
        pv = pv & p.validity
    values = torch.where(pv, t.values, f.values)
    if t.validity is None and f.validity is None:
        validity = None
    else:
        tv = torch.ones_like(t.values, dtype=torch.bool) if t.validity is None else t.validity
        fv = torch.ones_like(f.values, dtype=torch.bool) if f.validity is None else f.validity
        validity = torch.where(pv, tv, fv).expand(values.shape)
    return Val(values, validity, t.dtype, t.table, dom, t.child)


def _unify_branches(t: Val, f: Val) -> tuple[Val, Val]:
    """Both branches in one dtype: strings on one merged dictionary, numbers
    in their supertype; a null literal takes the other branch's type."""
    if t.table is not None or f.table is not None:
        if t.table is not None and f.table is not None:
            return unify_vals(t, f)
        if isinstance(t.dtype, dt.Null):
            return t.with_(dtype=f.dtype, table=f.table), f
        if isinstance(f.dtype, dt.Null):
            return t, f.with_(dtype=t.dtype, table=t.table)
        raise InvalidOperationError("when/then branches mix string and non-string")
    st = supertype(t.dtype, f.dtype)
    return cast_val(t, st), cast_val(f, st)


# ---------------------------------------------------------------------------
# aggregation
# ---------------------------------------------------------------------------


def group_of(ctx: EvalCtx) -> GroupCtx:
    """The context's groups; outside a group-by, one group of capacity 1
    that holds every row (the JAX package's ``_group_of``)."""
    if ctx.groups is not None:
        return ctx.groups
    if ctx.scalar_group is None:
        ctx.scalar_group = G.one_group_ctx(ctx.rowmask)
    return ctx.scalar_group


def _agg_domain(ctx: EvalCtx) -> str:
    """An aggregation yields one value per group, or one scalar outside a
    group-by."""
    return GROUP if ctx.groups is not None else SCALAR


def _agg_input(node: E.ENode, ctx: EvalCtx) -> tuple[Val, torch.Tensor]:
    """An aggregation's input and the rows it aggregates: a filter narrows
    the row mask, a slice keeps a window of each group's rows (in their
    current order), ``unique`` keeps each group's first row of each value
    (a List or Struct by its content), and a node over such an input runs
    over its rows (a sort within the group, say)."""
    if not E.changes_length(node):
        return eval_expr(node, ctx), ctx.rowmask
    if isinstance(node, E.EFunction) and node.name == "unique":
        from polars_tpu_torch.engine.fn_core import distinct_flags

        v, mask = _agg_input(node.inputs[0], ctx)
        first = distinct_flags(_sub_ctx(ctx, mask, {}), v, "is_first_distinct")
        return v, mask & first.values
    if isinstance(node, E.EFilter):
        v, mask = _agg_input(node.input, ctx)
        p = eval_expr(node.by, ctx)
        if not isinstance(p.dtype, dt.Boolean):
            raise InvalidOperationError(f"filter predicate must be Boolean, got {p.dtype!r}")
        pv = p.values.to(torch.bool)
        if p.validity is not None:
            pv = pv & p.validity
        return v, mask & pv
    if isinstance(node, E.ESlice):
        v, mask = _agg_input(node.input, ctx)
        sub = _sub_ctx(ctx, mask, {})
        o = P.group_order(sub)
        pos = torch.arange(o.n, device=mask.device) - o.start
        size = o.end - o.start + 1
        first = (size + node.offset).clamp(min=0) if node.offset < 0 else torch.full_like(size, node.offset)
        keep = pos >= first
        if node.length is not None:
            keep = keep & (pos < first + node.length)
        return v, mask & o.to_rows(keep)
    if isinstance(node, E.EGather):  # each taking row carries the value its index reads
        v, mask = _agg_input(node.input, ctx)
        sub = _sub_ctx(ctx, mask, {})
        idx = eval_expr(node.indices, sub)
        src, ok = _group_sources(sub, idx if idx.domain != SCALAR else idx.with_(domain=SERIES))
        return _gathered(P.row_domain(ctx, v), src, ok), mask & ok
    if isinstance(node, E.ESeriesLit):
        raise InvalidOperationError("a literal Series under an aggregation")
    kids = node.children()
    vals, mask = align_in_groups(ctx, [_agg_input(c, ctx) for c in kids])
    sub = _sub_ctx(ctx, mask, dict(zip(kids, vals)))
    return eval_expr(node, sub), mask


def align_in_groups(ctx: EvalCtx, pieces: list[tuple[Val, torch.Tensor]]) -> tuple[list[Val], torch.Tensor]:
    """The inputs of one aggregation, which may keep different rows, lined
    up by their place in their group: the k-th kept row of a group in each
    input meets the k-th of the first input, whose rows carry the result
    (Polars pairs them by position). The inputs must keep as many rows in
    each group: a check on the segment's count read."""
    masks = [m for _, m in pieces]
    if all(m is masks[0] for m in masks):
        return [v for v, _ in pieces], masks[0]
    gctx = group_of(ctx)
    gids, cap = gctx.gids, gctx.capacity
    base = masks[0]
    n = base.shape[0]
    iota = torch.arange(n, device=base.device)
    o0 = P.group_order(_sub_ctx(ctx, base, {}))
    place = o0.to_rows(iota - o0.start)  # each kept row's place in its group
    count0 = G.seg_count(base, gids, cap)
    live = gctx.group_valid
    out = [pieces[0][0]]
    for v, m in pieces[1:]:
        if v.domain == SCALAR or m is base:
            out.append(v)
            continue
        oi = P.group_order(_sub_ctx(ctx, m, {}))
        ctx.add_flag((live & (G.seg_count(m, gids, cap) != count0)).any(),
                     "the inputs of an aggregation keep different numbers of rows in a group", ComputeError)
        seg = torch.where(oi.kept, oi.seg.to(torch.int64), cap)
        first = torch.full((cap + 1,), n, dtype=torch.int64, device=base.device)
        first = first.scatter_reduce(0, seg, iota, "amin", include_self=True)
        slot = (first.index_select(0, gids.clamp(0, max(cap - 1, 0)).long()) + place).clamp(0, max(n - 1, 0))
        row = oi.perm.index_select(0, slot)
        vv = P.row_domain(ctx, v)
        out.append(vv.with_(values=vv.values.index_select(0, row),
                            validity=None if vv.validity is None else vv.validity.index_select(0, row)))
    return out, base


def _eval_agg(node: E.EAgg, ctx: EvalCtx) -> Val:
    gctx, dom = group_of(ctx), _agg_domain(ctx)
    kind = node.kind
    if kind == "len" and not E.changes_length(node.input):
        return Val(G.group_counts(gctx, ctx.rowmask), None, dt.UInt32(), None, dom)
    if kind in ("corr", "cov"):
        return _eval_corr_cov(node, ctx, gctx, dom)
    v, rowmask = _agg_input(node.input, ctx)
    if rowmask is not ctx.rowmask:  # a filter or slice: the groups' cached counts are the other mask's
        gctx = dataclasses.replace(gctx, counts=None, sort_perm=None)
    gids, cap = gctx.gids, gctx.capacity
    if kind == "len":
        return Val(G.seg_count(rowmask, gids, cap), None, dt.UInt32(), None, dom)
    reject_series(v)
    if v.domain == GROUP:
        raise InvalidOperationError("nested aggregations are not supported")
    if v.domain == SCALAR:
        v = v.with_(
            values=v.values.expand(ctx.rows),
            validity=None if v.validity is None else v.validity.expand(ctx.rows),
            domain=ROW,
        )
    if isinstance(v.dtype, dt.Decimal) and kind in _FLOAT_AGGS:  # over the logical value
        v = v.with_(values=decimal_to_float(v.values, v.dtype.scale, torch.float64), dtype=dt.Float64())
    data_mask = rowmask if v.validity is None else (rowmask & v.validity)
    if kind == "count":
        return Val(G.seg_count(data_mask, gids, cap), None, dt.UInt32(), None, dom)
    if kind == "sum":
        out_dt = _agg_out_dtype(node, v.dtype)
        s = G.seg_sum(v.values.to(dt.dtype_to_torch(out_dt)), data_mask, gids, cap)
        return Val(wrap_unsigned(s, out_dt), None, out_dt, None, dom)  # polars: sum of all-null/empty = 0
    if kind == "mean":
        as_float = v.dtype.is_integer() or v.dtype.is_temporal()
        vals = float_values(v.values, v.dtype, torch.float64) if as_float else v.values
        m, has = G.seg_mean(vals, data_mask, gids, cap)
        out_dt = _agg_out_dtype(node, v.dtype)
        return Val(mean_values(m, v.dtype, out_dt), has, out_dt, None, dom)
    if kind in ("min", "max") and v.dtype.is_nested():
        return _nested_extreme(kind, v, data_mask, gctx, dom)
    if kind in ("min", "max"):
        v = ensure_ordinal_val(v)  # an unordered dictionary: the text's order
        # without nulls, a group has a value where it has rows: the groups'
        # counts, taken once (one K1 count for every such extreme)
        counts = G.group_counts(gctx, rowmask) if v.validity is None else G.seg_count(data_mask, gids, cap)
        return Val(G.seg_extreme(kind, v, data_mask, gids, cap), counts > 0, v.dtype, v.table, dom)
    if kind in ("first", "last"):
        # Polars' first/last include nulls: the row is picked by position
        # among the group's rows, and its validity goes with it
        fn = G.seg_first_idx if kind == "first" else G.seg_last_idx
        idx, has = fn(rowmask, gids, cap)
        if v.values.shape[0] == 0:  # no rows: every group is null
            return v.with_(values=torch.zeros(cap, dtype=v.values.dtype, device=v.values.device), validity=has,
                           domain=dom)
        validity = has if v.validity is None else (has & v.validity.index_select(0, idx))
        return v.with_(values=v.values.index_select(0, idx), validity=validity, domain=dom)
    if kind in ("implode", "agg_groups"):
        from polars_tpu_torch.engine.fn_nested import implode

        sub = ctx if rowmask is ctx.rowmask else _sub_ctx(ctx, rowmask, {})
        if kind == "agg_groups":  # each row's place among the frame's kept rows
            v = Val(torch.cumsum(ctx.rowmask, 0) - 1, None, dt.UInt32(), None, ROW)
        return implode(sub, v, dom)
    if kind == "n_unique":
        out = G.seg_nunique(v, rowmask, gids, cap)
        return Val(wrap_unsigned(out, dt.UInt32()), None, dt.UInt32(), None, dom)
    return _eval_stat_agg(node, ctx, v, data_mask, gctx, rowmask)


def _eval_stat_agg(node: E.EAgg, ctx: EvalCtx, v: Val, data_mask: torch.Tensor, gctx: GroupCtx,
                   rowmask: torch.Tensor) -> Val:
    """The statistical aggregations (the JAX package's ``_eval_agg``, from
    ``null_count`` on): their sums and counts go through K1
    (``groupby.seg_sum``/``seg_count``); ``median`` and ``quantile`` sort by
    (group, value)."""
    dom = _agg_domain(ctx)
    gids, cap = gctx.gids, gctx.capacity
    kind = node.kind
    out_dt = _agg_out_dtype(node, v.dtype)
    if kind == "null_count":
        if v.validity is None:
            return Val(torch.zeros(cap, dtype=torch.int64, device=rowmask.device), None, dt.UInt32(), None, dom)
        return Val(G.seg_count(rowmask & ~v.validity, gids, cap), None, dt.UInt32(), None, dom)
    if kind in ("var", "std"):
        var, ok = G.seg_var(_float_input(v), data_mask, gids, cap, int(node.opt("ddof", 1)))
        out = torch.sqrt(var) if kind == "std" else var
        return Val(out.to(dt.dtype_to_torch(out_dt)), ok, out_dt, None, dom)
    if kind in ("median", "quantile"):
        q = 0.5 if kind == "median" else float(node.opt("quantile", 0.5))
        interp = "linear" if kind == "median" else node.opt("interpolation", "nearest")
        out, has = G.seg_quantile(v, data_mask, gids, cap, q, interp)
        return Val(mean_values(out, v.dtype, out_dt), has, out_dt, None, dom)
    if kind == "product":
        # exact: an integer product wraps as Polars' does, a float product
        # keeps IEEE's NaN for inf * 0 (the JAX package goes through
        # exp(sum(log|x|)) and a zero test, ROADMAP section 3)
        work = dt.dtype_to_torch(out_dt)
        x = float_values(v.values, v.dtype, work) if out_dt.is_float() else v.values.to(torch.int64)
        out = G.seg_prod(x, data_mask, gids, cap)
        return Val(out.to(dt.dtype_to_torch(out_dt)), None, out_dt, None, dom)
    if kind in ("any", "all"):
        bv = v.values.to(torch.bool)
        out = (G.seg_any if kind == "any" else G.seg_all)(bv, data_mask, gids, cap)
        if node.opt("ignore_nulls", True) or v.validity is None:
            return Val(out, None, dt.Boolean(), None, dom)
        # Kleene: any is null where no value is true and some is null; all
        # where none is false and some is null
        has_null = G.seg_count(rowmask & ~v.validity, gids, cap) > 0
        return Val(out, (out if kind == "any" else ~out) | ~has_null, dt.Boolean(), None, dom)
    if kind in ("arg_min", "arg_max"):
        return _eval_arg_extreme(kind, v, data_mask, gctx, rowmask, dom)
    if kind in ("skew", "kurtosis"):
        return _eval_moment(node, v, data_mask, gctx, dom, out_dt)
    if kind == "entropy":
        # -sum(p ln p) / ln(base), p the values over their group's sum where
        # ``normalize`` (the JAX package's compiler.py:1151)
        x = _float_input(v).to(torch.float64)
        zero = torch.zeros((), dtype=torch.float64, device=x.device)
        if node.opt("normalize", True):
            total = G.seg_sum(torch.where(data_mask, x, zero), data_mask, gids, cap)
            x = x / total.index_select(0, gids.clamp(0, cap - 1).long())
        plogp = torch.where(data_mask & (x > 0), x * torch.log(torch.where(x > 0, x, 1.0)), zero)
        ent = -G.seg_sum(plogp, data_mask, gids, cap) / math.log(float(node.opt("base", math.e)))
        return Val(ent.to(dt.dtype_to_torch(out_dt)), None, out_dt, None, dom)
    if kind in ("bitwise_and", "bitwise_or", "bitwise_xor"):
        return _eval_bitwise_agg(kind, v, data_mask, gids, cap, dom)
    if kind == "mode":
        return _eval_mode(v, data_mask, gctx, dom)
    if kind == "is_sorted":
        return _eval_is_sorted(node, v, rowmask, gctx, dom)
    if kind == "item":
        # exactly one row per group (the JAX package's compiler.py:927-937):
        # more, or none without ``allow_empty``, fails at the count read
        cnt = G.seg_count(rowmask, gids, cap)
        live = gctx.group_valid
        msg = "can only call `.item()` if the dataframe is of shape (1, 1), or if each group holds one value"
        ctx.add_flag((live & (cnt > 1)).any(), msg)
        if not node.opt("allow_empty", False):
            ctx.add_flag((live & (cnt == 0)).any(), msg)
        idx, has = G.seg_first_idx(rowmask, gids, cap)
        if v.values.shape[0] == 0:
            return v.with_(values=torch.zeros(cap, dtype=v.values.dtype, device=v.values.device), validity=has,
                           domain=dom)
        validity = has if v.validity is None else (has & v.validity.index_select(0, idx))
        return v.with_(values=v.values.index_select(0, idx), validity=validity, domain=dom)
    raise NotImplementedError(f"aggregation {kind!r} is not ported yet (port queue: expression breadth)")


def _group_runs(v: Val, mask: torch.Tensor, gctx: GroupCtx) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The ``mask`` rows sorted by (group, value), a dropped row after every
    group: (that order, its group ids, where a run of equal (group, value)
    starts)."""
    v = ensure_ordinal_val(v)
    cap = gctx.capacity
    g = torch.where(mask, gctx.gids.to(torch.int64), cap)
    c = content_val(v)  # a nested value: its content's rank
    word = order_word(c.values, c.dtype)
    perm = stable_argsort_words([g, word])
    gs, ws = g.index_select(0, perm), word.index_select(0, perm)
    start = torch.ones_like(gs, dtype=torch.bool)
    if gs.shape[0] > 1:
        start[1:] = (gs[1:] != gs[:-1]) | (ws[1:] != ws[:-1])
    return perm, gs, start


def _eval_mode(v: Val, data_mask: torch.Tensor, gctx: GroupCtx, dom: str) -> Val:
    """The most frequent values of each group (every one of a tie, in value
    order), a List per group: the rows sorted by (group, value), each run's
    length, the groups' longest (a max per group), the runs that reach it
    compacted by K2 and counted per group by K1."""
    from polars_tpu_torch.engine.fn_nested import compact_val, make_list

    cap = gctx.capacity
    perm, gs, start = _group_runs(v, data_mask, gctx)
    run = torch.cumsum(start.to(torch.int64), 0) - 1
    nruns = int(run[-1]) + 1 if run.shape[0] else 0
    run_len = torch.zeros(nruns, dtype=torch.int64, device=run.device).index_add_(0, run, torch.ones_like(run))
    run_group = gs[start]
    best = torch.zeros(cap + 1, dtype=torch.int64, device=run.device).scatter_reduce_(0, run_group, run_len, "amax")
    keep = (run_len == best.index_select(0, run_group)) & (run_group < cap)
    firsts = perm[start]
    child = compact_val(v.with_(values=v.values.index_select(0, firsts), validity=None, domain=ROW), keep)
    lens = G.seg_count(keep, run_group.clamp(max=max(cap - 1, 0)).to(torch.int32), cap) if cap else \
        torch.zeros(0, dtype=torch.int64, device=run.device)
    rows = Val(torch.zeros(cap, dtype=torch.int64, device=run.device), None, dt.List(v.dtype), None, dom)
    return make_list(rows, lens, child, dt.List(v.dtype))


def _eval_is_sorted(node: E.EAgg, v: Val, rowmask: torch.Tensor, gctx: GroupCtx, dom: str) -> Val:
    """Whether each group's values are in order (``descending`` True,
    False, or None for either), nulls first unless ``nulls_last``: each kept
    row against the group's previous one, in group order; a K1 count of the
    pairs out of order."""
    v = ensure_ordinal_val(v)
    cap = gctx.capacity
    g = torch.where(rowmask, gctx.gids.to(torch.int64), cap)
    perm = torch.sort(g, stable=True).indices
    gs = g.index_select(0, perm)
    c = content_val(v)  # a nested value: its content's rank
    word = order_word(c.values, c.dtype).index_select(0, perm)
    valid = torch.ones_like(gs, dtype=torch.bool) if v.validity is None else v.validity.index_select(0, perm)
    pair = (gs[1:] == gs[:-1]) & (gs[1:] < cap)
    a, b, va, vb = word[:-1], word[1:], valid[:-1], valid[1:]
    nulls_last = bool(node.opt("nulls_last", False))
    null_bad = (va & ~vb) if not nulls_last else (~va & vb)

    def bad(desc: bool) -> torch.Tensor:
        out_of_order = (a < b) if desc else (a > b)
        return pair & (null_bad | (va & vb & out_of_order))

    gid = gs[1:].clamp(max=max(cap - 1, 0)).to(torch.int32)
    desc = node.opt("descending", False)
    if desc is None:
        ok = ~G.seg_any(bad(False), pair, gid, cap) | ~G.seg_any(bad(True), pair, gid, cap)
    else:
        ok = ~G.seg_any(bad(bool(desc)), pair, gid, cap)
    return Val(ok, None, dt.Boolean(), None, dom)


def _eval_moment(node: E.EAgg, v: Val, data_mask: torch.Tensor, gctx: GroupCtx, dom: str, out_dt) -> Val:
    """Skewness (``bias=False``: the adjusted Fisher-Pearson coefficient) and
    kurtosis (Fisher's excess unless ``fisher=False``; ``bias=False``: the
    unbiased estimator, as Polars computes it) from the central moments of
    values centred on their group's mean: two K1 passes."""
    gids, cap = gctx.gids, gctx.capacity
    x = _float_input(v).to(torch.float64)
    zero = torch.zeros((), dtype=torch.float64, device=x.device)
    c = G.seg_count(data_mask, gids, cap).to(torch.float64)
    mean = G.seg_sum(torch.where(data_mask, x, zero), data_mask, gids, cap) / c.clamp(min=1.0)
    d = torch.where(data_mask, x - mean.index_select(0, gids.clamp(0, cap - 1).long()), zero)
    m2, m3, m4 = (G.seg_sums([d * d, d * d * d, (d * d) * (d * d)], data_mask, gids, cap) / c.clamp(min=1.0).unsqueeze(1)).unbind(1)
    if node.kind == "skew":
        out = m3 / m2.pow(1.5)
        if not node.opt("bias", True):
            out = out * torch.sqrt(c * (c - 1)) / (c - 2)
    else:
        out = m4 / (m2 * m2)
        if not node.opt("bias", True):
            out = ((c + 1) * (out - 3) + 6) * (c - 1) / ((c - 2) * (c - 3)) + 3
        if node.opt("fisher", True):
            out = out - 3.0
    return Val(out.to(dt.dtype_to_torch(out_dt)), c > 0, out_dt, None, dom)


def _eval_bitwise_agg(kind: str, v: Val, data_mask: torch.Tensor, gids: torch.Tensor, cap: int, dom: str) -> Val:
    """AND, OR or XOR of each group's values, bit by bit from per-bit
    counts (K1): a bit is set in the AND where every value has it, in the
    OR where one has, in the XOR where an odd number have (the JAX
    package's bit-sliced reduction, compiler.py:1049-1080); null for a
    group without values."""
    counts = G.seg_count(data_mask, gids, cap)
    has = counts > 0
    if isinstance(v.dtype, dt.Boolean):
        bv = v.values.to(torch.bool)
        ones = G.seg_count(data_mask & bv, gids, cap)
        out = {"bitwise_and": ones == counts, "bitwise_or": ones > 0, "bitwise_xor": ones % 2 == 1}[kind]
        return Val(out, has, dt.Boolean(), None, dom)
    from polars_tpu_torch.engine.cast import _BITS, wrap_int

    w = _BITS[type(v.dtype).__name__]
    u = v.values.to(torch.int64)
    out = torch.zeros(cap, dtype=torch.int64, device=u.device)
    for bit in range(w):
        ones = G.seg_count(data_mask & (((u >> bit) & 1) == 1), gids, cap)
        on = {"bitwise_and": ones == counts, "bitwise_or": ones > 0, "bitwise_xor": ones % 2 == 1}[kind]
        out = out | (on.to(torch.int64) << bit)
    return Val(wrap_int(out, v.dtype), has, v.dtype, None, dom)


def _avg_ranks(x: torch.Tensor, dtype: dt.DataType, mask: torch.Tensor, gids: torch.Tensor, cap: int,
               counts: torch.Tensor) -> torch.Tensor:
    """Each ``mask`` row's rank (1-based, ties averaged) among its group's
    ``mask`` rows: one stable sort by (group, value), NaN greatest."""
    from polars_tpu_torch.kernels.argsort import boundaries_from_words, key_words

    n = x.shape[0]
    if n == 0:
        return torch.zeros(0, dtype=torch.float64, device=x.device)
    words = [torch.where(mask, gids, cap), *key_words(x, dtype)]
    perm = stable_argsort_words(words)
    newval = boundaries_from_words(words, perm)
    last = torch.ones_like(newval)
    last[:-1] = newval[1:]
    run_start, run_end = P.marked_neighbours(newval)[0], P.marked_neighbours(last)[1]
    offsets = torch.cumsum(counts, 0) - counts
    g_sorted = words[0].index_select(0, perm).clamp(0, max(cap - 1, 0)).long()
    rank_sorted = (run_start + run_end).to(torch.float64) * 0.5 - offsets.index_select(0, g_sorted) + 1
    return torch.empty_like(rank_sorted).index_copy_(0, perm, rank_sorted)


def _eval_corr_cov(node: E.EAgg, ctx: EvalCtx, gctx: GroupCtx, dom: str) -> Val:
    """``pl.corr`` (Pearson's, or Spearman's: Pearson's of the average
    ranks) and ``pl.cov`` per group over the rows where both inputs are
    valid, in two K1 passes: the group means, then the sums of the
    products of the centred values. The JAX package's one-pass
    ``n*Sxx - Sx^2`` (compiler.py:835-838) cancels for values far from 0
    (ROADMAP section 3)."""
    pair = node.input
    if not (isinstance(pair, E.EFunction) and pair.name == "pack_pair"):
        raise InvalidOperationError(f"{node.kind} takes two columns (pl.{node.kind})")
    (a, b), mask_a = align_in_groups(ctx, [_agg_input(i, ctx) for i in pair.inputs])
    if mask_a is not ctx.rowmask:
        gctx = dataclasses.replace(gctx, counts=None, sort_perm=None)
    gids, cap = gctx.gids, gctx.capacity
    a, b = P.row_domain(ctx, a), P.row_domain(ctx, b)
    m = mask_a
    for x in (a, b):
        if x.validity is not None:
            m = m & x.validity
    counts = G.seg_count(m, gids, cap)
    n = counts.to(torch.float64)
    spearman = node.kind == "corr" and node.opt("method", "pearson") == "spearman"

    def values(x: Val) -> torch.Tensor:
        if isinstance(x.dtype, dt.Decimal):
            return decimal_to_float(x.values, x.dtype.scale, torch.float64)
        if spearman:
            return _avg_ranks(x.values, x.dtype, m, gids, cap, counts)
        return float_values(x.values, x.dtype, torch.float64)

    xv, yv = values(a), values(b)
    zero = torch.zeros((), dtype=torch.float64, device=xv.device)
    xv, yv = torch.where(m, xv, zero), torch.where(m, yv, zero)
    ids = gids.clamp(0, cap - 1).long()
    means = G.seg_sums([xv, yv], m, gids, cap) / n.clamp(min=1.0).unsqueeze(1)
    dx = torch.where(m, xv - means[:, 0].index_select(0, ids), zero)
    dy = torch.where(m, yv - means[:, 1].index_select(0, ids), zero)
    if node.kind == "cov":
        ddof = int(node.opt("ddof", 1))
        sxy = G.seg_sums([dx * dy], m, gids, cap)[:, 0]
        return Val(sxy / (n - ddof), n > ddof, dt.Float64(), None, dom)
    sums = G.seg_sums([dx * dy, dx * dx, dy * dy], m, gids, cap)
    denom = torch.sqrt(sums[:, 1] * sums[:, 2])
    out = torch.where(denom > 0, sums[:, 0] / torch.where(denom > 0, denom, 1.0), float("nan"))
    return Val(out, n >= 1, dt.Float64(), None, dom)


_FLOAT_AGGS = ("mean", "median", "quantile", "std", "var", "skew", "kurtosis", "entropy")


def decimal_to_float(values: torch.Tensor, scale: int, target: torch.dtype) -> torch.Tensor:
    """Decimal storage (int64 scaled by 10^scale) as floats."""
    return (values.to(torch.float64) / (10.0**scale)).to(target)


def _float_input(v: Val) -> torch.Tensor:
    """A numeric or Boolean value as f64 (f32 stays f32)."""
    if isinstance(v.dtype, dt.Float32):
        return v.values
    return float_values(v.values, v.dtype, torch.float64)


def content_val(v: Val) -> Val:
    """A nested value as the Int64 rank of its content (its order and its
    equalities, ``kernels/nested_keys.content_rank``); a flat one as it is."""
    if not v.dtype.is_nested():
        return v
    from polars_tpu_torch.kernels.nested_keys import content_rank

    return Val(content_rank(v), v.validity, dt.Int64(), None, v.domain)


def _nested_extreme(kind: str, v: Val, data_mask: torch.Tensor, gctx: GroupCtx, dom: str) -> Val:
    """``min``/``max`` of a List, Array or Struct by its content: the least
    or greatest content rank per group, and a row holding it
    (``kernels/nested_keys.rank_rows``), with its child."""
    from polars_tpu_torch.kernels.nested_keys import rank_rows

    n = v.values.shape[0]
    r = content_val(v)
    best = G.seg_extreme(kind, r, data_mask, gctx.gids, gctx.capacity)  # out of [0, n) for a group without values
    idx = rank_rows(r.values, data_mask).index_select(0, torch.where((best >= 0) & (best < n), best, n))
    has = idx < n
    values = v.values.index_select(0, idx.clamp(max=max(n - 1, 0))) if n else \
        torch.zeros(gctx.capacity, dtype=v.values.dtype, device=v.values.device)
    return v.with_(values=values, validity=has, domain=dom)


def _eval_arg_extreme(kind: str, v: Val, data_mask: torch.Tensor, gctx: GroupCtx, rowmask: torch.Tensor,
                      dom: str) -> Val:
    """The position within its group of the group's first least
    (``arg_min``) or greatest (``arg_max``, NaN greatest) value, counting
    the group's null rows as positions; null for a group without values."""
    gids, cap = gctx.gids, gctx.capacity
    v = ensure_ordinal_val(content_val(v))  # an unordered dictionary: the text's order
    ext = G.seg_extreme("min" if kind == "arg_min" else "max", v, data_mask, gids, cap)
    ids = gids.clamp(0, cap - 1).long()
    best = ext.index_select(0, ids)
    is_best = data_mask & (v.values == best)
    if v.dtype.is_float() and kind == "arg_max":  # a group holding NaN has NaN as its max
        nan = torch.isnan(v.values)
        is_best = data_mask & torch.where(torch.isnan(best), nan, v.values == best)
    idx, has = G.seg_first_idx(is_best, gids, cap)
    iota = torch.arange(rowmask.shape[0], device=rowmask.device)
    before = rowmask & (iota < idx.index_select(0, ids))
    return Val(G.seg_count(before, gids, cap), has, dt.UInt32(), None, dom)


def mean_values(m: torch.Tensor, in_dt: dt.DataType, out_dt: dt.DataType) -> torch.Tensor:
    """Float means in the storage of ``out_dt``: a temporal mean truncates
    to whole ticks, and a Date's mean of days becomes milliseconds (its mean
    is a ``Datetime("ms")``; the JAX package reads the days as milliseconds,
    ROADMAP §3)."""
    if isinstance(in_dt, dt.Date):
        m = m * 86_400_000.0
    return m.to(dt.dtype_to_torch(out_dt))


def _agg_out_dtype(node: E.EAgg, in_dt: dt.DataType) -> dt.DataType:
    from polars_tpu_torch.core.schema import Schema
    from polars_tpu_torch.plan.schema_resolve import agg_dtype

    fake = Schema([("__x", in_dt)])
    return agg_dtype(E.EAgg(E.EColumn("__x"), node.kind, node.options), fake)

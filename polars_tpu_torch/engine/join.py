"""Host-sized equi-joins and cross joins (the port of the equi part of
``polars_tpu/engine/join.py``: ``_key_word``, ``_pair_bit_width``,
``_side_keys``, ``_build_probe``, the count and expand passes,
``_right_unmatched``, ``join_frames``, ``_coalesce_cols``, ``_cross_join``
and the right join that ``_reorder_right`` lays out).

A join whose output size depends on the data runs here, between segments: an
m:m inner or left join, any right or full join, a cross join, and a semi or
anti join that the segment cannot match exactly (several keys, a float key,
``nulls_equal``). Each side's keys become one int64 word per row: a single
integer, date, bool or dictionary key is its own word, several keys pack
exactly into 63 bits where they fit (``kernels/rowencode.pack_keys_64``),
and otherwise (float keys, ``nulls_equal`` over nulls, wide tuples) the keys
are hashed and every candidate pair is verified on the key values. The build
side is sorted by its word (stable, so equal keys keep their row order) and
every probe row binary-searches its run; the output lists the probe rows in
order, each with its build rows in their original order. A right join is a
left join with the roles swapped; a full join appends the right rows that
matched nothing, in their order.

Host reads: the exact lengths are learned on the host, one value at a time.
- inner, left and right joins with exact keys: 1 (the pair count);
- with hashed keys: 2 (the candidate count, then the verified pairs' count
  from kernel K2, which compacts the pairs on the card);
- a full join: one more (the right rows that matched nothing, compacted by K2);
- semi and anti joins: 1 with exact keys (K2's count of the left rows kept,
  compacted by K2), 2 with hashed keys (the candidate count first);
- a cross join: none.
A declared ``validate`` is checked on the card and its flag rides the first
read. Every row index and offset is int64.
"""

from __future__ import annotations

import datetime as _pydt
import re

import torch

from polars_tpu_torch import datatypes as dt
from polars_tpu_torch.core.buffer import Buffer
from polars_tpu_torch.core.column import Column
from polars_tpu_torch.core.frame import DataFrame
from polars_tpu_torch.engine.cast import float_values, order_word, tu_convert
from polars_tpu_torch.engine.common import ROW, Val, take_lut
from polars_tpu_torch.engine.fn_temporal import _UNIT_NS
from polars_tpu_torch.engine.gather import gather_frame
from polars_tpu_torch.engine.join_traced import _key_word as _val_key_word
from polars_tpu_torch.errors import ComputeError, InvalidOperationError
from polars_tpu_torch.kernels.argsort import key_words, stable_argsort_words
from polars_tpu_torch.kernels.compact import compact_count, compact_scatter
from polars_tpu_torch.kernels.hashing import combine_hashes, hash_column
from polars_tpu_torch.kernels.rowencode import key_bit_width, pack_keys_64
from polars_tpu_torch.plan.schema_resolve import supertype
from polars_tpu_torch.utils import strtable

_BIG = 0x7FFFFFFFFFFFFFFF  # sorted word of a build row that cannot match


def _key_word(col: Column, other: Column) -> tuple[torch.Tensor, torch.Tensor | None, bool]:
    """(int64 key word, validity, exact) of one key column against the other
    side's (``join_traced._key_word``); dictionary codes land in the merged
    dictionary's code space."""
    def val(c: Column) -> Val:
        return Val(c.buffer.values, c.buffer.validity, c.dtype, c.table, ROW)

    return _val_key_word(val(col), val(other))


def _pair_bit_width(c: Column, o: Column) -> int | None:
    """Bit width of one key pair's common word domain, or None if it needs
    all 64 bits. Symmetric in (c, o): both sides must pack alike."""
    if c.table is not None:
        size = len(c.table) + (len(o.table) if o.table is not None else 0)  # >= the merged size
        return max(int(size + 1).bit_length(), 1) + 1
    if type(o.dtype) is not type(c.dtype):
        return None
    return key_bit_width(c.dtype)


def _compare_words(col: Column, other: Column) -> tuple[torch.Tensor, torch.Tensor | None, bool]:
    """(values to compare, validity, is_float) of one key column for the
    verification of hashed candidates: dictionary codes in the merged code
    space, floats as they are (NaN equals NaN), other keys as their word."""
    if col.dtype.is_float():
        return col.buffer.values, col.buffer.validity, True
    word, validity, _ = _key_word(col, other)
    return word, validity, False


def _side_keys(cols: list[Column], other_cols: list[Column], nulls_equal: bool):
    """(key word, usable rows or None for all, exact) of one side. The
    choice between raw words, an exact pack and a hash is made from both
    sides, so that both make the same one."""
    if len(cols) == 1:
        c, o = cols[0], other_cols[0]
        word, validity, exact = _key_word(c, o)
        if nulls_equal and (validity is not None or o.buffer.validity is not None):
            return hash_column(word, validity, 7), None, False  # null is a key of its own
        return word, validity, exact
    words, valids, widths, exact = [], [], [], True
    for c, o in zip(cols, other_cols):
        word, validity, ex = _key_word(c, o)
        words.append(word)
        valids.append(validity)
        exact = exact and ex and not o.dtype.is_float()
        widths.append(_pair_bit_width(c, o))
    usable = None
    if not nulls_equal:
        for v in valids:
            if v is not None:
                usable = v if usable is None else (usable & v)
    if exact and all(w is not None for w in widths) and sum(w + 1 for w in widths) <= 63:
        return pack_keys_64(words, valids, widths), usable, True  # a null is slot 0 of its field
    h = None
    for word, validity in zip(words, valids):
        hc = hash_column(word, validity, 7)
        h = hc if h is None else combine_hashes(h, hc)
    return h, usable, False


def _sort_side(key: torch.Tensor, usable: torch.Tensor | None):
    """(perm, sorted words, usable count or None): a stable sort of the
    rows by key word, the unusable rows last with the word ``_BIG``."""
    if usable is None:
        perm = stable_argsort_words([key])
        return perm, key.index_select(0, perm), None
    perm = stable_argsort_words([(~usable).to(torch.int8), key])
    sk = torch.where(usable.index_select(0, perm), key.index_select(0, perm), _BIG)
    return perm, sk, usable.sum()


def _build_probe(pk: torch.Tensor, pusable, sk: torch.Tensor, n_usable):
    """(first candidate position, candidate count) of every probe row in the
    sorted build words; an unusable probe row has none."""
    lo = torch.searchsorted(sk, pk, side="left")
    hi = torch.searchsorted(sk, pk, side="right")
    if n_usable is not None:
        lo, hi = torch.minimum(lo, n_usable), torch.minimum(hi, n_usable)
    matches = hi - lo
    if pusable is not None:
        matches = torch.where(pusable, matches, 0)
    return lo, matches


def _pairs_equal(pairs, ai: torch.Tensor, bi: torch.Tensor, nulls_equal: bool) -> torch.Tensor:
    """Whether the keys of rows ``ai`` of one side equal those of rows ``bi``
    of the other: ``pairs`` holds (values, validity, is_float) of each key
    column on both sides (Polars' total equality: NaN equals NaN)."""
    ok = torch.ones(ai.shape, dtype=torch.bool, device=ai.device)
    for (aw, av, is_float), (bw, bv, _) in pairs:
        a, b = aw.index_select(0, ai), bw.index_select(0, bi)
        same = a == b
        if is_float:
            same = same | (torch.isnan(a) & torch.isnan(b))
        anull = torch.zeros_like(same) if av is None else ~av.index_select(0, ai)
        bnull = torch.zeros_like(same) if bv is None else ~bv.index_select(0, bi)
        ok &= torch.where(anull | bnull, anull & bnull, same) if nulls_equal else (same & ~anull & ~bnull)
    return ok


def _has_duplicates(perm, sk, n_usable, side, exact: bool, nulls_equal: bool) -> torch.Tensor:
    """0-d bool: two usable rows of one sorted side share a key. ``side``
    holds (values, validity, is_float) of each of its key columns."""
    if sk.shape[0] < 2:
        return torch.zeros((), dtype=torch.bool, device=sk.device)
    adjacent = sk[1:] == sk[:-1]
    if n_usable is not None:
        adjacent &= torch.arange(1, sk.shape[0], device=sk.device) < n_usable
    if not exact:  # equal hashes: the keys must be equal too
        adjacent &= _pairs_equal([(w, w) for w in side], perm[:-1], perm[1:], nulls_equal)
    return adjacent.any()


def _read(count: torch.Tensor, bad: torch.Tensor | None, validate: str) -> int:
    """One host read: ``count``, or a failed ``validate`` riding it."""
    if bad is None:
        return int(count)
    n = int(torch.where(bad, -1, count))
    if n < 0:
        raise ComputeError(f"join keys did not fulfill {validate} validation")
    return n


def _compact(columns: list[torch.Tensor], keep: torch.Tensor, bad=None, validate: str = "m:m"):
    """(``columns`` where ``keep`` holds, their count) through kernel K2."""
    keep = keep.contiguous()
    offs = compact_count(keep)
    n = _read(offs[-1], bad, validate)
    return compact_scatter([c.contiguous() for c in columns], keep, offs, n), n


def _expand(counts, matches, lo, perm, total: int):
    """Offset arithmetic: for each of ``total`` output rows its probe row,
    its build row (0 where unmatched) and whether it is matched."""
    dev = counts.device
    probe_row = torch.repeat_interleave(torch.arange(counts.shape[0], device=dev), counts, output_size=total)
    start = torch.cumsum(counts, 0) - counts
    j = torch.arange(total, device=dev) - start.index_select(0, probe_row)
    matched = matches.index_select(0, probe_row) > 0
    if perm.shape[0] == 0:
        return probe_row, torch.zeros_like(probe_row), matched, j
    pos = (lo.index_select(0, probe_row) + j).clamp(max=perm.shape[0] - 1)
    build_row = torch.where(matched, perm.index_select(0, pos), 0)
    return probe_row, build_row, matched, j


def _null_column(c: Column, n: int) -> Column:
    """A column of ``n`` nulls shaped like ``c`` (its dtype and dictionary)."""
    dev = c.buffer.device
    values = torch.zeros(n, dtype=c.buffer.values.dtype, device=dev)
    return Column(c.name, c.dtype, Buffer(values, torch.zeros(n, dtype=torch.bool, device=dev)), c.table)


def _renamed(c: Column, name: str) -> Column:
    return c if c.name == name else Column(name, c.dtype, c.buffer, c.table)


def _coalesce_cols(a: Column, b: Column) -> Column:
    """``a`` where it is valid, else ``b`` (a full join's coalesced key);
    two dictionaries are merged first."""
    table = a.table
    av, bv = a.buffer.values, b.buffer.values
    if a.table is not None and b.table is not None and a.table is not b.table:
        table, lmap, rmap = strtable.unify(a.table, b.table)
        av = av if len(lmap) == 0 else take_lut(lmap, av)
        bv = bv if len(rmap) == 0 else take_lut(rmap, bv)
    if a.buffer.validity is None:
        return Column(a.name, a.dtype, Buffer(av, None), table)
    values = torch.where(a.buffer.validity, av, bv.to(av.dtype))
    validity = a.buffer.validity if b.buffer.validity is None else (a.buffer.validity | b.buffer.validity)
    return Column(a.name, a.dtype, Buffer(values, validity), table)


def _cross_join(left: DataFrame, right: DataFrame, suffix: str) -> DataFrame:
    """Every left row with every right row, left-major: index arithmetic,
    no host read."""
    nl, nr = left.height, right.height
    dev = left.device
    li = torch.arange(nl, device=dev).repeat_interleave(nr)
    ri = torch.arange(nr, device=dev).repeat(nl)
    names = set(left.columns)
    cols = gather_frame(left._columns, li)
    rcols = gather_frame(right._columns, ri)
    cols += [_renamed(c, c.name + suffix if c.name in names else c.name) for c in rcols]
    return DataFrame._from_columns(cols, nl * nr, device=dev)


def join_frames(
    left: DataFrame,
    right: DataFrame,
    left_key_names: list[str],
    right_key_names: list[str],
    how: str,
    suffix: str,
    nulls_equal: bool,
    coalesce: bool | None,
    validate: str = "m:m",
) -> DataFrame:
    """Join two materialized frames on the named key columns (Polars'
    semantics for every ``how``, ``coalesce``, ``suffix``, ``nulls_equal``
    and ``validate``)."""
    if how == "cross":
        return _cross_join(left, right, suffix)
    flip = how == "right"
    probe, build = (right, left) if flip else (left, right)
    pcols = [probe._get(n) for n in (right_key_names if flip else left_key_names)]
    bcols = [build._get(n) for n in (left_key_names if flip else right_key_names)]
    pk, pusable, pexact = _side_keys(pcols, bcols, nulls_equal)
    bk, busable, bexact = _side_keys(bcols, pcols, nulls_equal)
    exact = pexact and bexact
    pairs = [] if exact else [(_compare_words(p, b), _compare_words(b, p)) for p, b in zip(pcols, bcols)]

    perm, sk, n_usable = _sort_side(bk, busable)
    lo, matches = _build_probe(pk, pusable, sk, n_usable)

    # validate, as Polars reads it: m:1 = the right keys are unique, 1:m =
    # the left keys, 1:1 = both (nulls are no keys unless nulls_equal)
    unique = {"left": validate in ("1:m", "1:1"), "right": validate in ("m:1", "1:1")}
    bad = None
    if unique["left" if flip else "right"]:
        bad = _has_duplicates(perm, sk, n_usable, [b for _, b in pairs], exact, nulls_equal)
    if unique["right" if flip else "left"]:
        pperm, psk, pn = _sort_side(pk, pusable)
        dup = _has_duplicates(pperm, psk, pn, [p for p, _ in pairs], exact, nulls_equal)
        bad = dup if bad is None else (bad | dup)

    if how in ("semi", "anti"):
        if not exact:  # a left row is kept when one of its candidates verifies
            total = _read(matches.sum(), bad, validate)
            bad = None
            pi, bi, _, _ = _expand(matches, matches, lo, perm, total)
            ok = _pairs_equal(pairs, pi, bi, nulls_equal)
            matches = torch.zeros(matches.shape, dtype=torch.int64, device=ok.device).index_add_(0, pi, ok.long())
        keep = matches > 0 if how == "semi" else matches == 0
        return _compact_frame(left, keep, bad, validate)

    emit_unmatched = how in ("left", "right", "full")
    counts = matches.clamp(min=1) if emit_unmatched else matches
    total = _read(counts.sum(), bad, validate)
    out_p, out_b, b_valid, j = _expand(counts, matches, lo, perm, total)
    if not exact and total and build.height:
        ok = torch.where(b_valid, _pairs_equal(pairs, out_p, out_b, nulls_equal), True)
        keep = ok & b_valid
        if emit_unmatched:  # a probe row none of whose candidates verifies stays, unmatched
            hits = torch.zeros(counts.shape, dtype=torch.int64, device=ok.device).index_add_(0, out_p, keep.long())
            keep |= (j == 0) & (hits.index_select(0, out_p) == 0)
        (out_p, out_b, b_valid), total = _compact([out_p, out_b, b_valid & ok], keep)

    extra = None
    if how == "full":  # the right rows no pair reached, in their order
        hit = torch.zeros(build.height, dtype=torch.int64, device=out_b.device).index_add_(0, out_b, b_valid.long())
        (extra,), _ = _compact([torch.arange(build.height, device=out_b.device)], hit == 0)

    all_valid = b_valid if emit_unmatched else None  # an inner join's pairs all match
    if flip:
        lcols, rcols = gather_frame(left._columns, out_b, all_valid), gather_frame(right._columns, out_p)
    else:
        lcols, rcols = gather_frame(left._columns, out_p), gather_frame(right._columns, out_b, all_valid)
    return _assemble(left, right, left_key_names, right_key_names, how, suffix, coalesce, lcols, rcols, total, extra)


def _compact_frame(df: DataFrame, keep: torch.Tensor, bad, validate: str) -> DataFrame:
    """The rows of ``df`` where ``keep`` holds, every column's values and
    validity in one K2 pass."""
    inputs = []
    for c in df._columns:
        inputs.append(c.buffer.values)
        if c.buffer.validity is not None:
            inputs.append(c.buffer.validity)
    outs, n = _compact(inputs, keep, bad, validate)
    it = iter(outs)
    cols = []
    for c in df._columns:
        values = next(it)
        validity = next(it) if c.buffer.validity is not None else None
        cols.append(Column(c.name, c.dtype, Buffer(values, validity, n), c.table))
    return DataFrame._from_columns(cols, n, device=df.device)


def _assemble(left, right, left_keys, right_keys, how, suffix, coalesce, lcols, rcols, n: int, extra) -> DataFrame:
    """The output columns in Polars' layout (``plan/schema_resolve._join_schema``)
    from both sides' gathered columns; a full join appends the unmatched
    right rows ``extra`` (null on the left, its key coalesced)."""
    from polars_tpu_torch.functions.eager import concat

    if coalesce is None:
        coalesce = how in ("inner", "left", "right")
    if how == "right" and coalesce:
        cols = [c for c in lcols if c.name not in left_keys]
    else:
        cols = list(lcols)
    extra_cols = None
    if extra is not None:
        xr = {c.name: c for c in gather_frame(right._columns, extra)} if right.width else {}
        extra_cols = [_null_column(c, extra.shape[0]) for c in cols]
    for src, c in zip(right._columns, rcols):
        name = src.name
        if coalesce and how != "right" and name in right_keys:
            lk = left_keys[right_keys.index(name)]
            at = next((i for i, x in enumerate(cols) if x.name == lk), None)
            if at is not None:
                if how == "full":
                    cols[at] = _coalesce_cols(cols[at], c)
                    extra_cols[at] = _renamed(xr[name], lk)
                continue
        out_name = name + suffix if any(x.name == name for x in cols) else name
        cols.append(_renamed(c, out_name))
        if extra_cols is not None:
            extra_cols.append(_renamed(xr[name], out_name))
    out = DataFrame._from_columns(cols, n, device=left.device)
    if extra_cols is not None and extra.shape[0]:
        out = concat([out, DataFrame._from_columns(extra_cols, extra.shape[0], device=left.device)],
                     how="vertical_relaxed")
    return out


# ---------------------------------------------------------------------------
# range joins: the iejoin analogue
# ---------------------------------------------------------------------------


def _range_values(col: Column, other: Column) -> tuple[torch.Tensor, torch.Tensor | None] | None:
    """(int64 words whose order is the key's, validity or None) of one
    range-join key against the other side's, or None where the pair cannot
    be ordered on the card (then the caller crosses and filters).
    Dictionary codes compare in one sorted code space; floats become
    order-preserving words with NaN, which matches nothing, invalid; an int
    against a float compares as f64; a Date against a Datetime, or two time
    units, in their supertype's ticks. Datetimes of two time zones raise."""
    d, od = col.dtype, other.dtype
    values, ok = col.buffer.values, col.buffer.validity
    if col.table is not None:
        if other.table is None:
            return None
        if other.table is col.table:
            _, mapping = col.table.ordinal()
        else:
            _, mapping, _ = strtable.unify(col.table, other.table, require_ordinal=True)
        return (values if len(mapping) == 0 else take_lut(mapping, values)).to(torch.int64), ok
    if other.table is not None or not (d.is_numeric() or d.is_temporal() or isinstance(d, dt.Boolean)):
        return None
    if d.is_float() or od.is_float():
        if not (od.is_numeric() and d.is_numeric()) or dt.UInt64() in (d, od):
            return None
        v = float_values(values, d, torch.float64)
        nan = torch.isnan(v)
        return key_words(v, dt.Float64())[0], ~nan if ok is None else (ok & ~nan)
    if isinstance(d, dt.UInt64) or isinstance(od, dt.UInt64):
        return (order_word(values, d), ok) if d == od else None
    if d.is_temporal() or od.is_temporal():
        if isinstance(d, dt.Datetime) and isinstance(od, dt.Datetime) and d.time_zone != od.time_zone:
            # as Polars' dtype check: keys of one zone compare their UTC instants
            raise InvalidOperationError(f"range join keys of two time zones: {d!r} and {od!r}")
        if d == od:
            return values.to(torch.int64), ok
        if {type(d).__name__, type(od).__name__} not in ({"Datetime"}, {"Duration"}, {"Date", "Datetime"}):
            return None
        st = supertype(d, od)  # Date against Datetime, or two time units: the finer one's ticks
        if isinstance(d, dt.Date):
            return values.to(torch.int64) * (dt.TICKS_PER_SECOND[st.time_unit] * 86_400), ok
        return tu_convert(values, d.time_unit, st.time_unit), ok
    return values.to(torch.int64), ok


_FLIP_OP = {"<": ">", "<=": ">=", ">": "<", ">=": "<="}


def _range_bounds(lw, lok, rw, rok, op: str):
    """The right rows sorted by key (stable: ties in row order; rows without
    a key last), and for each left row the start and the count of its
    matches ``lw <op> rw`` in that order."""
    perm, sk, n_valid = _sort_side(rw, rok)
    n = sk.shape[0] if n_valid is None else n_valid
    if op in ("<", "<="):  # the right keys above (from) the left key
        start = torch.searchsorted(sk, lw, right=op == "<")
        end = torch.full_like(start, n) if n_valid is None else n_valid.expand(start.shape)
    else:  # the right keys below (up to) the left key
        start = torch.zeros(lw.shape, dtype=torch.int64, device=lw.device)
        end = torch.searchsorted(sk, lw, right=op == ">=")
        end = end.clamp(max=n) if n_valid is None else torch.minimum(end, n_valid)
    counts = (end - start).clamp(min=0)
    if lok is not None:
        counts = torch.where(lok, counts, 0)
    return perm, start, counts


def range_join_frames(left: DataFrame, right: DataFrame, l_key: Column, r_key: Column, op: str,
                      suffix: str) -> DataFrame | None:
    """The pairs of a join on one inequality ``l_key <op> r_key`` (Polars'
    iejoin, driven by one sorted side): the right keys are sorted once,
    every left row binary-searches its matching run, and the counts expand
    into exactly their total of pairs (one host read), each left row in
    order with its right rows in key order. None where the keys cannot be
    ordered on the card."""
    lk, rk = _range_values(l_key, r_key), _range_values(r_key, l_key)
    if lk is None or rk is None:
        return None
    perm, start, counts = _range_bounds(*lk, *rk, op)
    total = int(counts.sum())
    li, ri, _, _ = _expand(counts, counts, start, perm, total)
    names = set(left.columns)
    cols = gather_frame(left._columns, li)
    cols += [_renamed(c, c.name + suffix if c.name in names else c.name) for c in gather_frame(right._columns, ri)]
    return DataFrame._from_columns(cols, total, device=left.device)


# ---------------------------------------------------------------------------
# asof joins
# ---------------------------------------------------------------------------



def _tolerance_ticks(tol, key_dtype: dt.DataType) -> int:
    """A duration string ("1s", "2h30m") or a ``timedelta`` as ticks of the
    asof key's unit: days for a Date (a whole number of them), the time
    unit of a Datetime or Duration, nanoseconds for a Time. Calendar units
    (mo, q, y) are no fixed duration and raise."""
    if isinstance(tol, _pydt.timedelta):
        total_ns = ((tol.days * 86_400 + tol.seconds) * 1_000_000 + tol.microseconds) * 1_000
    else:
        parts = re.findall(r"(\d+)(ns|us|ms|s|m|h|d|w)", tol)
        if not parts or "".join(n + u for n, u in parts) != tol.replace(" ", ""):
            raise InvalidOperationError(
                f"cannot parse tolerance {tol!r} (calendar units mo/q/y are not fixed durations and are unsupported)")
        total_ns = sum(int(n) * _UNIT_NS[u] for n, u in parts)
    if isinstance(key_dtype, dt.Date):
        if total_ns % _UNIT_NS["d"]:
            raise InvalidOperationError(f"tolerance {tol!r} is not a whole number of days for Date keys")
        return total_ns // _UNIT_NS["d"]
    if isinstance(key_dtype, (dt.Datetime, dt.Duration)):
        return total_ns // (1_000_000_000 // dt.TICKS_PER_SECOND[key_dtype.time_unit])
    if isinstance(key_dtype, dt.Time):
        return total_ns
    raise InvalidOperationError(f"duration-string tolerance requires a temporal asof key, got {key_dtype!r}")


def asof_match(lk: torch.Tensor, rk: torch.Tensor, rmask: torch.Tensor, strategy: str, tolerance):
    """(right row, matched) of each left key: the right keys are sorted once
    (stable; unusable rows last), and each left key finds the last right key
    at or below it (backward), the first at or above it (forward) or the
    nearer of the two, the earlier on a tie (nearest); beyond ``tolerance``
    it matches nothing."""
    nr = rk.shape[0]
    big = torch.full((), _BIG if not rk.dtype.is_floating_point else float("inf"), dtype=rk.dtype, device=rk.device)
    rk_m = torch.where(rmask, rk, big)
    sperm = stable_argsort_words(key_words(rk_m, dt.Float64() if rk.dtype.is_floating_point else dt.Int64()))
    sk = rk_m.index_select(0, sperm)
    pos_right = torch.searchsorted(sk, lk, right=True)
    pos_left = torch.searchsorted(sk, lk)
    n_valid = rmask.sum()
    prev, nxt = pos_right - 1, pos_left
    has_prev, has_next = prev >= 0, nxt < n_valid
    if strategy == "backward":
        idx, ok = prev, has_prev
    elif strategy == "forward":
        idx, ok = nxt, has_next
    else:
        d_prev = lk - sk.index_select(0, prev.clamp(0, nr - 1))
        d_next = sk.index_select(0, nxt.clamp(0, nr - 1)) - lk
        use_prev = has_prev & (~has_next | (d_prev <= d_next))
        idx, ok = torch.where(use_prev, prev, nxt), has_prev | has_next
    idx = idx.clamp(0, nr - 1)
    if tolerance is not None:
        ok = ok & ((lk - sk.index_select(0, idx)).abs() <= tolerance)
    return sperm.index_select(0, idx), ok


def asof_join_frames(left: DataFrame, right: DataFrame, left_on: str, right_on: str, strategy: str, suffix: str,
                     tolerance, by_left: list[str] | None = None, by_right: list[str] | None = None) -> DataFrame:
    """Every left row, in order, with the columns of its asof match in the
    right frame (nulls where there is none). A null key matches nothing on
    either side: the JAX package matches a right row with a null key as
    its stored 0 (ROADMAP §3). Keys of two dtypes, one of them temporal,
    raise, as in Polars. With ``by``, left and right rows of one group
    (``_side_keys``, ranked among the right side's groups) are searched
    together through a composite key ``group * K + (t - tmin)``, K greater
    than any time distance in the data and the tolerance: the time span is
    one host read, and a span times group count past 2^62 raises."""
    lcol, rcol = left._get(left_on), right._get(right_on)
    if lcol.dtype != rcol.dtype and (lcol.dtype.is_temporal() or rcol.dtype.is_temporal()):
        # days against ticks, or ticks of two units, would compare as raw integers
        raise InvalidOperationError(f"asof join keys must have one dtype, got {lcol.dtype!r} and {rcol.dtype!r}")
    if isinstance(tolerance, (str, _pydt.timedelta)):
        tolerance = _tolerance_ticks(tolerance, lcol.dtype)
    is_float = lcol.dtype.is_float() or rcol.dtype.is_float()
    if is_float:
        lk, rk = float_values(lcol.buffer.values, lcol.dtype, torch.float64), float_values(
            rcol.buffer.values, rcol.dtype, torch.float64)
    else:
        lk, rk = lcol.buffer.values.to(torch.int64), rcol.buffer.values.to(torch.int64)
    dev = lk.device
    lmask = torch.ones(left.height, dtype=torch.bool, device=dev)
    rmask = torch.ones(right.height, dtype=torch.bool, device=dev)
    if lcol.buffer.validity is not None:
        lmask &= lcol.buffer.validity
    if rcol.buffer.validity is not None:
        rmask &= rcol.buffer.validity
    if is_float:
        lmask &= ~torch.isnan(lk)
        rmask &= ~torch.isnan(rk)
    gl = gr = None
    if by_left:
        if is_float:
            raise InvalidOperationError("asof join `by` needs an integer or temporal `on` key, not a float one")
        lcols, rcols = [left._get(n) for n in by_left], [right._get(n) for n in by_right]
        gl_h, lusable, _ = _side_keys(lcols, rcols, False)
        gr_h, rusable, _ = _side_keys(rcols, lcols, False)
        if lusable is not None:
            lmask &= lusable
        if rusable is not None:
            rmask &= rusable
        # each side's group as its rank among the right side's group words;
        # a left group no right row has matches nothing
        sorted_gr = torch.sort(torch.where(rmask, gr_h, _BIG)).values
        gl = torch.searchsorted(sorted_gr, gl_h)
        gr = torch.searchsorted(sorted_gr, gr_h)
        if right.height:
            lmask &= sorted_gr.index_select(0, gl.clamp(max=right.height - 1)) == gl_h
        imax = torch.iinfo(torch.int64).max
        pad = torch.full((1,), imax, device=dev)  # for empty sides
        lo = torch.cat([torch.where(lmask, lk, imax), torch.where(rmask, rk, imax), pad]).min()
        neg_hi = torch.cat([torch.where(lmask, -lk, imax), torch.where(rmask, -rk, imax), pad]).min()
        tmin, tmax = torch.stack([lo, -neg_hi]).tolist()  # one host read: the span sizes the composite key
        span = max(tmax - tmin, 0)
        k = span + 2 * abs(int(tolerance or 0)) + 4
        if (right.height + 2) * k >= 1 << 62:
            raise InvalidOperationError(
                "asof join `by`: time span times group count exceeds the composite key range; "
                "pre-partition the frames instead")
        lk = torch.where(lmask, gl * k + (lk - tmin), 0)
        rk = torch.where(rmask, gr * k + (rk - tmin), 0)
    if right.height:
        ridx, ok = asof_match(lk, rk, rmask, strategy, tolerance)
        ok &= lmask
        if gl is not None:  # a match across a group boundary is none
            ok &= gr.index_select(0, ridx) == gl
    else:
        ridx = torch.zeros(left.height, dtype=torch.int64, device=dev)
        ok = torch.zeros(left.height, dtype=torch.bool, device=dev)
    names = set(left.columns)
    skip = {right_on, *(by_right or [])}
    rcols = [c for c in right._columns if c.name not in skip]
    cols = list(left._columns)
    cols += [_renamed(c, c.name + suffix if c.name in names else c.name) for c in gather_frame(rcols, ridx, ok)]
    return DataFrame._from_columns(cols, left.height, device=left.device)

"""In-segment equi-joins (the port of ``polars_tpu/engine/join_traced.py``).

When the user declares ``validate="m:1"`` (or 1:1) each probe row matches at
most one build row, so the join is a row-wise op: sort the build side by its
key word, binary-search every probe key into it (``torch.searchsorted``,
left and right), gather the build columns at the first candidate and fold
the match into the segment's row mask. An inner ``validate="1:m"`` join
flips the roles: the right side probes and the (unique) left side builds.
Semi and anti joins only narrow the left row mask. No host sync: the join
runs inside the segment like a filter.

The declared cardinality is checked on the device (a matched key whose build
run is longer than one row) and the flag rides the segment's count read-back,
so a wrong ``validate`` fails at collect instead of joining wrongly.
"""

from __future__ import annotations

import torch

from polars_tpu_torch import datatypes as dt
from polars_tpu_torch.engine import groupby as G
from polars_tpu_torch.engine.cast import order_word
from polars_tpu_torch.engine.common import Val, take_lut
from polars_tpu_torch.errors import InvalidOperationError
from polars_tpu_torch.kernels.argsort import stable_argsort_words
from polars_tpu_torch.kernels.hashing import combine_hashes, hash_column
from polars_tpu_torch.plan import exprs as E
from polars_tpu_torch.utils import strtable

_BIG = 0x7FFFFFFFFFFFFFFF  # key word of masked build rows; masked probe rows take _BIG - 1


def _take(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``t[idx]``; zeros where ``t`` is empty (a build side of no rows, whose
    candidates are all unmatched)."""
    if t.shape[0] == 0:
        return torch.zeros(idx.shape, dtype=t.dtype, device=idx.device)
    return t.index_select(0, idx)


def _key_word(v: Val, other: Val) -> tuple[torch.Tensor, torch.Tensor | None, bool]:
    """(int64 key word, validity, exact) of one key column; ``exact`` means
    equal words imply equal keys (no verification needed)."""
    if isinstance(v.dtype, dt.Null):
        shape = v.values.shape
        return (torch.zeros(shape, dtype=torch.int64, device=v.values.device),
                torch.zeros(shape, dtype=torch.bool, device=v.values.device), True)
    if v.table is not None:
        if other.table is not None and other.table is not v.table:
            # both sides' codes in the merged dictionary's code space (the
            # merge is canonical: unify(A, B) and unify(B, A) agree)
            _, lmap, _ = strtable.unify(v.table, other.table)
            if len(lmap) == 0:  # an empty remap is the identity
                return v.values.to(torch.int64), v.validity, True
            return take_lut(lmap, v.values).to(torch.int64), v.validity, True
        return v.values.to(torch.int64), v.validity, True
    if v.dtype.is_float():
        return hash_column(v.values, v.validity, 13), v.validity, False
    if isinstance(v.dtype, dt.Decimal):  # scaled integers, at the larger scale of the two sides
        s = max(v.dtype.scale, other.dtype.scale if isinstance(other.dtype, dt.Decimal) else 0)
        return v.values.to(torch.int64) * 10 ** (s - v.dtype.scale), v.validity, True
    if isinstance(v.dtype, dt.Boolean) or v.dtype.is_integer() or v.dtype.is_temporal():
        # UInt64 bit patterns in unsigned order (the JAX package's total_order_key)
        return order_word(v.values.to(torch.int64), v.dtype), v.validity, True
    raise InvalidOperationError(f"cannot join on dtype {v.dtype!r}")


def _values_equal(lv: Val, rv_g: torch.Tensor, rvalid_g, lvalid, nulls_equal: bool) -> torch.Tensor:
    """Per-row equality of a probe key against the gathered build key
    (Polars total equality: NaN == NaN)."""
    same = lv.values == rv_g
    if lv.dtype.is_float():
        same = same | (torch.isnan(lv.values) & torch.isnan(rv_g))
    lnull = torch.zeros_like(same) if lvalid is None else ~lvalid
    rnull = torch.zeros_like(same) if rvalid_g is None else ~rvalid_g
    if nulls_equal:
        return torch.where(lnull | rnull, lnull & rnull, same)
    return same & ~lnull & ~rnull


def _side_key(words, other_words, rowmask: torch.Tensor,
              nulls_equal: bool) -> tuple[torch.Tensor, torch.Tensor, bool]:
    """(one int64 key per row, rows that may match, exact) of one side. With
    ``nulls_equal`` a single key is hashed (null a key of its own) when
    either side has nulls, so that both sides hash alike (the JAX package
    decides per side, and a side without nulls then never matches)."""
    if len(words) == 1:
        w, valid = words[0]
        if nulls_equal and (valid is not None or other_words[0][1] is not None):
            return hash_column(w, valid, 7), rowmask, False
        if valid is None:
            return w, rowmask, True
        return w, rowmask & valid, True
    h = None
    all_valid = None
    for w, valid in words:
        hc = hash_column(w, valid, 7)
        h = hc if h is None else combine_hashes(h, hc)
        if valid is not None:
            all_valid = valid if all_valid is None else (all_valid & valid)
    mask = rowmask
    if not nulls_equal and all_valid is not None:
        mask = mask & all_valid
    return h, mask, False


def trace_join(node, tt_l, tt_r, eval_key):
    """Run an m:1 / 1:1 / (inner) 1:m equi-join, or a semi/anti join, inside
    a segment. Returns (cols, rowmask, bad): ``bad`` is a 0-d bool tensor,
    True where the keys break the declared cardinality. ``eval_key(expr, tt)``
    evaluates one key expression against one side. For 1:m the probe is the
    right side; the inner join's row order is unspecified, as in Polars'
    ``maintain_order="none"``."""
    nulls_equal = node.nulls_equal
    flip = node.validate == "1:m"
    if flip:
        tt_probe, tt_build = tt_r, tt_l
        probe_on, build_on = node.right_on, node.left_on
    else:
        tt_probe, tt_build = tt_l, tt_r
        probe_on, build_on = node.left_on, node.right_on
    lkeys = [eval_key(e, tt_probe) for e in probe_on]
    rkeys = [eval_key(e, tt_build) for e in build_on]
    lwords, rwords, exact_all = [], [], True
    for lv, rv in zip(lkeys, rkeys):
        lw, lval, lex = _key_word(lv, rv)
        rw, rval, rex = _key_word(rv, lv)
        lwords.append((lw, lval))
        rwords.append((rw, rval))
        exact_all = exact_all and lex and rex

    lk, lmask, l_exact = _side_key(lwords, rwords, tt_probe.rowmask, nulls_equal)
    rk, rmask, r_exact = _side_key(rwords, lwords, tt_build.rowmask, nulls_equal)
    needs_verify = not (exact_all and l_exact and r_exact)

    # build side sorted by key word, masked rows at the end
    nr = rk.shape[0]
    rk_m = torch.where(rmask, rk, _BIG)
    sperm = stable_argsort_words([rk_m])
    sk = rk_m.index_select(0, sperm)
    lk_m = torch.where(lmask, lk, _BIG - 1)
    lo = torch.searchsorted(sk, lk_m, side="left")
    hi = torch.searchsorted(sk, lk_m, side="right")
    cand_pos = lo.clamp(0, max(nr - 1, 0))
    cand = _take(sperm, cand_pos)
    matched = (_take(sk, cand_pos) == lk_m) & lmask & (lo < nr)

    if needs_verify:
        # hashed candidates verified on the key values row by row; dictionary
        # keys compare on their unified key words (raw codes of two
        # dictionaries live in different code spaces)
        for i, (lv, rv) in enumerate(zip(lkeys, rkeys)):
            if lv.table is not None or rv.table is not None:
                lw, lval = lwords[i]
                rw, rval = rwords[i]
                lv_cmp = Val(lw, lval, dt.Int64(), None, lv.domain)
                rvalid_g = None if rval is None else _take(rval, cand)
                matched = matched & _values_equal(lv_cmp, _take(rw, cand), rvalid_g, lval, nulls_equal)
                continue
            rvalid_g = None if rv.validity is None else _take(rv.validity, cand)
            matched = matched & _values_equal(lv, _take(rv.values, cand), rvalid_g, lv.validity, nulls_equal)

    # cardinality check: a matched probe key whose build run is longer than 1
    # (not for unvalidated semi/anti joins, where multiplicity is fine)
    if node.validate in ("m:1", "1:1", "1:m"):
        bad = (matched & ((hi - lo) > 1)).any()
    else:
        bad = torch.zeros((), dtype=torch.bool, device=matched.device)
    if node.validate == "1:1" and node.how in ("inner", "left") and nr:
        # and no two probe rows may share a matched build row (a K1 count)
        hits = G.seg_count(matched, cand.to(torch.int32), nr)
        bad = bad | (hits > 1).any()

    how = node.how
    if how == "semi":
        return dict(tt_l.cols), tt_l.rowmask & matched, bad
    if how == "anti":
        return dict(tt_l.cols), tt_l.rowmask & ~matched, bad

    coalesce = True if node.coalesce is None else node.coalesce
    right_key_names = {E.output_name(e) for e in node.right_on}
    left_names = set(tt_l.cols)

    def gather(v: Val) -> tuple[torch.Tensor, torch.Tensor | None]:
        validity = None if v.validity is None else _take(v.validity, cand)
        return _take(v.values, cand), validity

    cols: dict[str, Val] = {}
    if flip:
        # probe = right rows; left columns come from the (unique) build side
        for name, v in tt_l.cols.items():
            values, validity = gather(v)
            cols[name] = v.with_(values=values, validity=validity)
        for name, v in tt_r.cols.items():
            if coalesce and name in right_key_names:
                continue
            cols[name + node.suffix if name in left_names else name] = v
        return cols, tt_r.rowmask & matched, bad

    cols = dict(tt_l.cols)
    for name, v in tt_r.cols.items():
        if coalesce and name in right_key_names:
            continue
        values, validity = gather(v)
        if how == "left":
            validity = matched if validity is None else (validity & matched)
        cols[name + node.suffix if name in left_names else name] = v.with_(values=values, validity=validity)
    rowmask = tt_l.rowmask & matched if how == "inner" else tt_l.rowmask
    return cols, rowmask, bad

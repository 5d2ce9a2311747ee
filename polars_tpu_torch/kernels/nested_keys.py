"""List, Array and Struct values by their content: order words, ranks and
hashes (no counterpart in ``polars_tpu``, which orders, groups and hashes a
nested value by the word that indexes its child).

A nested value is a word into its child (``engine/common.Val.child``): the
packed ``(start << 32) | length`` of a List or Array, the row id of a
Struct. Two equal contents may sit at different places of the child, so
every ordering, grouping, distinct or hashing consumer asks this module for
words of the content instead (:func:`val_words`).

The order is Polars': a Struct compares field by field; a List or Array
element by element, a list that is a prefix of another first; a null field
or element is the least value at its place. ``descending`` reverses the
whole order (its nested nulls come last); ``nulls_last`` places the top
level's null values and is the caller's (``engine/sort.py``).

- **Struct**: per field, a null word (where the field has nulls) and the
  field's own words, zeroed under a null, recursively.
- **List and Array**: one **content rank** per value (an integer below
  the number of values), by one of two ways, chosen by the longest length
  and the number of elements (:func:`_refines`):
  - by refinement over positions (:func:`_refine`). Every value starts
    in one bucket of rank 0. At pass j only the lists longer than j take
    part: each is sorted by (its rank so far, the words of its element
    j); those that end at j stay at the head of their bucket, and the
    others take the bucket's head plus the count that ended plus their
    offset in the sorted bucket. The passes
    sort ``sum(lengths)`` rows in all, in ``longest`` passes of about 30
    launches each;
  - by prefix doubling over the elements laid end to end
    (:func:`_double`), as a suffix array is built: pass 0 ranks each
    element by its words, from 1 up; pass k ranks each element's window of
    2^k elements, cut at its list's end, by the pair (the rank of its first
    half, the rank of the half 2^(k-1) further on, 0 where that lies past
    the list's end), so that a list that is a prefix of another comes
    first. ceil(log2(longest)) passes, each one int64 sort of all the
    elements; a list's rank is its first element's window's, made dense
    by one sort of the lists.

  Refinement sorts fewer and narrower rows, doubling takes fewer passes:
  short lists over many elements refine, long lists or few elements
  double. One host read sizes either: the longest length, the element
  count and the number of lists longer than each j below
  ``_REFINE_MAX``, from one sort of the lengths.
- **Equality across two values** (``==`` of two List columns, a nested
  value ``is_in`` a List): both are ranked together over one child
  (:func:`joint_words`); two ranks made apart are not comparable.
- **Hash** (:func:`content_hash`): never by rank, which depends on the
  frame. Each element's hash is weighted by ``B ** position`` and summed
  per list with wrapping int64 arithmetic, from a prefix sum over the child
  (no host read; the powers from two small tables made on the host); the
  length and validity are mixed in last, so equal contents hash equal in
  any frame.
"""

from __future__ import annotations

import functools
from typing import TYPE_CHECKING, Callable

import numpy as np
import torch

from polars_tpu_torch import datatypes as dt
from polars_tpu_torch.kernels.argsort import boundaries_from_words, key_words, stable_argsort_words
from polars_tpu_torch.kernels.hashing import _NULL_HASH, combine_hashes, splitmix64

if TYPE_CHECKING:
    from polars_tpu_torch.engine.common import Val

_LEN_MASK = 0xFFFFFFFF
_HASH_BASE = 0x100000001B3  # odd, so invertible modulo 2^64
_U64 = 1 << 64


def _zero_under(words: list[torch.Tensor], validity: torch.Tensor | None) -> list[torch.Tensor]:
    if validity is None:
        return words
    return [torch.where(validity, w, torch.zeros((), dtype=w.dtype, device=w.device)) for w in words]


def _null_words(v: Val) -> list[torch.Tensor]:
    """A null word (null 0 < valid 1) and ``v``'s words zeroed under a
    null: the order of a value at a nested place, its null least (an
    unordered dictionary's codes as ranks of their text)."""
    if v.table is not None:
        from polars_tpu_torch.engine.strings import ensure_ordinal_val

        v = ensure_ordinal_val(v)
    words = val_words(v)
    if v.validity is None:
        return words
    return [v.validity.to(torch.int8), *_zero_under(words, v.validity)]


def val_words(v: Val, *, descending: bool = False) -> list[torch.Tensor]:
    """Order words of ``v``'s values, most significant first, whatever its
    dtype: ``kernels/argsort.key_words`` of a flat value (a dictionary's
    codes as they are: an ordering caller makes them ordinal first), the
    content words of a nested one. The top level's validity is the
    caller's."""
    if not v.dtype.is_nested():
        return key_words(v.values, v.dtype, descending=descending)
    if isinstance(v.dtype, dt.Struct):
        words = []
        for f in struct_fields(v):
            words.extend(_null_words(f))
    else:
        words = [list_rank(v)]
    return [torch.bitwise_not(w) for w in words] if descending else words


def struct_fields(v: Val) -> list[Val]:
    """A Struct value's fields at its rows (ids clamped into the fields, so
    that a null row's id reads some row)."""
    ids = v.values.to(torch.int64)
    out = []
    for f in v.child or ():
        n = f.values.shape[0]
        i = ids.clamp(0, max(n - 1, 0))
        if n == 0:
            out.append(f.with_(values=torch.zeros(ids.shape, dtype=f.values.dtype, device=ids.device),
                               validity=torch.zeros(ids.shape, dtype=torch.bool, device=ids.device)))
            continue
        out.append(f.with_(values=f.values.index_select(0, i),
                           validity=None if f.validity is None else f.validity.index_select(0, i)))
    return out


def _starts_lens(v: Val) -> tuple[torch.Tensor, torch.Tensor]:
    x = v.values.to(torch.int64)
    lens = x & _LEN_MASK
    if v.validity is not None:
        lens = torch.where(v.validity, lens, 0)
    return x >> 32, lens


def _dense_rank(words: list[torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
    """The dense rank (0 up) of each row's words: one stable sort."""
    perm = stable_argsort_words(words)
    dense = torch.cumsum(boundaries_from_words(words, perm), 0) - 1
    return torch.empty(perm.shape[0], dtype=dtype, device=perm.device).index_copy_(0, perm, dense.to(dtype))


def _last_marked(marked: torch.Tensor) -> torch.Tensor:
    """The last marked position at or before each position (the first is
    marked): one ``cumsum`` and one scatter of the marked positions by their
    rank (``torch.cummax`` is a sequential scan on the card)."""
    n = marked.shape[0]
    count = torch.cumsum(marked, 0) - 1  # each position's run
    pos = torch.zeros(n + 1, dtype=torch.int64, device=marked.device)
    pos.index_copy_(0, torch.where(marked, count, n), torch.arange(n, dtype=torch.int64, device=marked.device))
    return pos.index_select(0, count)


# A List ranks by refinement while its passes cost less than doubling's: a
# refinement pass is some 30 launches whatever its size (about 1.1 ms on an
# H100), a doubling pass one sort of every element (about 0.22 ns an
# element there); ``testing/bench_list_rank.py`` times both. Past
# ``_REFINE_MAX`` positions a List always doubles.
_PASS_ELEMENTS = 1 << 22  # the elements a doubling pass sorts in a refinement pass's time
_REFINE_MAX = 256


def _refines(longest: int, total: int) -> bool:
    """Whether refinement (``longest`` passes) costs less than doubling
    (ceil(log2(longest)) passes, one ranking of the elements and one of the
    lists, each over ``total`` elements at most)."""
    return longest <= _REFINE_MAX and longest * _PASS_ELEMENTS <= total * ((longest - 1).bit_length() + 2)


def list_rank(v: Val) -> torch.Tensor:
    """The content rank of each List or Array value of ``v``, below the
    number of values (int32 below 2^31 elements, so that its radix sorts
    take half the passes): equal contents share a rank, and rank order is
    content order (a null top-level value ranks as an empty list; the
    caller's null word separates it)."""
    starts, lens = _starts_lens(v)
    n, dev = lens.shape[0], lens.device
    if n == 0:
        return torch.zeros(0, dtype=torch.int32, device=dev)
    by_len = torch.sort(lens, stable=True)
    longer = n - torch.searchsorted(by_len.values, torch.arange(_REFINE_MAX, device=dev), right=True)
    # the one host read: the longest length, the element count, the lists longer than j
    longest, total, *longer = torch.cat([by_len.values[-1:], lens.sum().reshape(1), longer]).tolist()
    rdt = torch.int32 if max(n, v.child.values.shape[0], total) < 2**31 - 2 else torch.int64
    if longest == 0:
        return torch.zeros(n, dtype=rdt, device=dev)
    elem = _null_words(v.child) or [torch.zeros(v.child.values.shape[0], dtype=torch.int8, device=dev)]
    if _refines(longest, total):
        return _refine(starts, elem, by_len.indices.flip(0), longer[:longest], rdt)
    return _double(starts, lens, elem, longest, total, rdt)


def _refine(starts: torch.Tensor, elem: list[torch.Tensor], order: torch.Tensor, longer: list[int],
            rdt: torch.dtype) -> torch.Tensor:
    """Ranks by refinement over positions: at pass j the lists longer than
    j (``longer[j]``, the head of ``order``, longest first) are sorted by
    (rank so far, element j's words); a list that ends at j keeps its
    bucket's head, the others take the head plus the count that ended plus
    their offset in the bucket."""
    n = order.shape[0]
    rank = torch.zeros(n, dtype=rdt, device=order.device)
    for j, a in enumerate(longer):
        b = longer[j - 1] if j else n
        act = order[:a]
        r = rank.index_select(0, act)
        idx = starts.index_select(0, act) + j
        words = [r, *(w.index_select(0, idx) for w in elem)]
        perm = stable_argsort_words(words)
        rs = r.index_select(0, perm)
        ended = torch.sort(rank.index_select(0, order[a:b])).values  # the lists of length j end here
        n_ended = (torch.searchsorted(ended, rs, right=True) - torch.searchsorted(ended, rs)) if b > a else 0
        sub = _last_marked(boundaries_from_words(words, perm))
        head = _last_marked(boundaries_from_words([r], perm))
        rank.index_copy_(0, act.index_select(0, perm), (rs + n_ended + (sub - head)).to(rdt))
    return rank


def _double(starts: torch.Tensor, lens: torch.Tensor, elem: list[torch.Tensor], longest: int, total: int,
            rdt: torch.dtype) -> torch.Tensor:
    """Dense ranks by prefix doubling over the elements laid end to end:
    pass k ranks each element's window of 2^k, cut at its list's end, by
    (its first half's rank, its second half's or 0 past the end)."""
    n, dev = lens.shape[0], lens.device
    stop = torch.cumsum(lens, 0)
    first = stop - lens
    at = torch.arange(total, device=dev)
    owner = torch.searchsorted(stop, at, right=True)  # one thread per element, however long its list
    stop = stop.index_select(0, owner)
    place = starts.index_select(0, owner) + (at - first.index_select(0, owner))  # each element in the child
    r = (_dense_rank(elem, rdt) + 1).index_select(0, place)
    h = 1
    while h < longest:
        nxt = at + h
        second = torch.where(nxt < stop, r.index_select(0, nxt.clamp(max=total - 1)), 0)
        r = _dense_rank([(r.to(torch.int64) << 32) | second.to(torch.int64)], rdt) + 1
        h *= 2
    return _dense_rank([torch.where(lens > 0, r.index_select(0, first.clamp(max=total - 1)), 0)], rdt)


def rank_rows(rank: torch.Tensor, valid: torch.Tensor | None) -> torch.Tensor:
    """For each content rank ``r`` below the row count, the first
    ``valid`` row that holds it (the row count where none does): a content
    extreme's rank back to a value, child and all. Null rows rank as an
    empty value, so they are left out."""
    n = rank.shape[0]
    rows = torch.arange(n, dtype=torch.int64, device=rank.device)
    key = rank.to(torch.int64) if valid is None else torch.where(valid, rank.to(torch.int64), n)
    return torch.full((n + 1,), n, dtype=torch.int64, device=rank.device).scatter_reduce_(0, key, rows, "amin")


def content_rank(v: Val) -> torch.Tensor:
    """The content rank (int64, below the row count) of each row: a
    List's or Array's :func:`list_rank`, a Struct's field words collapsed
    by one sort."""
    if not isinstance(v.dtype, dt.Struct):
        return list_rank(v).to(torch.int64)
    words = val_words(v)
    if not words or v.values.shape[0] == 0:
        return torch.zeros(v.values.shape[0], dtype=torch.int64, device=v.values.device)
    return _dense_rank(words, torch.int64)


def joint_words(vals: list[Val], dtype: dt.DataType) -> list[list[torch.Tensor]]:
    """Content words of several nested values, each cast to ``dtype``, made
    together over one child (so that equal contents in any of them have
    equal words), split back per value."""
    from polars_tpu_torch.engine.strings import concat_vals

    both = concat_vals([x.with_(validity=None) for x in vals], dtype)
    words = val_words(both)
    out, at = [], 0
    for x in vals:
        n = x.values.shape[0]
        out.append([w[at:at + n] for w in words])
        at += n
    return out


_LO_BITS = 13


@functools.lru_cache(maxsize=16)
def _power_tables(base: int, n_hi: int) -> tuple[np.ndarray, np.ndarray]:
    """``base ** i`` and ``base ** (i << _LO_BITS)`` modulo 2^64 for the
    low and high parts of an exponent (int64 bit patterns; numpy's uint64
    products wrap)."""
    def powers(b: int, n: int) -> np.ndarray:
        out = np.ones(n, np.uint64)
        if n > 1:
            out[1:] = np.cumprod(np.full(n - 1, b, np.uint64))
        return out.view(np.int64)

    return powers(base, 1 << _LO_BITS), powers(pow(base, 1 << _LO_BITS, _U64), n_hi)


def _powers(exp: torch.Tensor, base: int, top: int) -> torch.Tensor:
    """``base ** exp`` modulo 2^64 (int64 bit patterns) for ``0 <= exp <=
    top``: the product of two lookups, the exponent's low 13 bits and the
    rest, in tables made once on the host (no host read)."""
    lo, hi = _power_tables(base, (top >> _LO_BITS) + 1)
    lo_t, hi_t = torch.from_numpy(lo).to(exp.device), torch.from_numpy(hi).to(exp.device)
    return hi_t.index_select(0, exp >> _LO_BITS) * lo_t.index_select(0, exp & ((1 << _LO_BITS) - 1))


def content_hash(v: Val, seed: int, leaf: Callable[[Val, int], torch.Tensor]) -> torch.Tensor:
    """A 64-bit hash (int64 bit patterns) of each nested value's content,
    equal for equal contents in any frame; ``leaf(val, seed)`` hashes a
    flat value (nulls to a sentinel). A null value hashes to the
    sentinel."""

    def value_hash(x: Val) -> torch.Tensor:
        return content_hash(x, seed, leaf) if x.dtype.is_nested() else leaf(x, seed)

    if isinstance(v.dtype, dt.Struct):
        h = splitmix64(torch.full(v.values.shape, seed + len(v.dtype.fields), dtype=torch.int64,
                                  device=v.values.device))
        for f in struct_fields(v):
            h = combine_hashes(h, value_hash(f))
    else:
        starts, lens = _starts_lens(v)
        eh = value_hash(v.child)
        m = eh.shape[0]
        weighted = eh * _powers(torch.arange(m, dtype=torch.int64, device=eh.device), _HASH_BASE, m)
        prefix = torch.zeros(m + 1, dtype=torch.int64, device=eh.device)
        torch.cumsum(weighted, 0, out=prefix[1:])
        s = starts.clamp(0, m)
        e = (starts + lens).clamp(0, m)
        inv = pow(_HASH_BASE, -1, _U64)
        span = (prefix.index_select(0, e) - prefix.index_select(0, s)) * _powers(s, inv, m)
        h = combine_hashes(splitmix64(lens + seed), span)
    if v.validity is not None:
        h = torch.where(v.validity, h, _NULL_HASH)
    return h

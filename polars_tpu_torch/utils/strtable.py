"""Host-side dictionary value tables for String columns.

Copied from ``polars_tpu/utils/strtable.py`` and trimmed to what the ported
queries use (encoding, ``index_in`` and ``unify``). Device tensors only ever hold dense int32 *codes*; the variable-length
UTF-8 payload lives on the host in an immutable ``StringTable``. Codes are
ordinal (code order == lexicographic order), so sorting and comparing codes on
the device matches string semantics.

Encoding is numpy-only: the machine with the card has no pyarrow or pandas.
"""

from __future__ import annotations

import itertools

import numpy as np

# process-monotonic identity tokens: unlike id(), never reused after GC
_NEXT_IDENT = itertools.count(1)


class StringTable:
    """Immutable array of unique UTF-8 values, identity-hashed.

    ``sorted_order``: if True, codes are ordinal — code order ==
    lexicographic order.
    """

    __slots__ = ("values", "sorted_order", "ident", "_unify_cache")

    def __init__(self, values: np.ndarray, *, sorted_order: bool = False) -> None:
        self.values = np.asarray(values, dtype=object)
        self.sorted_order = sorted_order
        self.ident = next(_NEXT_IDENT)
        self._unify_cache: dict | None = None  # other table's ident -> unify() result

    def __len__(self) -> int:
        return len(self.values)

    def __repr__(self) -> str:
        return f"StringTable(n={len(self.values)}, sorted={self.sorted_order})"

    def __hash__(self) -> int:
        return self.ident

    def __eq__(self, other: object) -> bool:
        return self is other

    def take(self, codes: np.ndarray) -> np.ndarray:
        """Decode codes -> object array of strings (codes < 0 -> None)."""
        codes = np.asarray(codes)
        out = np.empty(codes.shape, dtype=object)
        valid = codes >= 0
        out[valid] = self.values[codes[valid]]
        out[~valid] = None
        return out


_EMPTY = StringTable(np.asarray([], dtype=object), sorted_order=True)


def empty_table() -> StringTable:
    return _EMPTY


def encode_strings(values: np.ndarray) -> tuple[np.ndarray, np.ndarray | None, StringTable]:
    """Dictionary-encode an object/str array.

    Returns (codes[int32], validity[bool] or None, table). The table is sorted
    (ordinal codes). None/NaN entries become code 0 with validity False. Same
    codes as ``polars_tpu.utils.strtable.encode_strings`` gives for str input.
    """
    arr = np.asarray(values, dtype=object)
    # elementwise in C: None, and NaN (the one value unequal to itself)
    validity = ~(np.equal(arr, None) | np.not_equal(arr, arr))
    has_null = not validity.all()
    if any(isinstance(v, (bytes, bytearray)) for v in arr[validity][:64]):
        raise NotImplementedError("Binary columns are not ported yet (port queue: expression breadth)")
    # codes by a hash lookup of each value's rank among the sorted distinct
    # values: one pass over the Python strings, where np.unique sorts them
    # all (PERF.md: the set-up of PDS-H's 60M-row string columns)
    vals = (arr[validity] if has_null else arr).reshape(-1).tolist()
    distinct = set(vals)
    if not all(type(v) is str for v in distinct):
        vals = [str(v) for v in vals]
        distinct = set(vals)
    uniques = sorted(distinct) if vals else [""]
    rank = {v: i for i, v in enumerate(uniques)}
    inv = np.fromiter(map(rank.__getitem__, vals), np.int32, count=len(vals))
    if has_null:
        codes = np.zeros(arr.shape, np.int32)
        codes[validity] = inv
    else:
        codes = inv.reshape(arr.shape)
    table = StringTable(np.asarray(uniques, dtype=object), sorted_order=True)
    return codes, (validity if has_null else None), table


def index_in(needles: np.ndarray, haystack: np.ndarray) -> np.ndarray:
    """Position of each needle in ``haystack`` (-1 if absent), int32: a host
    hash probe (the JAX package's ``index_in`` uses pyarrow where it can; the
    machine with the card has none, so this is its dictionary fallback)."""
    needles = np.asarray(needles, dtype=object)
    haystack = np.asarray(haystack, dtype=object)
    if len(needles) == 0:
        return np.empty(0, np.int32)
    lk = {v: i for i, v in enumerate(haystack.tolist())}
    return np.fromiter((lk.get(v, -1) for v in needles.tolist()), np.int32, len(needles))


# sorted-merge unification sorts (l + r) strings on the host; above this size
# unify() switches to the O(l + r) insertion-order merge and returns an
# unordered table (as polars_tpu/utils/strtable.py does)
_UNIFY_SORTED_MAX = 1 << 16


def unify(
    left: StringTable, right: StringTable, *, require_ordinal: bool = False
) -> tuple[StringTable, np.ndarray, np.ndarray]:
    """Merge two tables; returns (merged, left_remap, right_remap).

    The remaps map old codes to new codes; an EMPTY remap means identity. The
    merged table is ordinal when both inputs are sorted and small, or when
    ``require_ordinal`` is set; otherwise it is the insertion-order merge
    anchored on the older table, so that unify(A, B) and unify(B, A) give
    every value the same code (join keys unify each side on its own)."""
    if left is right:
        ident = np.arange(len(left), dtype=np.int32)
        return left, ident, ident
    big = len(left) + len(right) > _UNIFY_SORTED_MAX
    if not require_ordinal and (big or not (left.sorted_order and right.sorted_order)):
        if right.ident < left.ident:
            merged, rmap, lmap = unify(right, left)
            return merged, lmap, rmap
        if left._unify_cache is None:
            left._unify_cache = {}
        hit = left._unify_cache.get(right.ident)
        if hit is not None:
            return hit
        rpos = index_in(right.values, left.values)
        missing = rpos < 0
        n_new = int(missing.sum())
        rmap = rpos.copy()
        if n_new:
            rmap[missing] = len(left) + np.arange(n_new, dtype=np.int32)
            merged = StringTable(np.concatenate([left.values, right.values[missing]]), sorted_order=False)
        else:
            merged = left  # right is a subset of left: keep the left table
        out = (merged, np.empty(0, np.int32), rmap)
        left._unify_cache[right.ident] = out
        return out
    if not (left.sorted_order and right.sorted_order):
        raise NotImplementedError(
            "ordering strings across unordered dictionaries is not ported yet (port queue: rest of PDS-H)"
        )
    lv = left.values.astype(str)
    rv = right.values.astype(str)
    merged, inv = np.unique(np.concatenate([lv, rv]), return_inverse=True)
    inv = inv.astype(np.int32).reshape(-1)
    return StringTable(merged.astype(object), sorted_order=True), inv[: len(lv)], inv[len(lv):]

"""Host-side dictionary value tables for String, Categorical, Enum and
Binary columns.

Copied from ``polars_tpu/utils/strtable.py`` and trimmed to what the port
uses (encoding, ``index_in``, ``unify``, ``StringTable.ordinal``, ``lookup``
and ``find``). Device tensors only ever hold dense int32 *codes*; the
variable-length payload (``str``, or ``bytes`` for Binary) lives on the host
in an immutable ``StringTable``. A dictionary of at most
``config().ordinal_dict_max`` values is sorted, so that code order is
lexicographic order; a larger one keeps its values in the order of their
first occurrence, and an ordering operation sorts it once, when it first
needs to (``engine/strings.ensure_ordinal_val``). Equality, group keys and
join keys work on raw codes either way.

Encoding is Python's and numpy's only: the machine with the card has no
pyarrow or pandas (the JAX package takes its first-occurrence order from
``pyarrow.compute.dictionary_encode``).
"""

from __future__ import annotations

import numpy as np

from polars_tpu_torch.utils.tokens import next_token


class StringTable:
    """Immutable array of unique UTF-8 values, identity-hashed.

    ``sorted_order``: if True, codes are ordinal — code order ==
    lexicographic order.
    """

    __slots__ = ("values", "sorted_order", "ident", "_unify_cache", "_ordinal", "_memo", "_lookup")

    def __init__(self, values: np.ndarray, *, sorted_order: bool = False) -> None:
        self.values = np.asarray(values, dtype=object)
        self.sorted_order = sorted_order
        self.ident = next_token()
        self._unify_cache: dict | None = None  # other table's ident -> unify() result
        self._ordinal: tuple | None = None  # ordinal() of an unordered table, made once
        self._memo: dict | None = None  # memo(): host results over the values, by key
        self._lookup: dict | None = None  # lookup(): value -> code, made once

    def __len__(self) -> int:
        return len(self.values)

    def __repr__(self) -> str:
        return f"StringTable(n={len(self.values)}, sorted={self.sorted_order})"

    def __hash__(self) -> int:
        return self.ident

    def __eq__(self, other: object) -> bool:
        return self is other

    def lookup(self) -> dict:
        """value -> code, made once."""
        if self._lookup is None:
            self._lookup = dict(zip(self.values.tolist(), range(len(self.values))))
        return self._lookup

    def find(self, value) -> int:
        """The code of ``value``, or -1 if absent."""
        return self.lookup().get(value, -1)

    def codes_of(self, values) -> np.ndarray:
        """The code of each of ``values`` (-1 if absent), int32, through the
        table's one lookup dictionary."""
        lk = self.lookup()
        values = list(values)
        return np.fromiter((lk.get(v, -1) for v in values), np.int32, len(values))

    def ordinal(self) -> tuple[StringTable, np.ndarray]:
        """(this table's values sorted, old code -> new code): an unordered
        table sorts on the host once, when an ordering op first needs it."""
        if self.sorted_order:
            return self, np.empty(0, np.int32)  # empty remap = identity
        if self._ordinal is None:
            if len(self.values) and isinstance(self.values[0], (bytes, bytearray)):
                order = np.asarray(sorted(range(len(self.values)), key=self.values.__getitem__), np.int64)
            else:
                order = np.argsort(self.values.astype(str), kind="stable")
            ranks = np.empty(len(order), np.int32)
            ranks[order] = np.arange(len(order), dtype=np.int32)
            self._ordinal = (StringTable(self.values[order], sorted_order=True), ranks)
        return self._ordinal

    def memo(self, key, make):
        """``make()``, made once per ``key`` for this table: a host
        function's results over its values, which never change."""
        if self._memo is None:
            self._memo = {}
        if key not in self._memo:
            self._memo[key] = make()
        return self._memo[key]

    def take(self, codes: np.ndarray) -> np.ndarray:
        """Decode codes -> object array of strings (codes < 0 -> None)."""
        codes = np.asarray(codes)
        out = np.empty(codes.shape, dtype=object)
        valid = codes >= 0
        out[valid] = self.values[codes[valid]]
        out[~valid] = None
        return out


_EMPTY = StringTable(np.asarray([], dtype=object), sorted_order=True)
_ENUM_TABLES: dict = {}


def enum_table(categories) -> StringTable:
    """The one table of an Enum's categories (its codes are their
    positions), made once per category list."""
    key = tuple(str(c) for c in categories)
    if key not in _ENUM_TABLES:
        _ENUM_TABLES[key] = StringTable(np.asarray(key, dtype=object), sorted_order=False)
    return _ENUM_TABLES[key]


def empty_table() -> StringTable:
    return _EMPTY


def encode_strings(values: np.ndarray) -> tuple[np.ndarray, np.ndarray | None, StringTable]:
    """Dictionary-encode an object array of ``str`` (or of ``bytes``: a
    Binary column, whose dictionary is always sorted).

    Returns (codes[int32], validity[bool] or None, table). Up to
    ``config().ordinal_dict_max`` distinct values the table is sorted
    (ordinal codes, the same codes as ``polars_tpu.utils.strtable``'s);
    above it, the values keep the order of their first occurrence. None/NaN
    entries become code 0 with validity False.
    """
    from polars_tpu_torch.config import config

    arr = np.asarray(values, dtype=object)
    # elementwise in C: None, and NaN (the one value unequal to itself)
    validity = ~(np.equal(arr, None) | np.not_equal(arr, arr))
    has_null = not validity.all()
    vals = (arr[validity] if has_null else arr).reshape(-1).tolist()
    binary = any(isinstance(v, (bytes, bytearray)) for v in vals[:64])
    # the distinct values in order of first occurrence, by one hash pass
    # over the Python objects (np.unique would sort all the rows; PERF.md:
    # the set-up of PDS-H's 60M-row string columns)
    rank = dict.fromkeys(vals)
    if binary:
        vals = [bytes(v) for v in vals]
        rank = dict.fromkeys(vals)
    elif not all(type(v) is str for v in rank):
        vals = [str(v) for v in vals]
        rank = dict.fromkeys(vals)
    uniques = list(rank) or [b"" if binary else ""]
    ordered = binary or len(uniques) <= config().ordinal_dict_max
    if ordered:
        uniques.sort()
    rank = dict(zip(uniques, range(len(uniques))))
    inv = np.fromiter(map(rank.__getitem__, vals), np.int32, count=len(vals))
    if has_null:
        codes = np.zeros(arr.shape, np.int32)
        codes[validity] = inv
    else:
        codes = inv.reshape(arr.shape)
    table = StringTable(np.asarray(uniques, dtype=object), sorted_order=ordered)
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
        # ordinal codes of both tables (each sorted once), then the merge of
        # two sorted tables below
        ls, lmap0 = left.ordinal()
        rs, rmap0 = right.ordinal()
        merged, lmap1, rmap1 = unify(ls, rs, require_ordinal=True)
        return merged, (lmap1 if len(lmap0) == 0 else lmap1[lmap0]), (rmap1 if len(rmap0) == 0 else rmap1[rmap0])
    lv = left.values.astype(str)
    rv = right.values.astype(str)
    merged, inv = np.unique(np.concatenate([lv, rv]), return_inverse=True)
    inv = inv.astype(np.int32).reshape(-1)
    return StringTable(merged.astype(object), sorted_order=True), inv[: len(lv)], inv[len(lv):]

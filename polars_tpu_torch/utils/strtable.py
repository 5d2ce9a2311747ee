"""Host-side dictionary value tables for String columns.

Copied from ``polars_tpu/utils/strtable.py`` and trimmed to what this slice
uses. Device tensors only ever hold dense int32 *codes*; the variable-length
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

    __slots__ = ("values", "sorted_order", "ident")

    def __init__(self, values: np.ndarray, *, sorted_order: bool = False) -> None:
        self.values = np.asarray(values, dtype=object)
        self.sorted_order = sorted_order
        self.ident = next(_NEXT_IDENT)

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
    as_str = (arr[validity] if has_null else arr).astype(str)
    if as_str.size == 0:
        uniques, inv = np.asarray([""]), np.zeros(0, np.int64)
    else:
        uniques, inv = np.unique(as_str, return_inverse=True)
    if has_null:
        codes = np.zeros(arr.shape, np.int32)
        codes[validity] = inv.astype(np.int32)
    else:
        codes = inv.astype(np.int32).reshape(arr.shape)
    table = StringTable(uniques.astype(object), sorted_order=True)
    return codes, (validity if has_null else None), table

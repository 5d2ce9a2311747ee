"""Stable multi-key argsort over order-preserving integer words (the port of
``polars_tpu/kernels/argsort.py``: ``key_words``, ``stable_argsort_words``
and ``boundaries_from_words``).

Each key column becomes one integer word whose signed order is the column's
logical order, with NaN greatest and -0.0 equal to 0.0. The words sort
LSD-first with ``torch.sort(stable=True)``, least significant word first,
so the composition is a stable lexicographic argsort. The JAX package split
f64 into three 32-bit words because its TPU backend had no 64-bit bitcast;
``Tensor.view`` reinterprets the bits directly. A word keeps the narrowest
signed type that holds it (dates and dictionary codes stay int32, rank words
int8): a radix sort of a narrower key takes fewer passes.
"""

from __future__ import annotations

import torch

from polars_tpu_torch import datatypes as dt
from polars_tpu_torch.errors import InvalidOperationError

_I64_MIN = -(2**63)
_NARROW = (torch.int8, torch.int16, torch.int32)


def refuse_nested_key(dtype: dt.DataType, what: str = "a sort, group or distinct key") -> None:
    """A List, Array or Struct value is a word into its child, not its
    content: ordering or comparing it by that word would be silently wrong,
    so its words come from ``kernels/nested_keys.val_words``."""
    if dtype.is_nested():
        raise InvalidOperationError(f"{what} of dtype {dtype!r} orders by its content: "
                                    "kernels/nested_keys.val_words gives its words")


def key_words(values: torch.Tensor, dtype: dt.DataType, *, descending: bool = False) -> list[torch.Tensor]:
    """Order-preserving word list for one key column (most significant
    first). Word order == logical total order, NaN greatest."""
    refuse_nested_key(dtype)
    d = values.dtype
    if d in (torch.float64, torch.float32):
        nan = torch.isnan(values)
        v = torch.where(values == 0, torch.zeros((), dtype=d, device=values.device), values)
        v = torch.where(nan, torch.full((), float("nan"), dtype=d, device=values.device), v)
        ibits = torch.int64 if d == torch.float64 else torch.int32
        bits = v.view(ibits)
        flip = torch.iinfo(ibits).max
        word = torch.where(bits < 0, bits ^ flip, bits)
    elif isinstance(dtype, dt.UInt64):
        word = values.to(torch.int64) ^ _I64_MIN  # unsigned bit pattern -> signed order
    elif d in _NARROW:  # integers, dictionary codes, dates
        word = values
    elif d in (torch.bool, torch.uint8):
        word = values.to(torch.int16)
    else:
        word = values.to(torch.int64)
    if descending:
        word = torch.bitwise_not(word)
    return [word]


def stable_argsort_words(words: list[torch.Tensor]) -> torch.Tensor:
    """Stable argsort (int64) by lexicographic word order, most significant
    word first."""
    perm = None
    for w in reversed(words):
        order = torch.sort(w if perm is None else w.index_select(0, perm), stable=True).indices
        perm = order if perm is None else perm.index_select(0, order)
    if perm is None:
        raise ValueError("stable_argsort_words: no words")
    return perm


def boundaries_from_words(words: list[torch.Tensor], perm: torch.Tensor) -> torch.Tensor:
    """After sorting by ``perm``, True where the key differs from the previous
    row (row 0 always True)."""
    diff = torch.zeros(perm.shape[0], dtype=torch.bool, device=perm.device)
    diff[:1] = True
    for w in words:
        ws = w.index_select(0, perm)
        diff[1:] |= ws[1:] != ws[:-1]
    return diff

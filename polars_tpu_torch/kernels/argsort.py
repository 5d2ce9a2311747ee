"""Stable multi-key argsort over order-preserving int64 words (the port of
``polars_tpu/kernels/argsort.py``: ``key_words`` and ``stable_argsort_words``).

Each key column becomes one int64 word whose signed order is the column's
logical order, with NaN greatest and -0.0 equal to 0.0. The words sort
LSD-first with ``torch.sort(stable=True)``, least significant word first,
so the composition is a stable lexicographic argsort. The JAX package split
f64 into three 32-bit words because its TPU backend had no 64-bit bitcast;
``Tensor.view`` reinterprets the bits directly.
"""

from __future__ import annotations

import torch

from polars_tpu_torch import datatypes as dt

_I64_MIN = -(2**63)


def key_words(values: torch.Tensor, dtype: dt.DataType, *, descending: bool = False) -> list[torch.Tensor]:
    """Order-preserving int64 word list for one key column (most significant
    first). Word order == logical total order, NaN greatest."""
    d = values.dtype
    if d in (torch.float64, torch.float32):
        nan = torch.isnan(values)
        v = torch.where(values == 0, torch.zeros((), dtype=d, device=values.device), values)
        v = torch.where(nan, torch.full((), float("nan"), dtype=d, device=values.device), v)
        ibits = torch.int64 if d == torch.float64 else torch.int32
        bits = v.view(ibits)
        flip = torch.iinfo(ibits).max
        word = torch.where(bits < 0, bits ^ flip, bits).to(torch.int64)
    elif isinstance(dtype, dt.UInt64):
        word = values.to(torch.int64) ^ _I64_MIN  # unsigned bit pattern -> signed order
    else:  # bool, integers, dictionary codes, temporal
        word = values.to(torch.int64)
    if descending:
        word = torch.bitwise_not(word)
    return [word]


def stable_argsort_words(words: list[torch.Tensor]) -> torch.Tensor:
    """Stable argsort (int64) by lexicographic word order, most significant
    word first."""
    n = words[0].shape[0]
    perm = torch.arange(n, dtype=torch.int64, device=words[0].device)
    for w in reversed(words):
        order = torch.sort(w.index_select(0, perm), stable=True).indices
        perm = perm.index_select(0, order)
    return perm

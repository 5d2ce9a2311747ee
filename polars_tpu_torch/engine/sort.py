"""Table sort: multi-key stable argsort (the port of
``polars_tpu/engine/sort.py``). Each key contributes a null-rank word and its
value word (``kernels/argsort.py``); rows outside the row mask sort last. A
rank word that is the same on every row (a key without nulls, after the
first) is left out: a constant word does not change a stable sort's order.
"""

from __future__ import annotations

import torch

from polars_tpu_torch.engine.common import Val
from polars_tpu_torch.engine.strings import ensure_ordinal_val
from polars_tpu_torch.kernels.argsort import stable_argsort_words
from polars_tpu_torch.kernels.nested_keys import val_words


def sort_words_for_key(v: Val, desc: bool, nulls_last: bool, rowmask: torch.Tensor | None) -> list[torch.Tensor]:
    """(rank word, *key words) for one sort key. Rank orders: nulls-first
    nulls < values < nulls-last nulls < out-of-mask rows. Without nulls and
    without a row mask there is no rank word."""
    v = ensure_ordinal_val(v)  # an unordered dictionary: its codes as ranks of the text
    words = val_words(v, descending=desc)  # a nested value: its content
    if v.validity is None and rowmask is None:
        return words
    if v.validity is None:
        rank = torch.where(rowmask, 1, 3).to(torch.int8)
    else:
        rank = torch.where(v.validity, 1, 2 if nulls_last else 0).to(torch.int8)
        if rowmask is not None:
            rank = torch.where(rowmask, rank, 3).to(torch.int8)
    return [rank, *words]


def sort_perm(
    key_vals: list[Val],
    descending: list[bool],
    nulls_last: list[bool],
    rowmask: torch.Tensor,
) -> torch.Tensor:
    """Stable permutation placing rows in key order, masked-out rows last."""
    words: list[torch.Tensor] = []
    for i, (v, desc, nl) in enumerate(zip(key_vals, descending, nulls_last)):
        words.extend(sort_words_for_key(v, desc, nl, rowmask if i == 0 else None))
    if not key_vals:
        words = [(~rowmask).to(torch.int8)]
    return stable_argsort_words(words)


def apply_perm(v: Val, perm: torch.Tensor) -> Val:
    values = v.values.index_select(0, perm)
    validity = None if v.validity is None else v.validity.index_select(0, perm)
    return v.with_(values=values, validity=validity)

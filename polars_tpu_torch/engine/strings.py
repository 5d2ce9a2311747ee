"""Device-side helpers for dictionary-coded string values (the port of
``polars_tpu/engine/strings.py``, trimmed to :func:`unify_vals`)."""

from __future__ import annotations

import numpy as np
import torch

from polars_tpu_torch.engine.common import Val, take_lut
from polars_tpu_torch.utils import strtable


def unify_vals(a: Val, b: Val) -> tuple[Val, Val]:
    """Remap two dictionary-coded Vals onto one merged table (ordinal iff
    both inputs are small and sorted; see ``strtable.unify``)."""
    if a.table is b.table:
        return a, b
    merged, lmap, rmap = strtable.unify(a.table, b.table)
    return a.with_(values=_remap(a.values, lmap), table=merged), b.with_(values=_remap(b.values, rmap), table=merged)


def _remap(codes: torch.Tensor, remap: np.ndarray) -> torch.Tensor:
    """Codes through a remap table; an empty remap is the identity."""
    if len(remap) == 0:
        return codes
    return take_lut(remap, codes)

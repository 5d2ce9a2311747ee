"""Row gathers on columns (the port of ``polars_tpu/engine/gather.py``:
``gather_column`` and ``gather_frame``).

Indices are a device tensor or a host sequence. A device tensor comes from the
engine (a join's pairs, a compaction's survivors) and is taken as in range;
host indices come from the user and are checked here: negative indices count
from the end, ``None`` gives a null row, and an index out of range raises.
The JAX package pads the index to a power of two and gathers each side in one
jitted dispatch; PyTorch gathers each column at its exact length.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from polars_tpu_torch.core.buffer import Buffer
from polars_tpu_torch.core.column import Column
from polars_tpu_torch.errors import OutOfBoundsError


def _device_index(indices: Any, n: int, device) -> tuple[torch.Tensor, torch.Tensor | None]:
    """(int64 index on ``device``, extra validity or None) of ``indices``
    for a column of ``n`` rows."""
    if isinstance(indices, torch.Tensor):
        return indices.to(device=device, dtype=torch.int64), None
    idx = np.asarray(indices)
    extra = None
    if idx.dtype == object:
        extra = np.asarray([i is not None for i in idx.tolist()], bool)
        idx = np.asarray([0 if i is None else i for i in idx.tolist()], np.int64)
    idx = idx.astype(np.int64).reshape(-1)
    idx = np.where(idx < 0, idx + n, idx)
    bad = (idx < 0) | (idx >= n)
    if extra is not None:
        bad &= extra
    if bad.any():
        raise OutOfBoundsError(f"gather index {int(np.asarray(indices, object).reshape(-1)[bad][0])} "
                               f"out of bounds for length {n}")
    extra_t = None if extra is None or extra.all() else torch.from_numpy(extra).to(device)
    return torch.from_numpy(idx).to(device), extra_t


def gather_column(col: Column, indices: Any, valid: torch.Tensor | None = None) -> Column:
    """``col`` at ``indices``; ``valid`` (bool, one per index) nulls rows."""
    return gather_frame([col], indices, valid)[0]


def gather_frame(cols: list[Column], indices: Any, valid: torch.Tensor | None = None) -> list[Column]:
    """Every column of ``cols`` (one height) at the same ``indices``; the
    index is checked and moved to the device once. ``valid`` (bool, one per
    index) nulls the rows where it is False."""
    if not cols:
        return []
    n = len(cols[0])
    idx, extra = _device_index(indices, n, cols[0].buffer.device)
    if extra is not None:
        valid = extra if valid is None else (valid & extra)
    m = idx.shape[0]
    if n == 0 and m:  # every row is null: gather from a one-row stand-in
        idx = torch.zeros_like(idx)
        valid = torch.zeros(m, dtype=torch.bool, device=idx.device)
    out = []
    for c in cols:
        buf = c.buffer
        src, src_valid = buf.values, buf.validity
        if n == 0 and m:
            src = torch.zeros(1, dtype=src.dtype, device=src.device)
            src_valid = None
        values = src.index_select(0, idx)
        validity = None if src_valid is None else src_valid.index_select(0, idx)
        if valid is not None:
            validity = valid if validity is None else (validity & valid)
        out.append(c.with_buffer(Buffer(values, validity, m)))
    return out

"""Frames from physical arrays: data in place of weights.

:func:`frame_from_numpy` builds a frame from each column's physical numpy
arrays — values, validity, and for strings the dictionary with its int32
codes — so that a frame carried over from another engine keeps the same
codes, and both engines group and sort identical keys.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any

import numpy as np

from polars_tpu_torch import datatypes as dt
from polars_tpu_torch.core.buffer import Buffer
from polars_tpu_torch.core.column import Column, _needs_table
from polars_tpu_torch.core.frame import DataFrame
from polars_tpu_torch.utils.strtable import StringTable


def frame_from_numpy(columns: Mapping[str, Mapping[str, Any]], *, device=None) -> DataFrame:
    """Build a frame from ``{name: spec}``. Each spec holds ``"values"`` (the
    physical numpy array: int32 codes for strings, int32 days for dates),
    ``"validity"`` (bool array or None), ``"dtype"`` (a dtype name such as
    ``"Float64"``, ``"String"``, ``"Date"``, ``"UInt32"``), and for strings
    ``"dictionary"`` (the values the codes index) and optionally ``"sorted"``
    (whether code order is lexicographic order; default True)."""
    from polars_tpu_torch.config import resolve_device

    dev = resolve_device(device)
    cols = []
    height = None
    for name, spec in columns.items():
        dtype = getattr(dt, spec["dtype"])()
        values = np.asarray(spec["values"])
        if height is None:
            height = values.shape[0]
        elif values.shape[0] != height:
            raise ValueError(f"column {name!r} has {values.shape[0]} rows, expected {height}")
        table = None
        if _needs_table(dtype):
            table = StringTable(np.asarray(spec["dictionary"], dtype=object), sorted_order=spec.get("sorted", True))
        buf = Buffer.from_numpy(values, spec.get("validity"), dtype=dt.dtype_to_torch(dtype), device=dev)
        cols.append(Column(str(name), dtype, buf, table))
    return DataFrame._from_columns(cols, height or 0, device=dev)

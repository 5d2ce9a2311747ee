"""Eager combination of frames (the port of ``polars_tpu/functions/eager.py``,
trimmed to the vertical ``concat`` of DataFrames, which a full join's
appended right rows need).

``how="vertical"`` needs equal column names in order; ``"vertical_relaxed"``
also casts each column to the supertype of its pieces. Either way string
columns are remapped onto one merged dictionary (``utils/strtable.unify``)
and a validity is kept where any piece has one.
"""

from __future__ import annotations

from typing import Any

import torch

from polars_tpu_torch.core.buffer import Buffer
from polars_tpu_torch.core.column import Column
from polars_tpu_torch.core.frame import DataFrame
from polars_tpu_torch.engine.cast import cast_val
from polars_tpu_torch.engine.common import ROW, Val, take_lut
from polars_tpu_torch.errors import SchemaError
from polars_tpu_torch.plan.schema_resolve import supertype
from polars_tpu_torch.utils import strtable


def _concat_columns(cols: list[Column], name: str, relaxed: bool) -> Column:
    target = cols[0].dtype
    for c in cols[1:]:
        if c.dtype != target and not relaxed:
            raise SchemaError(f"type {c.dtype!r} of column {name!r} differs from {target!r} in a vertical concat")
        target = supertype(target, c.dtype)
    vals = [cast_val(Val(c.buffer.values, c.buffer.validity, c.dtype, c.table, ROW), target) for c in cols]
    if vals[0].table is not None:
        # one dictionary for every piece: the merge of all, each piece's
        # codes looked up in it
        table = vals[0].table
        for v in vals[1:]:
            table = strtable.unify(table, v.table)[0]
        vals = [v if v.table is table else
                v.with_(values=take_lut(strtable.index_in(v.table.values, table.values), v.values), table=table)
                for v in vals]
    values = torch.cat([v.values for v in vals])
    validity = None
    if any(v.validity is not None for v in vals):
        validity = torch.cat([v.validity if v.validity is not None
                              else torch.ones(v.values.shape[0], dtype=torch.bool, device=v.values.device)
                              for v in vals])
    return Column(name, target, Buffer(values, validity), vals[0].table)


def concat(items: Any, *, how: str = "vertical") -> DataFrame:
    """Stack DataFrames of the same column names vertically."""
    frames = list(items)
    if not frames:
        raise ValueError("cannot concat an empty list")
    if not all(isinstance(f, DataFrame) for f in frames):
        raise NotImplementedError(
            "concat of anything but DataFrames is not ported yet (port queue: expression breadth)"
        )
    if how not in ("vertical", "vertical_relaxed"):
        raise NotImplementedError(f"concat how={how!r} is not ported yet (port queue: expression breadth)")
    names = frames[0].columns
    for f in frames[1:]:
        if f.columns != names:
            raise SchemaError(f"column name mismatch in vertical concat: {names} vs {f.columns}")
    cols = [_concat_columns([f._columns[i] for f in frames], n, how == "vertical_relaxed") for i, n in enumerate(names)]
    return DataFrame._from_columns(cols, sum(f.height for f in frames), device=frames[0].device)

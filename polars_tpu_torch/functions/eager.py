"""Combination of frames (the port of ``polars_tpu/functions/eager.py``:
``concat`` of DataFrames, Series and LazyFrames; every ``how`` but the
vertical ones of DataFrames is a plan, ``LazyFrame._concat``).

``how="vertical"`` needs equal column names in order; ``"vertical_relaxed"``
also casts each column to the supertype of its pieces. Either way string
columns are remapped onto one merged dictionary (``utils/strtable.unify``)
and a validity is kept where any piece has one.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any

from polars_tpu_torch.core.buffer import Buffer
from polars_tpu_torch.core.column import Column
from polars_tpu_torch.core.frame import DataFrame
from polars_tpu_torch.engine.common import child_column, col_to_val
from polars_tpu_torch.engine.strings import concat_vals
from polars_tpu_torch.errors import SchemaError
from polars_tpu_torch.plan.schema_resolve import supertype

if TYPE_CHECKING:
    from polars_tpu_torch.lazyframe import LazyFrame


def _concat_columns(cols: list[Column], name: str, relaxed: bool) -> Column:
    target = cols[0].dtype
    for c in cols[1:]:
        if c.dtype != target and not relaxed:
            raise SchemaError(f"type {c.dtype!r} of column {name!r} differs from {target!r} in a vertical concat")
        target = supertype(target, c.dtype)
    v = concat_vals([col_to_val(c) for c in cols], target)
    return Column(name, target, Buffer(v.values, v.validity), v.table, child_column(v, target))


def concat(items: Any, *, how: str = "vertical", rechunk: bool = False, parallel: bool = True,
           strict: bool = False) -> DataFrame | LazyFrame:
    """Stack DataFrames of the same column names vertically; LazyFrames
    vertically (``"vertical"`` and ``"vertical_relaxed"`` alike take each
    column's supertype, as ``polars_tpu`` does); and either of them
    diagonally, side by side or aligned on their common columns
    (``LazyFrame._concat``)."""
    from polars_tpu_torch.lazyframe import LazyFrame

    frames = list(items)
    if not frames:
        raise ValueError("cannot concat an empty list")
    if isinstance(frames[0], LazyFrame):
        return frames[0] if len(frames) == 1 else LazyFrame._concat(frames, how=how)
    from polars_tpu_torch.core.series import Series

    if all(isinstance(f, Series) for f in frames):  # one after another, in their supertype
        name = frames[0].name
        col = _concat_columns([f._column for f in frames], name, relaxed=True)
        return Series._from_column(col)
    if not all(isinstance(f, DataFrame) for f in frames):
        raise TypeError(f"cannot concat items of type {type(frames[0]).__name__}")
    if how not in ("vertical", "vertical_relaxed"):  # a plan over the frames (``LazyFrame._concat``)
        return LazyFrame._concat([f.lazy() for f in frames], how=how).collect()
    names = frames[0].columns
    for f in frames[1:]:
        if f.columns != names:
            raise SchemaError(f"column name mismatch in vertical concat: {names} vs {f.columns}")
    cols = [_concat_columns([f._columns[i] for f in frames], n, how == "vertical_relaxed") for i, n in enumerate(names)]
    return DataFrame._from_columns(cols, sum(f.height for f in frames), device=frames[0].device)

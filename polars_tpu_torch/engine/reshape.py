"""Reshaping frames on the device: ``unpivot`` (the JAX package's
``engine/run.py:2418`` ``_exec_unpivot``), ``pivot`` (its
``core/frame.py:837`` with ``_pivot_scatter``), ``transpose``,
``unstack`` and ``to_dummies``.

- ``unpivot`` is one pass: each index column's tensors repeated k times
  (a nested column's packed words or row ids repeat, its child is shared),
  the k ``on`` columns cast to their supertype and concatenated, and
  ``variable`` a k-entry dictionary whose codes are
  ``arange(k).repeat_interleave(n)``: all rows of the first ``on`` column,
  then the second, as in Polars. The JAX package runs one select per
  ``on`` column and concatenates k frames.
- ``pivot`` aggregates by (index, on) in one group-by (K1 sums its cells)
  and collects the cells, numbers their index tuples and ``on`` values by
  first appearance (or the ``on`` values by their order with
  ``sort_columns``) with a window over the cells alone, reads the sizes
  and the distinct ``on`` values once, and scatters each value column into
  an (n_on, n_out) tensor with one ``index_put_``; a cell no row wrote is
  null.
  ``aggregate_function=None`` raises where a cell holds several values,
  as Polars documents (the JAX package takes the first silently).
- ``transpose`` casts every column to the supertype, concatenates them and
  reads the (width, height) matrix by columns; ``unstack`` pads each
  column to a whole number of ``step`` rows and views it as a matrix;
  ``to_dummies`` reads each column's distinct values once (the output's
  names) and compares the column with each on the device.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

from polars_tpu_torch import datatypes as dt
from polars_tpu_torch.core.buffer import Buffer
from polars_tpu_torch.core.column import Column
from polars_tpu_torch.core.frame import DataFrame
from polars_tpu_torch.engine.common import child_column, col_to_val
from polars_tpu_torch.engine.strings import concat_vals
from polars_tpu_torch.errors import ComputeError, InvalidOperationError
from polars_tpu_torch.plan.schema_resolve import supertype
from polars_tpu_torch.utils import strtable

PIVOT_AGGS = ("first", "last", "sum", "mean", "median", "min", "max", "len", "count")


def _repeat_column(col: Column, k: int) -> Column:
    """``col``'s rows ``k`` times over, one copy after another."""
    buf = col.buffer
    validity = None if buf.validity is None else buf.validity.repeat(k)
    return col.with_buffer(Buffer(buf.values.repeat(k), validity, len(col) * k))


def _text_column(name: str, texts: list[str], repeat: int, device) -> Column:
    """A String column over the dictionary of ``texts``: each text ``repeat``
    times, one after another."""
    table_codes, _, table = strtable.encode_strings(np.asarray(texts, dtype=object))
    lut = torch.from_numpy(np.asarray(table_codes, np.int32)).to(device)
    return Column(name, dt.String(), Buffer(lut.repeat_interleave(repeat), None), table)


def unpivot_frame(df: DataFrame, on: list[str], index: list[str], variable_name: str, value_name: str) -> DataFrame:
    k, n = len(on), df.height
    cols = [_repeat_column(df._get(c), k) for c in index]
    device = df.device
    cols.append(_text_column(variable_name, list(on), n, device))
    if on:
        from polars_tpu_torch.functions.eager import _concat_columns

        cols.append(_concat_columns([df._get(c) for c in on], value_name, relaxed=True))
    else:
        cols.append(Column.from_values(value_name, [], dt.Null(), device=device))
    return DataFrame._from_columns(cols, n * k, device=device)


def pivot_frame(df: DataFrame, on: str, index: list[str], values: list[str], aggregate_function: str | None,
                maintain_order: bool, sort_columns: bool, separator: str) -> DataFrame:
    from polars_tpu_torch.functions.lazy import col
    from polars_tpu_torch.functions.lazy import len as pl_len

    agg = aggregate_function or "first"
    if agg not in PIVOT_AGGS:
        raise InvalidOperationError(f"pivot: unknown aggregate_function {aggregate_function!r}")
    aggs = [(col(v).len() if agg in ("len", "count") else getattr(col(v), agg)()).alias(v) for v in values]
    # the cells, collected: the numbering below runs over them, not over
    # the group-by's slots of the frame's rows
    base = df.lazy().group_by(*index, on, maintain_order=True).agg(*aggs, pl_len().alias("__pv_n")).collect()
    # the cells' index tuples and on values, numbered by first appearance
    # (the cells come in the order their first rows came)
    first = col("__pv_r")
    gid = (first.min().over(index).rank("dense") - 1) if index else (first * 0)
    oid = first.min().over(on).rank("dense") - 1
    cells = base.lazy().with_row_index("__pv_r").with_columns(gid.cast(dt.Int64()).alias("__pv_gid"),
                                                               oid.cast(dt.Int64()).alias("__pv_oid")).collect()
    gids = cells._get("__pv_gid").buffer.values
    oids = cells._get("__pv_oid").buffer.values
    device = df.device
    if cells.height:
        n_out, n_on, most = (int(x) for x in torch.stack([gids.max() + 1, oids.max() + 1,
                                                          cells._get("__pv_n").buffer.values.max().to(torch.int64)]
                                                         ).cpu().tolist())
    else:
        n_out, n_on, most = 0, 0, 0
    if aggregate_function is None and most > 1:
        raise ComputeError("found multiple elements in the same group, please specify an aggregation function")
    from polars_tpu_torch.engine.gather import gather_column, gather_frame

    def first_cells(ids: torch.Tensor, n: int) -> torch.Tensor:
        """The first cell of each of ``n`` numbers."""
        rows = torch.full((n,), cells.height, dtype=torch.int64, device=device)
        return rows.scatter_reduce_(0, ids, torch.arange(cells.height, device=device), "amin")

    # the distinct on values in their numbering (one read of n_on values)
    on_vals = gather_column(cells._get(on), first_cells(oids, n_on)).to_pylist()
    order = list(range(n_on))
    if sort_columns:  # by value, a null last
        order = sorted((j for j in order if on_vals[j] is not None), key=lambda j: on_vals[j]) + \
            [j for j in order if on_vals[j] is None]
    out_cols: list[Column] = []
    if index:  # each output row's index values: those of its first cell
        out_cols += gather_frame([cells._get(c) for c in index], first_cells(gids, n_out))
    for vn in values:
        c = cells._get(vn)
        buf = c.buffer
        grid = torch.zeros((n_on, n_out), dtype=buf.values.dtype, device=device)
        grid.index_put_((oids, gids), buf.values)
        written = torch.zeros((n_on, n_out), dtype=torch.bool, device=device)
        written.index_put_((oids, gids), torch.ones_like(oids, dtype=torch.bool) if buf.validity is None
                           else buf.validity)
        for j in order:
            label = "null" if on_vals[j] is None else str(on_vals[j])
            name = label if len(values) == 1 else f"{vn}{separator}{label}"
            out_cols.append(Column(name, c.dtype, Buffer(grid[j], written[j], n_out), c.table, c.child))
    return DataFrame._from_columns(out_cols, n_out, device=device)


def transpose_frame(df: DataFrame, include_header: bool, header_name: str, column_names: Any) -> DataFrame:
    n, m = df.height, df.width
    if column_names is None:
        names = [f"column_{i}" for i in range(n)]
    elif isinstance(column_names, str):  # the names are that column's values
        names = [str(v) for v in df._get(column_names).to_pylist()]
        df = df.drop(column_names)
        m = df.width
    else:
        names = [str(x) for x in column_names]
    if len(names) != n:
        raise InvalidOperationError(f"transpose needs {n} column names, got {len(names)}")
    device = df.device
    out: list[Column] = []
    if include_header:
        out.append(_text_column(header_name, df.columns, 1, device))
    if m and n:
        target = df.dtypes[0]
        for d in df.dtypes[1:]:
            target = supertype(target, d)
        if isinstance(target, dt.String) and any(not isinstance(d, (dt.String, dt.Categorical)) for d in df.dtypes):
            from polars_tpu_torch.engine.hostops import cast_to_text

            cols = [c if isinstance(c.dtype, dt.String) else cast_to_text(c) for c in df._columns]
        else:
            cols = list(df._columns)
        v = concat_vals([col_to_val(c) for c in cols], target)
        grid = v.values.reshape(m, n).t()
        valid = None if v.validity is None else v.validity.reshape(m, n).t()
        child = child_column(v, target)
        for i, name in enumerate(names):
            out.append(Column(name, target, Buffer(grid[i].contiguous(), None if valid is None
                                                   else valid[i].contiguous(), m), v.table, child))
    return DataFrame._from_columns(out, m if out else 0, device=device)


def unstack_frame(df: DataFrame, step: int, how: str, columns: Any, fill_values: Any) -> DataFrame:
    from polars_tpu_torch.engine.gather import gather_frame
    from polars_tpu_torch.functions.lazy import col, lit, when

    if how not in ("vertical", "horizontal"):
        raise InvalidOperationError(f"unstack: unknown how {how!r}")
    sel = df if columns is None else df.select(columns)
    n = df.height
    n_cols = math.ceil(n / step) if step else 0
    idx = torch.arange(n_cols * step, device=df.device)
    padded = DataFrame._from_columns(gather_frame(sel._columns, idx.clamp(max=max(n - 1, 0)), idx < n),
                                     n_cols * step, device=df.device)
    if fill_values is not None and n_cols * step > n:  # the padding takes the fill value
        fills = {c: fill_values.get(c) if isinstance(fill_values, dict) else fill_values for c in padded.columns}
        pad = col("__us_i") >= n
        padded = padded.with_row_index("__us_i").with_columns(
            [when(pad).then(lit(v, dtype=padded.schema[c])).otherwise(col(c)).alias(c)
             for c, v in fills.items() if v is not None]).drop("__us_i")
    out = []
    for c in padded._columns:
        buf = c.buffer

        def grid(t: torch.Tensor) -> torch.Tensor:
            return t.reshape(n_cols, step) if how == "vertical" else t.reshape(step, n_cols).t()

        values = grid(buf.values)
        valid = None if buf.validity is None else grid(buf.validity)
        for i in range(n_cols):
            out.append(c.with_buffer(Buffer(values[i].contiguous(), None if valid is None else
                                            valid[i].contiguous(), step)).rename(f"{c.name}_{i}"))
    return DataFrame._from_columns(out, step if out else 0, device=df.device)


def to_dummies_frame(df: DataFrame, columns: list[str] | None, separator: str, drop_first: bool) -> DataFrame:
    from polars_tpu_torch.functions.lazy import col, lit

    names = set(df.columns if columns is None else columns)
    exprs = []
    for c in df._columns:
        if c.name not in names:
            exprs.append(col(c.name))
            continue
        distinct = DataFrame._from_columns([c], df.height).lazy().unique().sort(c.name).collect()
        uniq = distinct._columns[0].to_pylist()  # nulls first, as Polars sorts its groups
        if drop_first:
            uniq = uniq[1:]
        for u in uniq:
            hit = col(c.name).is_null() if u is None else col(c.name).eq_missing(lit(u, dtype=c.dtype))
            label = "null" if u is None else str(u)
            exprs.append(hit.cast(dt.UInt8()).alias(f"{c.name}{separator}{label}"))
    return df.select(exprs)


def rows_sorted(cols: list[Column], descending: list[bool], nulls_last: list[bool]) -> bool:
    """Whether the rows are in lexicographic order of ``cols``: per pair of
    neighbours, the first column that differs decides (one read)."""
    from polars_tpu_torch.engine.cast import order_word
    from polars_tpu_torch.engine.strings import ensure_ordinal_val

    n = len(cols[0]) if cols else 0
    if n < 2:
        return True
    dev = cols[0].buffer.device
    decided = torch.zeros(n - 1, dtype=torch.bool, device=dev)
    bad = torch.zeros(n - 1, dtype=torch.bool, device=dev)
    for c, desc, nl in zip(cols, descending, nulls_last):
        v = ensure_ordinal_val(col_to_val(c))
        w = order_word(v.values, v.dtype)
        valid = torch.ones(n, dtype=torch.bool, device=dev) if v.validity is None else v.validity
        a, b, va, vb = w[:-1], w[1:], valid[:-1], valid[1:]
        both = va & vb
        lt = (a > b) if desc else (a < b)  # in order and different
        gt = (a < b) if desc else (a > b)
        null_in_order = (~va & vb) if not nl else (va & ~vb)
        null_out = (va & ~vb) if not nl else (~va & vb)
        good = (both & lt) | null_in_order
        wrong = (both & gt) | null_out
        bad |= ~decided & wrong
        decided |= good | wrong
    return not bool(bad.any())

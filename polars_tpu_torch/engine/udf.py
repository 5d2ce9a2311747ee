"""A user's Python functions (the JAX package's ``engine/run.py:451``
``LMapFunction``, ``:746`` ``EAnonymous`` and ``:512-518``
``_exec_groupby_apply``, and ``rolling_map`` at ``:1723``).

A function runs on the host by definition. It is handed port objects on
the frame's device (a ``DataFrame``, a ``Series`` or a list of them), and
what it returns goes back to that device: a Series or a frame (moved if it
lies elsewhere), a tensor, a numpy array, a list or a scalar. Nothing else
of the plan leaves the device: a UDF in a select is a host call between
segments (``engine/hostops.py``), ``LazyFrame.map_batches`` a barrier
node, and a UDF in a group-by aggregation is handed each group's rows, cut
from one gather of the input in group order (the group-by's own implode of
the row numbers gives each group's range; one read of the ranges).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from polars_tpu_torch import datatypes as dt
from polars_tpu_torch.core.buffer import Buffer
from polars_tpu_torch.core.column import Column
from polars_tpu_torch.core.frame import DataFrame
from polars_tpu_torch.errors import ComputeError, SchemaError
from polars_tpu_torch.plan import exprs as E
from polars_tpu_torch.plan import logical as L


def column_to(col: Column, device) -> Column:
    """``col`` (its validity and child with it) on ``device``."""
    if col.buffer.device == torch.device(device):
        return col
    buf = col.buffer
    child = col.child
    if isinstance(child, list):
        child = [column_to(c, device) for c in child]
    elif child is not None:
        child = column_to(child, device)
    validity = None if buf.validity is None else buf.validity.to(device)
    return Column(col.name, col.dtype, Buffer(buf.values.to(device), validity, len(col)), col.table, child)


def as_column(result: Any, name: str, device, return_dtype: dt.DataType | None = None) -> Column:
    """What a function returned, as a column on ``device``, cast to
    ``return_dtype`` (not strictly) where it has another dtype."""
    from polars_tpu_torch.core.series import Series

    if isinstance(result, Series):
        col = column_to(result._column, device)
    elif isinstance(result, torch.Tensor) and result.dim() == 1 and result.dtype != torch.bfloat16:
        d = dt.numpy_to_dtype(torch.empty(0, dtype=result.dtype).numpy().dtype)
        col = Column(name, d, Buffer(result.to(device).contiguous(), None))
    elif isinstance(result, torch.Tensor) or np.ndim(result) == 0:  # one value
        value = result.item() if hasattr(result, "item") else result
        col = Column.from_values(name, [value], return_dtype, device=device, strict=False)
    else:
        values = result if isinstance(result, np.ndarray) and result.dtype != object else list(result)
        col = Column.from_values(name, values, return_dtype, device=device, strict=False)
    if return_dtype is not None and col.dtype != return_dtype:
        from polars_tpu_torch.core.frame import _cast_column

        col = _cast_column(col, return_dtype, False)
    return col.rename(name)


def map_frame(function: Any, df: DataFrame, expected: Any = None) -> DataFrame:
    """``LazyFrame.map_batches``: the function of the collected input,
    whose output must have the ``expected`` schema where one is given."""
    out = function(df)
    if not isinstance(out, DataFrame):
        raise ComputeError(f"the function of map_batches returned {type(out).__name__}, not a DataFrame")
    if expected is not None and list(out.schema.items()) != list(expected.items()):
        raise SchemaError(f"the output schema of map_batches is incorrect; expected {expected}, got {out.schema}")
    if out.device != df.device:
        out = DataFrame._from_columns([column_to(c, df.device) for c in out._columns], out.height, device=df.device)
    return out


def _argument(node: E.EAnonymous, series: list):
    """One Series for a function of one input, else the list of them."""
    return series[0] if len(series) == 1 else series


def call_column(df: DataFrame, node: E.EAnonymous) -> Column:
    """A UDF of whole columns over ``df`` (a select's host call)."""
    from polars_tpu_torch.core.series import Series
    from polars_tpu_torch.engine.hostops import _eval_columns

    cols = _eval_columns(df, node.input)
    series = [Series._from_column(c.rename(E.output_name(i) or c.name)) for c, i in zip(cols, node.input)]
    name = E.output_name(node.input[0]) if node.input else "map"
    return as_column(node.function(_argument(node, series)), name or "map", df.device, node.return_dtype)


def rolling_map_column(col: Column, node: E.EFunction) -> Column:
    """``rolling_map``: the function of each window of ``window_size`` rows
    (ending at the row, or centred), handed as a view of the column; fewer
    than ``min_samples`` rows give null. Each result takes the column's
    dtype, as Polars casts it."""
    from polars_tpu_torch.core.series import Series

    fn = node.opt("function")
    w = int(node.opt("window_size"))
    minp = int(node.opt("min_samples") or w)
    shift = (w - 1) // 2 if node.opt("center", False) else 0
    n = len(col)
    buf = col.buffer
    out = []
    for i in range(n):
        end = min(i + 1 + shift, n)
        start = max(i + 1 + shift - w, 0)
        if end - start < minp:
            out.append(None)
            continue
        validity = None if buf.validity is None else buf.validity[start:end]
        r = fn(Series._from_column(col.with_buffer(Buffer(buf.values[start:end], validity, end - start))))
        if isinstance(r, Series):
            r = r.to_list()[0] if len(r) else None
        out.append(r.item() if hasattr(r, "item") else r)
    return Column.from_values(col.name, out, col.dtype, device=buf.device, strict=False)


def has_udf(node: L.LGroupBy) -> bool:
    return any(isinstance(n, E.EAnonymous) for a in node.aggs for n in E.walk(a))


def _replace_udfs(node: E.ENode, swap: dict) -> E.ENode:
    """``node`` with each user's function of ``swap`` replaced by its
    stand-in."""
    if isinstance(node, E.EAnonymous):
        return swap[node]
    changes = {}
    for f in dataclasses.fields(node):
        v = getattr(node, f.name)
        if isinstance(v, E.ENode):
            changes[f.name] = _replace_udfs(v, swap)
        elif isinstance(v, tuple) and v and all(isinstance(x, E.ENode) for x in v):
            changes[f.name] = tuple(_replace_udfs(x, swap) for x in v)
    return dataclasses.replace(node, **changes) if changes else node


def _per_group(fn: E.EAnonymous, cols: list[Column], names: list[str], bounds: list) -> list:
    """``fn`` called on each group's Series (each a cut of the columns in
    group order): a value per group where it ``returns_scalar``, else its
    output's values."""
    from polars_tpu_torch.core.series import Series

    results = []
    for start, length in bounds:
        series = [Series._from_column(c.rename(nm).with_buffer(Buffer(
            c.buffer.values[start:start + length],
            None if c.buffer.validity is None else c.buffer.validity[start:start + length], length)))
            for c, nm in zip(cols, names)]
        r = fn.function(_argument(fn, series))
        if fn.returns_scalar:
            if isinstance(r, Series):
                r = r.to_list()[0] if len(r) else None
            results.append(r.item() if hasattr(r, "item") else r)
        else:
            results.append(as_column(r, "", "cpu").to_pylist())
    return results


def _udfs_under_expressions(df: DataFrame, aggs: list, order: torch.Tensor, lens: torch.Tensor,
                            bounds: list) -> list[Column]:
    """Aggregations with a user's function under a larger expression: the
    frame in group order, each function's per-group results beside it (a
    scalar result repeated over its group's rows and read as the group's
    ``first``; any other as many values as the group has rows), and the
    expressions, the functions replaced, run by the device's group-by over
    a group number."""
    from polars_tpu_torch.engine.gather import gather_column, gather_frame
    from polars_tpu_torch.engine.hostops import _eval_columns
    from polars_tpu_torch.engine.run import execute_plan

    dev = df.device
    group_of_row = torch.repeat_interleave(torch.arange(lens.shape[0], dtype=torch.int64, device=lens.device), lens)
    cols = gather_frame(list(df._columns), order)
    cols.append(Column("__udf_g", dt.Int64(), Buffer(group_of_row.to(dev), None)))
    swap = {}
    for a in aggs:
        for fn in E.walk(a):
            if not isinstance(fn, E.EAnonymous) or fn in swap:
                continue
            name = f"__udf_{len(swap)}"
            inputs = gather_frame(_eval_columns(df, fn.input), order)
            results = _per_group(fn, inputs, [E.output_name(i) or c.name for c, i in zip(inputs, fn.input)], bounds)
            if fn.returns_scalar:
                per_group = Column.from_values(name, results, fn.return_dtype, device=dev, strict=False)
                cols.append(gather_column(per_group, group_of_row.to(dev)).rename(name))
                swap[fn] = E.EAgg(E.EColumn(name), "first")
                continue
            if [len(r) for r in results] != [n for _, n in bounds]:
                raise ComputeError("a user's function under a larger expression in a group-by must return as many "
                                   "values as its group has rows")
            flat = [x for r in results for x in r]
            cols.append(Column.from_values(name, flat, fn.return_dtype, device=dev, strict=False))
            swap[fn] = E.EColumn(name)
    frame = DataFrame._from_columns(cols, len(group_of_row), device=dev)
    scan = L.LDataFrameScan(df=frame, ident=0)
    out = execute_plan(L.LGroupBy(scan, (E.EColumn("__udf_g"),), tuple(_replace_udfs(a, swap) for a in aggs), True))
    return list(out._columns[1:])


def exec_groupby_udf(node: L.LGroupBy) -> DataFrame:
    """A group-by whose aggregations call a user's function: the others run
    as one group-by that also implodes the row numbers (device); each UDF's
    inputs are gathered in group order once and handed to it group by
    group. A UDF that ``returns_scalar`` gives a value per group, any other
    a List per group; a UDF under a larger expression gives its per-group
    results to the device, which evaluates what surrounds it
    (:func:`_udfs_under_expressions`)."""
    from polars_tpu_torch.engine.common import col_to_val
    from polars_tpu_torch.engine.fn_nested import unpack
    from polars_tpu_torch.engine.gather import gather_frame
    from polars_tpu_torch.engine.hostops import _eval_columns
    from polars_tpu_torch.engine.run import execute_plan
    from polars_tpu_torch.plan.schema_resolve import expand_exprs

    df = execute_plan(node.input)
    keys = expand_exprs(node.keys, df.schema)
    aggs = expand_exprs(node.aggs, df.schema)
    udfs = [a for a in aggs if any(isinstance(n, E.EAnonymous) for n in E.walk(a))]
    rows = df.with_row_index("__udf_r")
    scan = L.LDataFrameScan(df=rows, ident=0)
    rest = tuple(a for a in aggs if a not in udfs) + (E.EAlias(E.EColumn("__udf_r"), "__udf_rows"),)
    base = execute_plan(L.LGroupBy(scan, keys, rest, node.maintain_order))
    ranges = base._get("__udf_rows")
    starts, lens = unpack(col_to_val(ranges).values)
    order = ranges.child.buffer.values.to(torch.int64)  # the row numbers in group order
    bounds = torch.stack([starts, lens], 1).cpu().numpy().tolist()  # the one read of the groups' ranges
    extra = []
    nested = []
    for a in udfs:
        fn = a
        while isinstance(fn, E.EAlias):
            fn = fn.input
        if not isinstance(fn, E.EAnonymous):
            nested.append(a)
            continue
        cols = gather_frame(_eval_columns(df, fn.input), order)
        names = [E.output_name(i) or c.name for c, i in zip(cols, fn.input)]
        results = _per_group(fn, cols, names, bounds)
        name = E.output_name(a) or "map"
        out_dtype = fn.return_dtype if fn.returns_scalar else (dt.List(fn.return_dtype) if fn.return_dtype else None)
        extra.append(Column.from_values(name, results, out_dtype, device=df.device, strict=False))
    if nested:
        extra.extend(_udfs_under_expressions(df, nested, order, lens, bounds))
    by_name = {c.name: c for c in list(base._columns) + extra}
    names = [E.output_name(k) or "literal" for k in keys] + [E.output_name(a) or "literal" for a in aggs]
    return DataFrame._from_columns([by_name[n] for n in names], base.height, device=df.device)

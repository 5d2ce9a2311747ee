"""Expressions whose column has a length of its own, made between segments
(``engine/hostops.py`` calls them; the JAX package runs them on the host,
``engine/run.py:36-47``): ``extend_constant``, ``append``, ``sample``,
``shuffle``, ``rle``, ``value_counts``, ``hist`` and ``reshape``.

Each takes its input's column on the device and builds its result there:
no value is read to the host. A count that sizes the result is read once
(the runs of ``rle``, the distinct values of ``value_counts``); a sample
draws from a ``torch.Generator`` on the device, seeded by its ``seed``
(else by ``set_random_seed``'s, else afresh), so its values differ from the
JAX package's PRNG and are held to their properties.
"""

from __future__ import annotations

import random

import torch

from polars_tpu_torch import datatypes as dt
from polars_tpu_torch.core.buffer import Buffer
from polars_tpu_torch.core.column import Column
from polars_tpu_torch.core.frame import DataFrame
from polars_tpu_torch.engine.registry import SAME, SUPER, raises, register
from polars_tpu_torch.errors import InvalidOperationError, ShapeError
from polars_tpu_torch.plan import exprs as E

# the functions of this module (``plan/exprs.HOST_FNS``; each makes a column
# of its own length, ``engine/hostops.GENERATORS``)
SEQUENCE_FNS = ("extend_constant", "append", "sample", "shuffle", "rle", "value_counts", "hist", "reshape")


def _rle_dt(dts, opts):
    return dt.Struct([("len", dt.UInt32()), ("value", dts[0])])


def _value_counts_dt(dts, opts):
    count = dt.Float64() if opts.get("normalize") else dt.UInt32()
    return dt.Struct([(opts.get("field") or "", dts[0]), (opts.get("count_name") or "count", count)])


def _hist_dt(dts, opts):
    fields = []
    if opts.get("include_breakpoint"):
        fields.append(("breakpoint", dt.Float64()))
    if opts.get("include_category"):
        fields.append(("category", dt.String()))
    return dt.Struct(fields + [("count", dt.UInt32())]) if fields else dt.UInt32()


def _reshape_dt(dts, opts):
    dims = opts["dimensions"]
    return dts[0] if len(dims) == 1 else dt.Array(dts[0], int(dims[1]))


for _name, _rule in (("extend_constant", SUPER), ("append", SUPER), ("sample", SAME), ("shuffle", SAME),
                     ("rle", _rle_dt), ("value_counts", _value_counts_dt), ("hist", _hist_dt),
                     ("reshape", _reshape_dt)):
    register(_name, _rule, elementwise=False)(
        raises(f"{_name} changes the column's length: only in a select (engine/sequences.py)"))


def _struct(name: str, fields: list[Column], dtype: dt.Struct) -> Column:
    n = len(fields[0])
    ids = torch.arange(n, dtype=torch.int64, device=fields[0].buffer.device)
    return Column(name, dtype, Buffer(ids, None), None, list(fields))


def _seed(seed) -> int | None:
    """``seed``, else ``set_random_seed``'s, else None (a fresh one)."""
    from polars_tpu_torch.config import config

    if seed is None:
        seed = config().random_seed
    return None if seed is None else int(seed)


def sequence_column(df: DataFrame, node: E.EFunction) -> Column:
    """The column of one of :data:`SEQUENCE_FNS` over ``df``."""
    from polars_tpu_torch.engine.gather import gather_column
    from polars_tpu_torch.engine.run import _eval_column
    from polars_tpu_torch.functions.eager import _concat_columns

    col = _eval_column(df, node.inputs[0])
    name, dev, n = col.name, col.buffer.device, len(col)
    opts = dict(node.options)
    if node.name in ("extend_constant", "append"):
        other = _eval_column(df, node.inputs[1])
        if node.name == "extend_constant":
            if len(other) != 1:
                raise InvalidOperationError("extend_constant takes one value")
            other = gather_column(other, torch.zeros(int(opts["n"]), dtype=torch.int64, device=dev))
        return _concat_columns([col, other], name, relaxed=True)
    if node.name in ("sample", "shuffle"):
        seed = _seed(opts.get("seed"))
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed if seed is not None else random.getrandbits(63))
        if node.name == "shuffle":
            return gather_column(col, torch.randperm(n, generator=gen, device=dev))
        k = opts.get("n")
        if k is None:
            k = int(n * (opts.get("fraction") if opts.get("fraction") is not None else 1.0))
        if opts.get("with_replacement"):
            idx = torch.randint(0, max(n, 1), (int(k),), generator=gen, device=dev) if n else \
                torch.zeros(0, dtype=torch.int64, device=dev)
        else:
            if k > n:
                raise ShapeError(f"cannot take a larger sample ({k}) than the total population ({n}) without "
                                 "replacement")
            idx = torch.randperm(n, generator=gen, device=dev)[:int(k)]
            if not opts.get("shuffle"):
                idx = torch.sort(idx).values
        return gather_column(col, idx)
    if node.name == "rle":
        return _rle(col)
    if node.name == "value_counts":
        return _value_counts(col, opts)
    if node.name == "hist":
        return _hist(col, opts)
    return _reshape(col, opts["dimensions"])


def _rle(col: Column) -> Column:
    """Runs of equal values (a null equals a null; a List, Array or Struct
    value by its content): one struct per run, its length and its value;
    one read of the run count."""
    from polars_tpu_torch.engine.common import col_to_val
    from polars_tpu_torch.engine.gather import gather_column
    from polars_tpu_torch.kernels.compact import compact_count, compact_scatter
    from polars_tpu_torch.kernels.nested_keys import content_rank

    n, dev = len(col), col.buffer.device
    dtype = _rle_dt([col.dtype], {})
    if n == 0:
        return _struct(col.name, [Column.from_values("len", [], dt.UInt32(), device=dev), col.rename("value")],
                       dtype)
    buf = col.buffer
    word = content_rank(col_to_val(col)) if col.dtype.is_nested() else buf.values
    same = word[1:] == word[:-1]
    if buf.validity is not None:
        va, vb = buf.validity[1:], buf.validity[:-1]
        same = (same & va & vb) | (~va & ~vb)
    start = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), ~same])
    offs = compact_count(start)
    k = int(offs[-1])
    (first,) = compact_scatter([torch.arange(n, dtype=torch.int64, device=dev)], start, offs, k)
    lens = torch.diff(first, append=torch.tensor([n], dtype=torch.int64, device=dev))
    length = Column("len", dt.UInt32(), Buffer(lens, None))
    return _struct(col.name, [length, gather_column(col, first).rename("value")], dtype)


def _value_counts(col: Column, opts: dict) -> Column:
    """Each distinct value (in order of first appearance) with its count
    (a group-by: K1 counts), or its share with ``normalize``; by count,
    largest first, with ``sort``."""
    from polars_tpu_torch.functions.lazy import col as pl_col
    from polars_tpu_torch.functions.lazy import len as pl_len

    field = opts.get("field") or col.name
    count_name = opts.get("count_name") or ("proportion" if opts.get("normalize") else "count")
    sub = DataFrame._from_columns([col.rename(field)], len(col))
    cnt = pl_len().cast(dt.Float64()) / max(len(col), 1) if opts.get("normalize") else pl_len()
    lf = sub.lazy().group_by(field, maintain_order=True).agg(cnt.alias(count_name))
    if opts.get("sort"):
        lf = lf.sort(pl_col(count_name), descending=True, maintain_order=True)
    out = lf.collect()
    return _struct(col.name, list(out._columns), _value_counts_dt([col.dtype], {"field": field, "count_name": count_name,
                                                                                 "normalize": opts.get("normalize")}))


def _hist(col: Column, opts: dict) -> Column:
    """Counts per bin (left-open, the first bin closed, as Polars counts
    them): the given edges, or ``bin_count`` equal bins over the values'
    range (one read of the minimum and maximum)."""
    dev = col.buffer.device
    x = col.buffer.values.to(torch.float64)
    valid = col.buffer.validity
    if opts.get("bins") is not None:
        edges = torch.tensor([float(b) for b in opts["bins"]], dtype=torch.float64, device=dev)
    else:
        k = int(opts.get("bin_count") or 10)
        xs = x if valid is None else x[valid]
        lo, hi = (float(t) for t in torch.stack([xs.min(), xs.max()]).cpu()) if xs.numel() else (0.0, 1.0)
        if lo == hi:
            lo, hi = lo - 0.5, hi + 0.5
        edges = torch.linspace(lo, hi, k + 1, dtype=torch.float64, device=dev)
    nb = edges.shape[0] - 1
    idx = torch.bucketize(x, edges, right=False) - 1  # (e[i], e[i+1]] is bin i
    idx = torch.where(x == edges[0], torch.zeros_like(idx), idx)
    ok = (idx >= 0) & (idx < nb) & (x >= edges[0]) & (x <= edges[-1])
    if valid is not None:
        ok &= valid
    counts = torch.bincount(torch.where(ok, idx, nb), minlength=nb + 1)[:nb]
    count = Column("count", dt.UInt32(), Buffer(counts.to(torch.int64), None))
    if not (opts.get("include_breakpoint") or opts.get("include_category")):
        return count.rename(col.name)
    fields = []
    if opts.get("include_breakpoint"):
        fields.append(Column("breakpoint", dt.Float64(), Buffer(edges[1:].contiguous(), None)))
    if opts.get("include_category"):
        lo_e, hi_e = edges[:-1].cpu().tolist(), edges[1:].cpu().tolist()
        fields.append(Column.from_values("category", [f"({a}, {b}]" for a, b in zip(lo_e, hi_e)], dt.String(),
                                         device=dev))
    return _struct(col.name, fields + [count], _hist_dt([col.dtype], opts))


def _reshape(col: Column, dims) -> Column:
    """``(rows, width)`` as an Array of ``width`` per row over the column
    (-1 infers one side); one dimension flattens."""
    n = len(col)
    dims = [int(d) for d in dims]
    if len(dims) == 1:
        if dims[0] not in (-1, n):
            raise InvalidOperationError(f"cannot reshape {n} values into {tuple(dims)}")
        return col
    if len(dims) != 2:
        raise InvalidOperationError("reshape takes one or two dimensions")
    rows, width = dims
    if width == -1:
        width = n // rows if rows else 0
    if rows == -1:
        rows = n // width if width else 0
    if rows * width != n:
        raise InvalidOperationError(f"cannot reshape {n} values into ({dims[0]}, {dims[1]})")
    dev = col.buffer.device
    starts = torch.arange(rows, dtype=torch.int64, device=dev) * width
    words = (starts << 32) | width
    return Column(col.name, dt.Array(col.dtype, width), Buffer(words, None), None, col)

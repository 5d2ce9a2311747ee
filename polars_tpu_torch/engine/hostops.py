"""Host functions: the expressions that run on the host between segments
(the port of ``polars_tpu/engine/run.py``'s hoisting of ``HOST_FNS``,
``_hoist_host_exprs`` and ``_eval_host``, trimmed to ``dt.to_string``, the
casts to String, the median, quantile and rank over time windows
(``rolling_*_by``, the JAX package's ``run.py:1646-1722``) and a
``cumulative_eval`` of any expression but a prefix sum, min, max or mean
(``run.py:1493``), ``shrink_dtype`` (``run.py:1453``) and the generators
``int_range``, ``repeat``, ``unique`` and ``unique_counts``
(``run.py:2006-2045``), whose column has a length of its own,
``concat_str`` (per distinct tuple of codes, ``run.py:775-799``),
``cat.get_categories`` and ``str.join`` in a select; ``plan/exprs.is_host_call``).
Each runs through ``engine/run._eval_generator``. A group-by with
``str.join`` runs its other aggregations as a segment and joins each
group's text on the host (:func:`exec_host_groupby`).

A select or with_columns that calls one (``plan/exprs.HOST_FNS``) is no
part of a segment (``executors._is_fusable``). Its input runs first; each
host call's input is evaluated over that frame, formatted on the host once
per distinct value (one read of the distinct values) and gathered back by
their codes into a dictionary-coded String column; the select then runs as
one segment over the frame and those columns, which stand where the calls
stood. A call whose input is one value (an aggregate, a literal) stands as
a one-row literal Series, which the segment broadcasts as a scalar.

``dt.to_string`` takes chrono's ``strftime`` format, as Polars does:
``%f`` is the nanoseconds of the second in 9 digits, ``%.f`` a dot and 3, 6
or 9 digits (as many as the value needs; nothing for a whole second),
``%.3f``/``%.6f``/``%.9f`` and ``%3f``/``%6f``/``%9f`` that many digits
with and without the dot, ``%:z`` the offset as ``+02:00``; every other
specifier is Python's, which agrees with chrono's (``%z`` as ``+0200``,
``%Z`` the zone's abbreviation). The JAX package hands the format to Python
unchanged, so its ``%.f`` comes out as literal text (ROADMAP §3).
"""

from __future__ import annotations

import datetime as _pydt
import re

import numpy as np
import torch

from polars_tpu_torch import datatypes as dt
from polars_tpu_torch.core.buffer import Buffer
from polars_tpu_torch.core.column import Column
from polars_tpu_torch.core.frame import DataFrame
from polars_tpu_torch.engine.common import take_lut
from polars_tpu_torch.errors import InvalidOperationError, ShapeError
from polars_tpu_torch.plan import exprs as E
from polars_tpu_torch.plan import logical as L
from polars_tpu_torch.utils import strtable
from polars_tpu_torch.utils.tokens import next_token

# host functions that make a column of their own length
GENERATORS = ("int_range", "repeat_value", "temporal_range", "unique", "unique_counts", "cat.get_categories",
              "extend_constant", "append", "sample", "shuffle", "rle", "value_counts", "hist", "reshape")
_EPOCH = _pydt.datetime(1970, 1, 1)
_EPOCH_UTC = _pydt.datetime(1970, 1, 1, tzinfo=_pydt.timezone.utc)
# the chrono specifiers Python lacks or reads otherwise
_CHRONO = re.compile(r"%(%|\.[369]?f|[369]f|f|:z)")


def exec_host_select(node: L.LSelect | L.LWithColumns, reduce_first: bool = True) -> DataFrame:
    """Run a select or with_columns that calls host functions: the input,
    then each call on the host, then the rest as one segment. With
    ``reduce_first``, an aggregation of a column of its own length
    (``extend_constant(...).sum()``) is a select of its own first, and its
    one value a scalar of the rest."""
    from polars_tpu_torch.engine.executors import run_segment
    from polars_tpu_torch.engine.join import _renamed
    from polars_tpu_torch.engine.run import execute_plan
    from polars_tpu_torch.plan.schema_resolve import _rebuild_expr

    from polars_tpu_torch.engine import run

    df = execute_plan(node.input)
    hoisted: list[Column] = []

    def hoist(e: E.ENode) -> E.ENode:
        if reduce_first and isinstance(e, E.EAgg) and any(E.is_host_call(n) and getattr(n, "name", None) in GENERATORS
                                                          for n in E.walk(e)):
            one = exec_host_select(L.LSelect(L.LDataFrameScan(df=df, ident=0), (e,)), reduce_first=False)
            return E.ESeriesLit(column=one._columns[0], ident=next_token())
        if E.is_host_call(e):
            out = run._eval_generator(df, e, None)
            own = getattr(e, "name", None) in GENERATORS  # a length of its own
            if len(out) == 1 and not own:  # an aggregate's, a literal's or a function's one value: a scalar
                return E.ESeriesLit(column=out, ident=next_token())
            if len(out) != df.height and not own and not isinstance(e, E.EAnonymous):
                raise InvalidOperationError(
                    f"{e.name} gives {len(out)} rows over a frame of {df.height}; only a column or a scalar input")
            name = f"__host_{len(hoisted)}"
            hoisted.append(_renamed(out, name))
            return E.EColumn(name)
        kids = e.children()
        new = tuple(hoist(k) for k in kids)
        return e if new == kids else _rebuild_expr(e, new)

    exprs = []
    for e in node.expressions:
        h = hoist(e)
        name = E.output_name(e) or "literal"
        exprs.append(h if E.output_name(h) == name else E.EAlias(h, name))
    if isinstance(node, L.LWithColumns):  # the input's columns in place, the new ones after
        defined = {E.output_name(e): e for e in exprs}
        exprs = [defined.pop(n, E.EColumn(n)) for n in df.columns] + list(defined.values())
    heights = {len(c) for c in hoisted} - {df.height}
    if heights:  # a generator of its own length: the select's rows are its
        reads = {n.name for e in exprs for n in E.walk(e) if isinstance(n, E.EColumn)}
        if len(heights) > 1 or not isinstance(node, L.LSelect) or reads & set(df.columns) or \
                {len(c) for c in hoisted} != heights:
            raise ShapeError(f"a select of columns of lengths {sorted(heights | {df.height})}")
        frame = DataFrame._from_columns(hoisted, heights.pop(), device=df.device)
        scan = L.LDataFrameScan(df=frame, ident=0)
        return run_segment(L.LSelect(scan, tuple(exprs)), [(scan, frame)])
    frame = DataFrame._from_columns(list(df._columns) + hoisted, df.height, device=df.device)
    scan = L.LDataFrameScan(df=frame, ident=0)
    return run_segment(L.LSelect(scan, tuple(exprs)), [(scan, frame)])


def host_call(df: DataFrame, node: E.ENode) -> Column:
    """The column of one host call over ``df``."""
    from polars_tpu_torch.engine.run import _eval_column

    if isinstance(node, E.ECast):
        return cast_to_text(_eval_column(df, node.input), node.dtype)
    if isinstance(node, E.EAnonymous):
        from polars_tpu_torch.engine.udf import call_column

        return call_column(df, node)
    if node.name == "rolling_map":
        from polars_tpu_torch.engine.udf import rolling_map_column

        return rolling_map_column(_eval_column(df, node.inputs[0]), node)
    if node.name == "list.join":
        return list_join_column(_eval_column(df, node.inputs[0]), node.opt("separator", ""),
                                node.opt("ignore_nulls", True))
    if node.name == "struct.json_encode":
        return json_encode_column(_eval_column(df, node.inputs[0]))
    if node.name == "str.json_decode":
        return json_decode_column(_eval_column(df, node.inputs[0]), node.opt("dtype"))
    if isinstance(node, E.EAgg):  # str.join: the input's text joined into one string
        return str_join_column(_eval_column(df, node.input), node.opt("delimiter", ""),
                               node.opt("ignore_nulls", True))
    if node.name == "concat_str":
        return concat_str_column(_eval_columns(df, node.inputs), node.opt("separator", ""),
                                 node.opt("ignore_nulls", False))
    if node.name == "cat.get_categories":
        col = _eval_column(df, node.inputs[0])
        values = col.table.values if col.table is not None else []
        return Column.from_values(col.name, np.asarray(values, dtype=object), dt.String(), device=col.buffer.device)
    if node.name == "cumulative_eval":
        return cumulative_eval_column(_eval_column(df, node.inputs[0]), node)
    if node.name in ("rolling_median_by", "rolling_quantile_by", "rolling_rank_by"):
        return rolling_order_by_column(_eval_column(df, node.inputs[0]), _eval_column(df, node.inputs[1]), node)
    if node.name in ("int_range", "repeat_value"):
        return generate(df, node)
    if node.name == "temporal_range":
        return temporal_range_column(df, node)
    from polars_tpu_torch.engine.sequences import SEQUENCE_FNS, sequence_column

    if node.name in SEQUENCE_FNS:
        return sequence_column(df, node)
    if node.name == "shrink_dtype":
        return shrink_column(_eval_column(df, node.inputs[0]))
    if node.name in ("unique", "unique_counts"):
        return distinct_column(_eval_column(df, node.inputs[0]), node)
    if node.name != "dt.to_string":
        raise InvalidOperationError(f"unknown host function {node.name!r}")
    col = _eval_column(df, node.inputs[0])
    return to_string_column(col, dict(node.options).get("format"))


def _eval_columns(df: DataFrame, nodes) -> list[Column]:
    """The columns of several expressions over ``df``: a column reference
    is the column itself, the others one select together (one count
    read)."""
    from polars_tpu_torch.engine.executors import run_segment

    todo = {i: E.EAlias(n, f"__c{i}") for i, n in enumerate(nodes) if not isinstance(n, E.EColumn)}
    frame = None
    if todo:
        scan = L.LDataFrameScan(df=df, ident=0)
        frame = run_segment(L.LSelect(scan, tuple(todo.values())), [(scan, df)])
    return [frame._get(f"__c{i}") if i in todo else df._get(n.name) for i, n in enumerate(nodes)]


def concat_str_column(cols: list[Column], sep: str, ignore_nulls: bool) -> Column:
    """The inputs' text joined by ``sep`` per row, formatted once per
    distinct tuple of dictionary codes: each input's code + 1 (0 for a
    null) packed into as few int64 words as the dictionaries' sizes allow,
    the distinct tuples taken on the device and read in one host read, each
    tuple joined once, the rows gathered back. A null input makes the row
    null, or, with ``ignore_nulls``, is left out. An input that is no
    dictionary is cast to String first (one more read)."""
    cols = [c if c.table is not None else cast_to_text(c) for c in cols]
    n = max(len(c) for c in cols)
    dev = cols[0].buffer.device
    words: list[torch.Tensor] = []
    layout = []  # (word, shift, bits) of each input
    used = 63
    for c in cols:
        code = c.buffer.values.to(torch.int64) + 1
        if c.buffer.validity is not None:
            code = torch.where(c.buffer.validity, code, 0)
        code = code.expand(n) if len(c) == 1 else code
        bits = (len(c.table) + 1).bit_length()
        if used + bits > 62:
            words.append(torch.zeros(n, dtype=torch.int64, device=dev))
            used = 0
        words[-1] = words[-1] | (code << used)
        layout.append((len(words) - 1, used, bits))
        used += bits
    if len(words) == 1:
        uniq, inv = torch.unique(words[0], return_inverse=True)
        host = uniq.cpu().numpy()[:, None]  # the one read
    else:
        uniq, inv = torch.unique(torch.stack(words, 1), dim=0, return_inverse=True)
        host = uniq.cpu().numpy()
    out = np.full(len(host), "", dtype=object)
    has = np.zeros(len(host), bool)
    null = np.zeros(len(host), bool)
    for c, (w, shift, bits) in zip(cols, layout):
        code = (host[:, w] >> shift) & ((1 << bits) - 1)
        ok = code > 0
        part = np.where(ok, c.table.values[np.maximum(code - 1, 0)] if len(c.table) else "", "")
        if isinstance(c.dtype, dt.Binary):
            part = np.asarray([p.decode(errors="replace") if isinstance(p, bytes) else p for p in part], object)
        out = np.where(ok & has, out + sep + part, np.where(ok, part, out))
        has |= ok
        null |= ~ok
    keep = np.ones(len(host), bool) if ignore_nulls else ~null
    codes, _, table = strtable.encode_strings(np.where(keep, out, None))
    values = take_lut(codes if len(codes) else np.zeros(1, np.int32), inv.reshape(-1)).to(torch.int32)
    validity = None if keep.all() else take_lut(keep, inv.reshape(-1))
    return Column("literal", dt.String(), Buffer(values, validity, n), table)


def str_join_column(col: Column, sep: str, ignore_nulls: bool) -> Column:
    """One string: the column's values joined by ``sep`` in row order (its
    codes read once); a null makes it null, or, with ``ignore_nulls``, is
    left out."""
    values = col.to_pylist()
    if not ignore_nulls and any(v is None for v in values):
        text = None
    else:
        text = sep.join(str(v) for v in values if v is not None)
    return Column.from_values(col.name, [text], dt.String(), device=col.buffer.device)


def exec_host_groupby(node: L.LGroupBy) -> DataFrame:
    """A group-by with host aggregations (``str.join``): the others run as
    a segment, then each host aggregation takes its input's values and the
    keys in one read each and joins each group's values in row order,
    matched to the segment's groups by their key tuples (the JAX package's
    ``run.py:2069-2157``)."""
    from polars_tpu_torch.engine.run import _eval_column, execute_plan
    from polars_tpu_torch.plan.schema_resolve import expand_exprs

    df = execute_plan(node.input)
    keys = expand_exprs(node.keys, df.schema)
    aggs = expand_exprs(node.aggs, df.schema)
    host = [a for a in aggs if E.needs_host_agg(a)]
    scan = L.LDataFrameScan(df=df, ident=0)
    base = execute_plan(L.LGroupBy(scan, keys, tuple(a for a in aggs if a not in host), node.maintain_order))
    key_names = [E.output_name(k) or "literal" for k in keys]
    slot = {kr: i for i, kr in enumerate(zip(*[base._get(k).to_pylist() for k in key_names]))}
    row_keys = list(zip(*[c.to_pylist() for c in _eval_columns(df, keys)]))
    extra = []
    for a in host:
        agg = a.input if isinstance(a, E.EAlias) else a
        if not (isinstance(agg, E.EAgg) and agg.kind in E.HOST_AGGS):
            raise InvalidOperationError("a str.join under a larger expression in a group-by is not ported")
        buckets: list[list] = [[] for _ in slot]
        for kr, v in zip(row_keys, _eval_column(df, agg.input).to_pylist()):
            buckets[slot[kr]].append(v)
        sep, ignore_nulls = agg.opt("delimiter", ""), agg.opt("ignore_nulls", True)
        texts = [None if not ignore_nulls and any(v is None for v in b) else
                 sep.join(str(v) for v in b if v is not None) for b in buckets]
        extra.append(Column.from_values(E.output_name(a) or "literal", texts, dt.String(), device=df.device))
    by_name = {c.name: c for c in list(base._columns) + extra}
    names = key_names + [E.output_name(a) or "literal" for a in aggs]
    return DataFrame._from_columns([by_name[n] for n in names], base.height, device=df.device)


def _scalars(df: DataFrame, nodes) -> list:
    """The Python values of one-value expressions over ``df``: a literal as
    written, the others from one select of them all (its count read and one
    read of each value)."""
    from polars_tpu_torch.engine.executors import run_segment

    out: list = [None] * len(nodes)
    todo = []
    for i, n in enumerate(nodes):
        while isinstance(n, E.EAlias):
            n = n.input
        if isinstance(n, E.ELiteral) and not (isinstance(n.value, str) and n.dtype is not None):
            out[i] = n.value
        else:
            todo.append(i)
    if todo:
        scan = L.LDataFrameScan(df=df, ident=0)
        frame = run_segment(L.LSelect(scan, tuple(E.EAlias(nodes[i], f"__v{i}") for i in todo)), [(scan, df)])
        if frame.height != 1:
            raise InvalidOperationError(f"a generator's bounds must be single values, got {frame.height} rows")
        for i in todo:
            out[i] = frame._get(f"__v{i}").to_pylist()[0]
    return out


def generate(df: DataFrame, node: E.EFunction) -> Column:
    """``int_range`` (``torch.arange`` on the frame's device) or ``repeat``
    (one value gathered ``n`` times): its bounds read once (the JAX
    package's ``run.py:2006-2016``)."""
    device = df.device
    if node.name == "int_range":
        start, end = _scalars(df, node.inputs)
        dtype = node.opt("dtype") or dt.Int64()
        if start is None or end is None:
            raise InvalidOperationError("int_range bounds must not be null")
        values = torch.arange(int(start), int(end), int(node.opt("step", 1)), dtype=torch.int64, device=device)
        from polars_tpu_torch.engine.cast import wrap_int

        return Column("literal", dtype, Buffer(wrap_int(values, dtype), None, values.shape[0]))
    value_node, n_node = node.inputs
    (n,) = _scalars(df, [n_node])
    lit = value_node
    while isinstance(lit, E.EAlias):
        lit = lit.input
    if isinstance(lit, E.ELiteral):
        one = Column.from_values("repeat", [lit.value], lit.dtype, device=device)
    else:
        one = _eval_column(df, value_node)
        if len(one) != 1:
            raise InvalidOperationError("repeat takes one value")
    dtype = node.opt("dtype")
    if dtype is not None and dtype != one.dtype:
        from polars_tpu_torch.core.frame import _cast_column

        one = _cast_column(one, dtype, True)
    idx = torch.zeros(int(n), dtype=torch.int64, device=device)
    buf = one.buffer
    validity = None if buf.validity is None else buf.validity.index_select(0, idx)
    return Column("repeat", one.dtype, Buffer(buf.values.index_select(0, idx), validity, int(n)), one.table)


def _ticks(value, dtype: dt.DataType) -> int:
    """A bound (a date or a datetime) as ticks of ``dtype`` (days of a
    Date, its unit of a Datetime)."""
    if isinstance(dtype, dt.Date):
        day = value.date() if isinstance(value, _pydt.datetime) else value
        return (day - _EPOCH.date()).days
    if not isinstance(value, _pydt.datetime):
        value = _pydt.datetime(value.year, value.month, value.day)
    if value.tzinfo is not None:
        value = value.astimezone(_pydt.timezone.utc).replace(tzinfo=None)
    delta = value - _EPOCH
    us = (delta.days * 86_400 + delta.seconds) * 1_000_000 + delta.microseconds
    return {"ms": us // 1000, "us": us, "ns": us * 1000}[dtype.time_unit]


def temporal_range_column(df: DataFrame, node: E.EFunction) -> Column:
    """A lazy ``date_range``/``datetime_range``: its bounds read once, a
    fixed interval one ``arange`` on the device; a calendar one (months,
    quarters, years) steps on the host (``functions/lazy.temporal_range_values``)."""
    from polars_tpu_torch.engine.fn_generators import _steps
    from polars_tpu_torch.engine.rolling import interval_ticks
    from polars_tpu_torch.functions.lazy import temporal_range_values

    dtype = node.opt("dtype")
    start, end = _scalars(df, node.inputs)
    if start is None or end is None:
        raise InvalidOperationError("a range's bounds must not be null")
    interval, closed = node.opt("interval", "1d"), node.opt("closed", "both")
    try:
        step = interval_ticks(interval, dtype)
    except InvalidOperationError:  # a calendar interval
        values = temporal_range_values(start, end, interval, closed)
        return Column.from_values("literal", values, dtype, device=df.device)
    a, b = _ticks(start, dtype), _ticks(end, dtype)
    first, last = (int(k) for k in _steps(torch.tensor(b - a), torch.tensor(step), closed))  # host ints
    ks = torch.arange(first, max(last + 1, first), dtype=torch.int64, device=df.device)
    values = (a + ks * step).to(dt.dtype_to_torch(dtype))
    return Column("literal", dtype, Buffer(values, None, values.shape[0]))


def distinct_column(col: Column, node: E.EFunction) -> Column:
    """``unique`` (the distinct values, in order of first appearance with
    ``maintain_order``) or ``unique_counts`` (the count of each distinct
    value in order of first appearance) of one column, as a frame's
    ``unique`` and group-by make them (the JAX package's ``run.py:2035-2045``)."""
    from polars_tpu_torch.functions.lazy import len as pl_len

    sub = DataFrame._from_columns([col.rename("__u")], len(col), device=col.buffer.device)
    if node.name == "unique":
        return sub.unique(maintain_order=bool(node.opt("maintain_order", False)))._columns[0].rename(col.name)
    counts = sub.group_by("__u", maintain_order=True).agg(pl_len().alias("__c"))
    return counts._columns[1].rename(col.name)


def shrink_column(col: Column) -> Column:
    """``col`` in the smallest dtype of its kind that holds its values (the
    JAX package's ``run.py:1453-1480``): Float64 becomes Float32; an integer
    takes one read of its non-null count, minimum and maximum (a UInt64 in
    unsigned order, where the JAX package reads 2^63 and more as negative,
    ROADMAP section 3)."""
    from polars_tpu_torch.core.frame import _cast_column
    from polars_tpu_torch.engine.cast import order_word

    d = col.dtype
    if d.is_float():
        return _cast_column(col, dt.Float32(), False) if isinstance(d, dt.Float64) else col
    if not d.is_integer():
        return col
    x = order_word(col.buffer.values.to(torch.int64), d)
    valid = col.buffer.validity
    big = torch.iinfo(torch.int64)
    lo = torch.where(valid, x, big.max).min() if valid is not None else x.min() if len(col) else x.new_tensor(0)
    hi = torch.where(valid, x, big.min).max() if valid is not None else x.max() if len(col) else x.new_tensor(0)
    cnt = valid.sum() if valid is not None else x.new_tensor(len(col))
    cnt, lo, hi = torch.stack([cnt.to(torch.int64), lo, hi]).tolist()  # the one read
    if cnt == 0:
        return _cast_column(col, dt.Int8(), False)
    if isinstance(d, dt.UInt64):
        lo, hi = lo + 2**63, hi + 2**63
    kinds = ("UInt8", "UInt16", "UInt32", "UInt64") if d.is_unsigned_integer() else ("Int8", "Int16", "Int32", "Int64")
    from polars_tpu_torch.engine.cast import int_bounds

    for name in kinds:
        cand = getattr(dt, name)()
        blo, bhi = int_bounds(cand)
        if blo <= lo and hi <= bhi:
            return col if cand == d else _cast_column(col, cand, False)
    return col


def cumulative_eval_column(col: Column, node: E.EFunction) -> Column:
    """``node``'s expression over each prefix of ``col`` (as ``pl.element()``,
    the column named ""), one select per prefix; a prefix shorter than
    ``min_samples`` gives null."""
    from polars_tpu_torch.expr.expr import Expr

    sub = node.opt("expr")
    minp = int(node.opt("min_samples", 1) or 1)
    values = col.to_pylist()
    out = []
    for i in range(len(values)):
        if i + 1 < minp:
            out.append(None)
            continue
        prefix = Column.from_values("", values[: i + 1], col.dtype, device=col.buffer.device)
        frame = DataFrame._from_columns([prefix], i + 1, device=col.buffer.device)
        got = frame.lazy().select(Expr(sub)).collect()._columns[0].to_pylist()
        out.append(got[0] if got else None)
    return Column.from_values(col.name, out, None, device=col.buffer.device)


def rolling_order_by_column(col: Column, by: Column, node: E.EFunction) -> Column:
    """The median, quantile or rank of each row's time window (``closed``,
    ``min_samples``), on the host: the windows by ``searchsorted`` over the
    sorted index, each window's values then taken apart by numpy."""
    from polars_tpu_torch.engine.rolling import interval_ticks

    ticks = interval_ticks(node.opt("window_size"), by.dtype)
    closed = node.opt("closed", "right") or "right"
    minp = int(node.opt("min_samples", 1) or 1)
    n = len(col)
    tvals, tvalid = by._host()
    t = np.asarray(tvals[:n], np.int64)
    ok = np.ones(n, bool) if tvalid is None else np.asarray(tvalid[:n], bool)
    xlist = col.to_pylist()
    x = np.asarray([np.nan if v is None else float(v) for v in xlist], np.float64)
    val_ok = np.asarray([v is not None for v in xlist], bool)
    order = np.argsort(t[ok], kind="stable")
    ts, xs, xs_ok = t[ok][order], x[ok][order], val_ok[ok][order]
    lo_side, hi_side = {"right": ("right", "right"), "left": ("left", "left"), "both": ("left", "right"),
                        "none": ("right", "left")}[closed]
    los = np.searchsorted(ts, t - ticks, side=lo_side)
    his = np.searchsorted(ts, t, side=hi_side)
    q = float(node.opt("quantile", 0.5) or 0.5)
    interp = node.opt("interpolation", "nearest") or "nearest"
    method = node.opt("method", "average") or "average"
    desc = bool(node.opt("descending", False))
    out = np.full(n, np.nan)
    has = np.zeros(n, bool)
    for i in range(n):
        if not ok[i]:
            continue
        w = xs[los[i]:his[i]][xs_ok[los[i]:his[i]]]
        if len(w) < minp or len(w) == 0:
            continue
        if node.name == "rolling_median_by":
            out[i] = float(np.median(w))
        elif node.name == "rolling_quantile_by":
            out[i] = float(np.quantile(w, q, method=interp if interp in ("linear", "lower", "higher", "midpoint")
                                       else "nearest"))
        else:  # the rank of the row's own value in its window
            if not val_ok[i]:
                continue
            wv, cv = (-w, -x[i]) if desc else (w, x[i])
            less, ties = int((wv < cv).sum()), int((wv == cv).sum())
            out[i] = {"min": less + 1, "max": less + ties,
                      "dense": len(np.unique(wv[wv < cv])) + 1}.get(method, less + (ties + 1) / 2.0)
        has[i] = True
    values = [float(v) if h else None for v, h in zip(out.tolist(), has.tolist())]
    if node.name == "rolling_rank_by" and method != "average":
        return Column.from_values(col.name, [None if v is None else int(v) for v in values], dt.UInt32(),
                                  device=col.buffer.device)
    return Column.from_values(col.name, values, dt.Float64(), device=col.buffer.device)


def _text_of(x, dtype: dt.DataType) -> str:
    """One value's text as the JAX package's cast gives it (``true`` and
    ``false`` for a Boolean, Python's ``repr`` of a float); a Decimal with
    its column's scale, as Polars writes it (``-2.50``; the JAX package
    drops trailing zeros)."""
    if isinstance(dtype, dt.Boolean):
        return "true" if x else "false"
    if isinstance(dtype, dt.Decimal) and dtype.scale:
        whole, frac = divmod(abs(int(x)), 10**dtype.scale)
        return f"{'-' if x < 0 else ''}{whole}.{frac:0{dtype.scale}d}"
    if dtype.is_float():
        return repr(float(x))
    return str(x)


def cast_to_text(col: Column, target: dt.DataType | None = None) -> Column:
    """``col`` cast to String: each distinct storage value (a float by its
    bits) formatted once on the host (one read), the strings made a sorted
    dictionary, the rows gathered by code. A String stays as it is; a
    Date, Datetime or Time formats as ``dt.to_string`` does without a
    format. A List or Array (``target`` a List of String) casts its child."""
    if isinstance(col.dtype, (dt.List, dt.Array)):
        if not isinstance(target, (dt.List, dt.Array)):
            raise InvalidOperationError(f"cannot cast {col.dtype!r} to {target!r}")
        return Column(col.name, target, col.buffer, None, cast_to_text(col.child, target.inner))
    if isinstance(col.dtype, dt.String):
        return col
    if isinstance(col.dtype, (dt.Categorical, dt.Enum)):  # its dictionary's text
        return Column(col.name, dt.String(), col.buffer, col.table)
    if isinstance(col.dtype, (dt.Date, dt.Datetime, dt.Time)):
        return to_string_column(col, None)
    if not (col.dtype.is_numeric() or isinstance(col.dtype, (dt.Boolean, dt.Null))):
        raise InvalidOperationError(f"cannot cast {col.dtype!r} to String")
    values, validity = col.buffer.values, col.buffer.validity
    if validity is not None:
        values = torch.where(validity, values, torch.zeros((), dtype=values.dtype, device=values.device))
    bits = values.view(torch.int64 if values.dtype == torch.float64 else torch.int32) if values.is_floating_point() \
        else values
    uniq, inv = torch.unique(bits, return_inverse=True)
    host = Column(col.name, col.dtype, Buffer(uniq.view(values.dtype), None, len(uniq)))._host()[0]
    texts = [_text_of(x, col.dtype) for x in host.tolist()]
    return _text_column(col, texts, inv, validity)


def list_join_column(col: Column, sep: str, ignore_nulls: bool) -> Column:
    """Each list's text joined by ``sep`` on the host (a null element
    leaves the row null unless ``ignore_nulls``)."""
    out = []
    for row in col.to_pylist():
        if row is None or (not ignore_nulls and any(x is None for x in row)):
            out.append(None)
        else:
            out.append(sep.join(x for x in row if x is not None))
    return Column.from_values(col.name, out, dt.String(), device=col.buffer.device)


def json_encode_column(col: Column) -> Column:
    """Each struct as compact JSON text, on the host."""
    import json

    out = [None if r is None else json.dumps(r, separators=(",", ":"), default=str) for r in col.to_pylist()]
    return Column.from_values(col.name, out, dt.String(), device=col.buffer.device)


def json_decode_column(col: Column, dtype: dt.DataType | None) -> Column:
    """Each string parsed as JSON: each dictionary value once on the host
    (null where it does not parse), the parsed values made one column of
    ``dtype`` (else of the type they infer) with one copy to the device,
    and the rows gathered from it by their codes there."""
    import json

    from polars_tpu_torch.engine.gather import gather_column

    def parse(text):
        try:
            return json.loads(text)
        except ValueError:
            return None

    values = [parse(t) for t in col.table.values.tolist()] if col.table is not None else []
    entries = Column.from_values(col.name, values, dtype, device=col.buffer.device)
    if not values:  # no dictionary value: every row is null
        entries = Column.from_values(col.name, [None], entries.dtype, device=col.buffer.device)
    return gather_column(entries, col.buffer.values.to(torch.int64), col.buffer.validity)


def _text_column(col: Column, texts: list[str], inv: torch.Tensor, validity) -> Column:
    """A String column of ``col``'s rows from the text of each distinct
    value and each row's index among them."""
    table = sorted(set(texts)) or [""]
    rank = {t: i for i, t in enumerate(table)}
    remap = np.fromiter((rank[t] for t in texts), np.int32, count=len(texts))
    codes = take_lut(remap, inv).to(torch.int32) if len(remap) else torch.zeros(len(col), dtype=torch.int32,
                                                                                 device=col.buffer.device)
    return Column(col.name, dt.String(), Buffer(codes, validity, len(col)),
                  strtable.StringTable(np.asarray(table, dtype=object), sorted_order=True))


def to_string_column(col: Column, fmt: str | None) -> Column:
    """``col`` formatted as text: each distinct value once on the host (one
    read), the strings made a sorted dictionary, the rows gathered by code.
    A Duration reads as Python's ``timedelta`` (``1:00:00``), as the JAX
    package gives it, whatever the format."""
    if not isinstance(col.dtype, (dt.Date, dt.Datetime, dt.Time, dt.Duration)):
        raise InvalidOperationError(f"dt.to_string expects a Date, Datetime, Time or Duration, got {col.dtype!r}")
    values, validity = col.buffer.values, col.buffer.validity
    if validity is not None:  # whatever lies under a null formats as the epoch
        values = torch.where(validity, values, torch.zeros((), dtype=values.dtype, device=values.device))
    uniq, inv = torch.unique(values, return_inverse=True)
    return _text_column(col, format_values(uniq.cpu().numpy(), col.dtype, fmt), inv, validity)


def format_values(storage: np.ndarray, dtype: dt.DataType, fmt: str | None) -> list[str]:
    """The text of each storage value of a Date, Datetime or Time column."""
    if isinstance(dtype, dt.Duration):
        per_s = dt.TICKS_PER_SECOND[dtype.time_unit]
        return [str(_pydt.timedelta(microseconds=x * 1_000_000 // per_s)) for x in storage.tolist()]
    out = []
    for x in storage.tolist():
        value, nanos = _python_value(x, dtype)
        out.append(str(value) if fmt is None else strftime(value, nanos, fmt))
    return out


def _python_value(x: int, dtype: dt.DataType):
    """(the Python date, datetime or time of a storage value, the
    nanoseconds within its second); a Datetime with a time zone is an aware
    datetime of its zone."""
    if isinstance(dtype, dt.Date):
        return _pydt.date(1970, 1, 1) + _pydt.timedelta(days=x), 0
    if isinstance(dtype, dt.Time):
        s, ns = divmod(x, 1_000_000_000)
        return _pydt.time(s // 3600, s // 60 % 60, s % 60, ns // 1000), ns
    per_s = dt.TICKS_PER_SECOND[dtype.time_unit]
    s, frac = divmod(x, per_s)
    nanos = frac * (1_000_000_000 // per_s)
    delta = _pydt.timedelta(seconds=s, microseconds=nanos // 1000)
    if dtype.time_zone:
        from polars_tpu_torch.kernels.timezone import zone

        return (_EPOCH_UTC + delta).astimezone(zone(dtype.time_zone)), nanos
    return _EPOCH + delta, nanos


def strftime(value, nanos: int, fmt: str) -> str:
    """``value`` in chrono's format ``fmt``: the fraction and ``%:z``
    specifiers here, the rest by Python's ``strftime``."""

    def sub(m: re.Match) -> str:
        spec = m.group(1)
        if spec == "%":
            return "%%"
        if spec == ":z":
            off = value.utcoffset() if isinstance(value, _pydt.datetime) else None
            if off is None:
                return ""
            mins = int(off.total_seconds()) // 60
            return f"{'-' if mins < 0 else '+'}{abs(mins) // 60:02d}:{abs(mins) % 60:02d}"
        digits = f"{nanos:09d}"
        if spec == "f":
            return digits
        if spec == ".f":  # as many digits as the value needs, of 3, 6 and 9
            if nanos == 0:
                return ""
            width = 3 if nanos % 1_000_000 == 0 else 6 if nanos % 1_000 == 0 else 9
            return "." + digits[:width]
        width = int(spec[-2])
        return ("." if spec.startswith(".") else "") + digits[:width]

    return value.strftime(_CHRONO.sub(sub, fmt))

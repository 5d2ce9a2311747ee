"""Host functions: the expressions that run on the host between segments
(the port of ``polars_tpu/engine/run.py``'s hoisting of ``HOST_FNS``,
``_hoist_host_exprs`` and ``_eval_host``, trimmed to ``dt.to_string``).

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
from polars_tpu_torch.errors import InvalidOperationError
from polars_tpu_torch.plan import exprs as E
from polars_tpu_torch.plan import logical as L
from polars_tpu_torch.utils import strtable
from polars_tpu_torch.utils.tokens import next_token

_EPOCH = _pydt.datetime(1970, 1, 1)
_EPOCH_UTC = _pydt.datetime(1970, 1, 1, tzinfo=_pydt.timezone.utc)
# the chrono specifiers Python lacks or reads otherwise
_CHRONO = re.compile(r"%(%|\.[369]?f|[369]f|f|:z)")


def exec_host_select(node: L.LSelect | L.LWithColumns) -> DataFrame:
    """Run a select or with_columns that calls host functions: the input,
    then each call on the host, then the rest as one segment."""
    from polars_tpu_torch.engine.executors import run_segment
    from polars_tpu_torch.engine.join import _renamed
    from polars_tpu_torch.engine.run import execute_plan
    from polars_tpu_torch.plan.schema_resolve import _rebuild_expr

    df = execute_plan(node.input)
    hoisted: list[Column] = []

    def hoist(e: E.ENode) -> E.ENode:
        if isinstance(e, E.EFunction) and e.name in E.HOST_FNS:
            out = _host_call(df, e)
            if len(out) == 1:  # an aggregate's or a literal's: a scalar, as in the JAX package
                return E.ESeriesLit(column=out, ident=next_token())
            if len(out) != df.height:
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
    frame = DataFrame._from_columns(list(df._columns) + hoisted, df.height, device=df.device)
    scan = L.LDataFrameScan(df=frame, ident=0)
    return run_segment(L.LSelect(scan, tuple(exprs)), [(scan, frame)])


def _host_call(df: DataFrame, node: E.EFunction) -> Column:
    from polars_tpu_torch.engine.run import _eval_column

    if node.name != "dt.to_string":
        raise InvalidOperationError(f"unknown host function {node.name!r}")
    col = _eval_column(df, node.inputs[0])
    return to_string_column(col, dict(node.options).get("format"))


def to_string_column(col: Column, fmt: str | None) -> Column:
    """``col`` formatted as text: each distinct value once on the host (one
    read), the strings made a sorted dictionary, the rows gathered by code."""
    if not isinstance(col.dtype, (dt.Date, dt.Datetime, dt.Time)):
        raise InvalidOperationError(f"dt.to_string expects a Date, Datetime or Time, got {col.dtype!r}")
    values, validity = col.buffer.values, col.buffer.validity
    if validity is not None:  # whatever lies under a null formats as the epoch
        values = torch.where(validity, values, torch.zeros((), dtype=values.dtype, device=values.device))
    uniq, inv = torch.unique(values, return_inverse=True)
    texts = format_values(uniq.cpu().numpy(), col.dtype, fmt)
    table = sorted(set(texts)) or [""]
    rank = {t: i for i, t in enumerate(table)}
    remap = np.fromiter((rank[t] for t in texts), np.int32, count=len(texts))
    codes = take_lut(remap, inv).to(torch.int32) if len(remap) else torch.zeros_like(values, dtype=torch.int32)
    return Column(col.name, dt.String(), Buffer(codes, validity, len(col)),
                  strtable.StringTable(np.asarray(table, dtype=object), sorted_order=True))


def format_values(storage: np.ndarray, dtype: dt.DataType, fmt: str | None) -> list[str]:
    """The text of each storage value of a Date, Datetime or Time column."""
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

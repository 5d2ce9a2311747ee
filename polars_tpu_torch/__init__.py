"""polars_tpu_torch: the PyTorch/CUDA port of polars_tpu for one NVIDIA H100.

Same API and query semantics as ``polars_tpu`` (``import polars_tpu_torch as
pl``), ported slice by slice; it runs all 22 PDS-H queries (filters, joins
of every ``how``, group-bys, one-row aggregate selects, sorts and top-k,
string predicates and slices; ``unique``, ``rename``, ``drop``,
``with_row_index`` and lazy ``concat``; Date, Datetime, Duration and Time columns,
their arithmetic, time zones and the ``dt`` namespace with ``to_string``;
string-to-temporal parsing and the null functions; range joins
(``join_where``) and asof joins; a join that sizes its output on the host
runs between fused segments). Every collect runs the plan the optimizer
(``plan/optimizer``) gives, unless the caller asks for the plan as written;
``LazyFrame.explain`` shows it. Plain tensor work is
PyTorch; the group aggregation (K1) and the segment-end compaction (K2) are
CUDA kernels written for sm_90a (``csrc/``), built with nvcc at first use.

Entry points run on ``cuda`` unless the caller asks for the CPU
(``DataFrame(..., device="cpu")`` or :func:`set_default_device`). The port
never imports JAX or ``polars_tpu``.
"""

from __future__ import annotations

from polars_tpu_torch import datatypes
from polars_tpu_torch.config import set_default_device
from polars_tpu_torch.core.frame import DataFrame
from polars_tpu_torch.core.schema import Schema
from polars_tpu_torch.core.series import Series
from polars_tpu_torch.datatypes import (
    Boolean,
    Date,
    Datetime,
    Duration,
    Float32,
    Float64,
    Int8,
    Int16,
    Int32,
    Int64,
    String,
    Time,
    UInt8,
    UInt16,
    UInt32,
    UInt64,
    Utf8,
)
from polars_tpu_torch.errors import (
    ColumnNotFoundError,
    ComputeError,
    DuplicateError,
    InvalidOperationError,
    PolarsError,
    SchemaError,
    ShapeError,
)
from polars_tpu_torch.expr.expr import Expr
from polars_tpu_torch.functions.eager import concat
from polars_tpu_torch.functions.interop import QueryOptFlags
from polars_tpu_torch.functions.lazy import (  # noqa: A004
    coalesce, col, date, date_range, datetime, datetime_range, duration, len, lit, when,
)
from polars_tpu_torch.functions.parity import business_day_count
from polars_tpu_torch.lazyframe import LazyFrame

__all__ = [
    "Boolean", "ColumnNotFoundError", "ComputeError", "DataFrame", "Date", "Datetime", "DuplicateError",
    "Duration", "Expr", "Float32", "Float64", "Int8", "Int16", "Int32", "Int64", "InvalidOperationError",
    "LazyFrame", "PolarsError", "QueryOptFlags", "Schema", "SchemaError", "Series", "ShapeError", "String", "Time",
    "UInt8", "UInt16", "UInt32", "UInt64", "Utf8", "business_day_count", "coalesce", "col", "concat", "datatypes",
    "date", "date_range", "datetime", "datetime_range", "duration", "len", "lit", "set_default_device", "when",
]

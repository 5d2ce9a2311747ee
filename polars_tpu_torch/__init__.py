"""polars_tpu_torch: the PyTorch/CUDA port of polars_tpu for one NVIDIA H100.

Same API and query semantics as ``polars_tpu`` (``import polars_tpu_torch as
pl``), ported slice by slice; it runs PDS-H Q1, Q3, Q4, Q5, Q6, Q10, Q11,
Q12, Q14, Q15, Q17, Q18, Q19 and Q20 (filters, joins of every ``how``,
group-bys, one-row aggregate selects, sorts and top-k; a join that sizes
its output on the host runs between fused segments). Plain tensor work is
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
    Float32,
    Float64,
    Int8,
    Int16,
    Int32,
    Int64,
    String,
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
from polars_tpu_torch.functions.lazy import col, len, lit, when  # noqa: A004
from polars_tpu_torch.lazyframe import LazyFrame

__all__ = [
    "Boolean", "ColumnNotFoundError", "ComputeError", "DataFrame", "Date", "DuplicateError",
    "Expr", "Float32", "Float64", "Int8", "Int16", "Int32", "Int64", "InvalidOperationError",
    "LazyFrame", "PolarsError", "Schema", "SchemaError", "Series", "ShapeError", "String",
    "UInt8", "UInt16", "UInt32", "UInt64", "Utf8", "col", "concat", "datatypes", "len", "lit",
    "set_default_device", "when",
]

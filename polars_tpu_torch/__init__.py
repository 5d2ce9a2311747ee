"""polars_tpu_torch: the PyTorch/CUDA port of polars_tpu for one NVIDIA H100.

Same API and query semantics as ``polars_tpu`` (``import polars_tpu_torch as
pl``), ported slice by slice; it runs all 22 PDS-H queries (filters, joins
of every ``how``, group-bys, one-row aggregate selects, sorts and top-k,
string predicates and slices; ``unique``, ``rename``, ``drop``,
``with_row_index`` and lazy ``concat``; Date, Datetime, Duration and Time columns,
their arithmetic, time zones and the ``dt`` namespace with ``to_string``;
string-to-temporal parsing and the null functions; the eager ``DataFrame``
and ``Series`` API; math and cast expressions, the statistical aggregations,
wildcards, selectors and the ``name`` namespace; windows (``over``), the
order and position functions and expression-level sort, filter, slice and
gather; rolling and dynamic windows; the horizontal functions, folds,
recoding, bins, hashes, corr/cov and Decimal columns; range joins
(``join_where``) and asof joins; a join that sizes its output on the host
runs between fused segments). Every collect runs the plan the optimizer
(``plan/optimizer``) gives, unless the caller asks for the plan as written;
``LazyFrame.explain`` shows it. Plain tensor work is
PyTorch; the group aggregation (K1) and the segment-end compaction (K2) are
CUDA kernels written for sm_90a (``csrc/``), built with nvcc at first use.
Files are read and written on the host (``io/``: Parquet with its pushdowns,
CSV, IPC, NDJSON, databases, Delta, Arrow and pandas interchange), each
column copied once to the frame's device; pyarrow and pandas are imported
only by the functions that need them.

Entry points run on ``cuda`` unless the caller asks for the CPU
(``DataFrame(..., device="cpu")`` or :func:`set_default_device`). The port
never imports JAX or ``polars_tpu``.
"""

from __future__ import annotations

from polars_tpu_torch import api, datatypes, exceptions, selectors
from polars_tpu_torch.config import Config, set_default_device
from polars_tpu_torch.core.frame import DataFrame
from polars_tpu_torch.core.schema import Schema
from polars_tpu_torch.core.series import Series
from polars_tpu_torch.datatypes import (
    Binary,
    Boolean,
    Categorical,
    Date,
    Datetime,
    Decimal,
    Duration,
    Enum,
    Float32,
    Float64,
    Int8,
    Int16,
    Int32,
    Int64,
    List,
    Array,
    Field,
    Struct,
    Null,
    String,
    Time,
    UInt8,
    UInt16,
    UInt32,
    UInt64,
    Utf8,
    DataType,
    Float16,
    Int128,
    UInt128,
    Object,
    Unknown,
    Categories,
    DataTypeExpr,
    dtype_of,
    self_dtype,
    struct_with_fields,
)
from polars_tpu_torch.errors import (
    ColumnNotFoundError,
    ComputeError,
    DuplicateError,
    InvalidOperationError,
    NoDataError,
    OutOfBoundsError,
    PolarsError,
    QueryCancelledError,
    SchemaError,
    SchemaFieldNotFoundError,
    ShapeError,
    SQLInterfaceError,
    SQLSyntaxError,
)
from polars_tpu_torch.expr.expr import Expr
from polars_tpu_torch.functions.eager import concat
from polars_tpu_torch.functions.interop import (
    CompatLevel, FileProviderArgs, QueryOptFlags, defer, from_arrow, from_pandas, from_repr, from_torch, json_normalize,
)
from polars_tpu_torch.functions.lazy import (  # noqa: A004
    all, all_horizontal, any, any_horizontal, approx_n_unique, arange, arg_sort_by, arg_where, coalesce, col,
    concat_arr, concat_list, concat_str, corr, count, cov, cum_count, cum_sum, date, date_range, date_ranges, datetime,
    datetime_range, datetime_ranges, duration, element, exclude, field, first, fold, format, head, implode,
    int_range, int_ranges, last, len, linear_spaces, lit, max, max_horizontal, mean, mean_horizontal, median, min,
    min_horizontal, n_unique, nth, ones, quantile, reduce, repeat, select, std, struct, sum, sum_horizontal, tail,
    time_ranges, var, when, zeros,
)
from polars_tpu_torch.functions.parity import (
    StringCache, align_frames, arctan2, arctan2d, build_info, business_day_count, collect_all, collect_all_async,
    cum_fold, cum_reduce, cum_sum_horizontal, disable_string_cache, enable_string_cache, escape_regex, explain_all,
    from_epoch, get_index_type, groups, linear_space, map_batches, map_groups, merge_sorted, rolling_corr,
    rolling_cov, row_index, set_random_seed, show_versions, thread_pool_size, threadpool_size, time, time_range,
    union, using_string_cache,
)
from polars_tpu_torch.functions.parity import list_ as list  # noqa: A004
from polars_tpu_torch.io import (
    read_avro, read_clipboard, read_csv, read_csv_batched, read_database, read_database_uri, read_delta, read_excel,
    read_ipc, read_ipc_schema, read_ipc_stream, read_json, read_lines, read_ndjson, read_ods, read_parquet,
    read_parquet_metadata, read_parquet_schema, scan_arrow_c_stream, scan_csv, scan_delta, scan_iceberg, scan_ipc,
    scan_lines, scan_ndjson, scan_parquet, scan_pyarrow_dataset,
)
from polars_tpu_torch.io.cloud import (
    Catalog, CredentialProvider, CredentialProviderAWS, CredentialProviderAzure, CredentialProviderFunction,
    CredentialProviderFunctionReturn, CredentialProviderGCP,
)
from polars_tpu_torch.io.scan_options import ScanCastOptions
from polars_tpu_torch.lazyframe import LazyFrame
from polars_tpu_torch.later import install as _install, package_stubs as _package_stubs

for _owner, _cls in (("DataFrame", DataFrame), ("LazyFrame", LazyFrame), ("Expr", Expr), ("Series", Series)):
    _install(_owner, _cls)
globals().update({k: v for k, v in _package_stubs().items() if k not in globals()})

__all__ = [
    "Binary", "Boolean", "Categorical", "ColumnNotFoundError", "ComputeError", "Config", "DataFrame", "Date",
    "Datetime", "Decimal", "DuplicateError", "Duration", "Enum", "Expr", "Float32", "Float64", "Int8", "Int16",
    "Int32", "Int64", "List", "Array", "Field", "Struct", "Null", "InvalidOperationError", "LazyFrame",
    "PolarsError", "QueryOptFlags", "Schema", "SchemaError", "Series", "ShapeError", "String", "Time", "UInt8",
    "UInt16", "UInt32", "UInt64", "Utf8", "all", "all_horizontal", "any", "any_horizontal", "api",
    "approx_n_unique", "arange", "arctan2", "arctan2d", "arg_sort_by", "business_day_count", "coalesce", "col",
    "concat", "concat_list", "concat_str", "corr", "count", "cov", "cum_count", "cum_sum", "datatypes", "date",
    "date_range", "datetime", "datetime_range", "duration", "element", "exceptions", "exclude", "field", "first",
    "format", "fold", "head", "implode", "int_range", "last", "len", "lit", "max", "max_horizontal", "mean",
    "mean_horizontal", "median", "min", "min_horizontal", "n_unique", "nth", "ones", "quantile", "reduce", "repeat",
    "select", "selectors", "set_default_device", "std", "struct", "sum", "sum_horizontal", "tail", "var", "when",
    "zeros", "align_frames", "arg_where", "collect_all", "concat_arr", "cum_fold", "cum_reduce", "cum_sum_horizontal",
    "date_ranges", "datetime_ranges", "escape_regex", "explain_all", "from_epoch", "int_ranges", "linear_space",
    "linear_spaces", "map_batches", "map_groups", "merge_sorted", "rolling_corr", "rolling_cov", "row_index",
    "set_random_seed", "time", "time_range", "time_ranges", "union", "defer", "from_repr", "from_torch",
    "json_normalize", "Catalog", "CompatLevel", "CredentialProvider", "CredentialProviderAWS",
    "CredentialProviderAzure", "CredentialProviderFunction", "CredentialProviderFunctionReturn",
    "CredentialProviderGCP", "FileProviderArgs", "ScanCastOptions", "from_arrow", "from_pandas", "read_avro",
    "read_clipboard", "read_csv", "read_csv_batched", "read_database", "read_database_uri", "read_delta",
    "read_excel", "read_ipc", "read_ipc_schema", "read_ipc_stream", "read_json", "read_lines", "read_ndjson",
    "read_ods", "read_parquet", "read_parquet_metadata", "read_parquet_schema", "scan_arrow_c_stream", "scan_csv",
    "scan_delta", "scan_iceberg", "scan_ipc", "scan_lines", "scan_ndjson", "scan_parquet", "scan_pyarrow_dataset",
]

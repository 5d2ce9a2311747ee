"""Arrow <-> column conversion (the port of ``polars_tpu/io/_arrow.py``; the
FFI boundary analogue, polars-arrow/src/ffi/).

Decoding stays on the host: each Arrow array becomes numpy arrays there,
which go to the frame's device in one copy each (``Buffer.from_numpy``).
Strings, Binary and Categorical values are dictionary-encoded on the host,
by Arrow: a dictionary of at most ``config().ordinal_dict_max`` values is
sorted (codes in lexicographic order), a larger one keeps Arrow's order of
first occurrence (``StringTable(sorted_order=False)``), the port's ordinal
rule. A null of Arrow's validity bitmap is a null of the column; a float
NaN stays a value. A List's ``(start << 32) | length`` words come from its
Arrow offsets over the whole child, an Array's from its fixed size, a
Struct's fields from its flattened children.

pyarrow is imported inside each function: the package imports without it.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from polars_tpu_torch import datatypes as dt
from polars_tpu_torch.core.buffer import Buffer
from polars_tpu_torch.core.column import Column, object_array
from polars_tpu_torch.utils import strtable


def _arrow_dtype_to_polars(t: Any) -> dt.DataType:
    import pyarrow as pa

    flat = ((pa.types.is_int8, dt.Int8), (pa.types.is_int16, dt.Int16), (pa.types.is_int32, dt.Int32),
            (pa.types.is_int64, dt.Int64), (pa.types.is_uint8, dt.UInt8), (pa.types.is_uint16, dt.UInt16),
            (pa.types.is_uint32, dt.UInt32), (pa.types.is_uint64, dt.UInt64), (pa.types.is_float32, dt.Float32),
            (pa.types.is_float64, dt.Float64), (pa.types.is_float16, dt.Float64), (pa.types.is_boolean, dt.Boolean),
            (pa.types.is_null, dt.Null))
    for test, d in flat:
        if test(t):
            return d()
    if pa.types.is_string(t) or pa.types.is_large_string(t) or pa.types.is_string_view(t):
        return dt.String()
    if pa.types.is_binary(t) or pa.types.is_large_binary(t) or pa.types.is_fixed_size_binary(t):
        return dt.Binary()
    if pa.types.is_date32(t) or pa.types.is_date64(t):
        return dt.Date()
    if pa.types.is_timestamp(t):
        return dt.Datetime(t.unit if t.unit in ("ms", "us", "ns") else "us", t.tz)
    if pa.types.is_duration(t):
        return dt.Duration(t.unit if t.unit in ("ms", "us", "ns") else "us")
    if pa.types.is_time32(t) or pa.types.is_time64(t):
        return dt.Time()
    if pa.types.is_decimal(t):
        return dt.Decimal(t.precision, t.scale)
    if pa.types.is_dictionary(t):
        return dt.Categorical()
    if pa.types.is_fixed_size_list(t):
        return dt.Array(_arrow_dtype_to_polars(t.value_type), t.list_size)
    if pa.types.is_list(t) or pa.types.is_large_list(t):
        return dt.List(_arrow_dtype_to_polars(t.value_type))
    if pa.types.is_struct(t):
        return dt.Struct([(f.name, _arrow_dtype_to_polars(f.type)) for f in t])
    raise NotImplementedError(f"arrow type {t}")


def arrow_schema_to_schema(sch: Any):
    from polars_tpu_torch.core.schema import Schema

    return Schema([(f.name, _arrow_dtype_to_polars(f.type)) for f in sch])


def _validity(arr: Any) -> np.ndarray | None:
    return np.asarray(arr.is_valid()) if arr.null_count else None


def _put(values: np.ndarray, validity: np.ndarray | None, logical: dt.DataType, device) -> Buffer:
    return Buffer.from_numpy(values, validity, dtype=dt.dtype_to_torch(logical), device=device)


def _dictionary_column(name: str, arr: Any, logical: dt.DataType, device) -> Column:
    """A String, Binary or Categorical column: codes on the device, values in
    a host table (sorted up to ``ordinal_dict_max`` values)."""
    import pyarrow as pa
    import pyarrow.compute as pc

    from polars_tpu_torch.config import config

    if not pa.types.is_dictionary(arr.type):
        arr = pc.dictionary_encode(arr)
    elif len(pc.unique(arr.dictionary)) != len(arr.dictionary):  # a dictionary may repeat a value
        arr = pc.dictionary_encode(arr.dictionary_decode())
    codes = arr.indices
    validity = _validity(codes)
    codes_np = codes.fill_null(0).to_numpy(zero_copy_only=False).astype(np.int32)
    binary = isinstance(logical, dt.Binary)
    values = arr.dictionary.to_pylist()
    if binary:  # bytes stay bytes (no str coercion of non-UTF-8 payloads)
        values = [bytes(v) for v in values]
    if len(values) > config().ordinal_dict_max:
        table = strtable.StringTable(object_array(values), sorted_order=False)
    else:
        uniq = sorted(values)
        lookup = {v: i for i, v in enumerate(uniq)}
        inv = np.fromiter((lookup[v] for v in values), np.int32, len(values))
        codes_np = inv[codes_np] if len(values) else codes_np
        table = strtable.StringTable(object_array(uniq), sorted_order=True)
    out_dt = logical if isinstance(logical, (dt.Categorical, dt.Binary)) else dt.String()
    return Column(name, out_dt, Buffer.from_numpy(codes_np, validity, dtype=torch.int32, device=device), table)


def _decimal_words(arr: Any, validity: np.ndarray | None) -> np.ndarray:
    """The unscaled integers of a decimal array, as int64 (the port's
    Decimal is int64). A 32- or 64-bit value is widened; a little-endian
    128- or 256-bit value keeps its low word, and raises where a valid
    value does not fit it (a high word that is not the low word's sign)."""
    bits = arr.type.bit_width
    if bits <= 64:
        raw = np.frombuffer(arr.buffers()[1], dtype=np.int32 if bits == 32 else np.int64)
        return raw[arr.offset:arr.offset + len(arr)].astype(np.int64)
    words = bits // 64
    raw = np.frombuffer(arr.buffers()[1], dtype=np.int64)[arr.offset * words:(arr.offset + len(arr)) * words]
    raw = raw.reshape(len(arr), words)
    lo = raw[:, 0].copy()
    bad = (raw[:, 1:] != (lo >> 63)[:, None]).any(axis=1)
    if validity is not None:
        bad &= validity
    if bad.any():
        from polars_tpu_torch.exceptions import ComputeError

        raise ComputeError(f"decimal overflow: a {arr.type} value does not fit in 64 bits")
    return lo


def arrow_array_to_column(name: str, arr: Any, override: dt.DataType | None = None, *, device) -> Column:
    """One Arrow array (or chunked array) as a column on ``device``."""
    import pyarrow as pa

    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks() if arr.num_chunks != 1 else arr.chunk(0)
    t = arr.type
    logical = _arrow_dtype_to_polars(t)
    if isinstance(logical, (dt.String, dt.Binary, dt.Categorical)):
        if pa.types.is_string_view(t) or pa.types.is_fixed_size_binary(t):
            arr = arr.cast(pa.large_string() if isinstance(logical, dt.String) else pa.large_binary())
        return _maybe_cast(_dictionary_column(name, arr, logical, device), override)
    validity = _validity(arr)
    if isinstance(logical, (dt.List, dt.Array)):
        n = len(arr)
        if isinstance(logical, dt.List):
            offs = np.asarray(arr.offsets, dtype=np.int64)
            starts, lens = offs[:-1], np.diff(offs)
        else:
            size = logical.size
            starts = (arr.offset + np.arange(n, dtype=np.int64)) * size
            lens = np.full(n, size, np.int64)
        words = (starts << 32) | lens
        if validity is not None:
            words = np.where(validity, words, 0)
        child = arrow_array_to_column("", arr.values, device=device)
        col = Column(name, dt.List(child.dtype) if isinstance(logical, dt.List) else dt.Array(child.dtype, logical.size),
                     Buffer.from_numpy(words, validity, dtype=torch.int64, device=device), None, child)
        return _maybe_cast(col, override)
    if isinstance(logical, dt.Struct):
        fields = [arrow_array_to_column(f.name, child, device=device) for f, child in zip(t, arr.flatten())]
        ids = np.arange(len(arr), dtype=np.int64)
        col = Column(name, dt.Struct([(c.name, c.dtype) for c in fields]),
                     Buffer.from_numpy(ids, validity, dtype=torch.int64, device=device), None, fields)
        return _maybe_cast(col, override)
    if isinstance(logical, dt.Null):
        n = len(arr)
        return Column(name, logical, Buffer.from_numpy(np.zeros(n, np.int32), np.zeros(n, bool), dtype=torch.int32,
                                                       device=device))
    if isinstance(logical, dt.Decimal):
        vals = _decimal_words(arr, validity)
        if validity is not None:
            vals = np.where(validity, vals, 0)
        return _maybe_cast(Column(name, logical, _put(vals, validity, logical, device)), override)
    if validity is not None:
        arr = arr.fill_null(_zero_for(t))
    if pa.types.is_date64(t):
        arr = arr.cast(pa.date32())
    if pa.types.is_date32(arr.type):
        vals = np.asarray(arr.cast(pa.int32()))
    elif pa.types.is_timestamp(t) or pa.types.is_duration(t):
        # rescale other units (pyarrow.json infers timestamp[s]) to the
        # logical unit before taking the int64 ticks
        if t.unit != logical.time_unit:
            arr = arr.cast(pa.timestamp(logical.time_unit, t.tz) if pa.types.is_timestamp(t)
                           else pa.duration(logical.time_unit))
        vals = np.asarray(arr.cast(pa.int64()))
    elif pa.types.is_time32(t) or pa.types.is_time64(t):
        factor = {"s": 1_000_000_000, "ms": 1_000_000, "us": 1_000, "ns": 1}[t.unit]
        vals = np.asarray(arr.cast(pa.int32() if pa.types.is_time32(t) else pa.int64())).astype(np.int64) * factor
    else:
        vals = arr.to_numpy(zero_copy_only=False)
        if pa.types.is_float16(t):
            vals = vals.astype(np.float64)
    return _maybe_cast(Column(name, logical, _put(vals, validity, logical, device)), override)


def _maybe_cast(col: Column, override: dt.DataType | None) -> Column:
    if override is None or override == col.dtype:
        return col
    from polars_tpu_torch.core.frame import _cast_column

    return _cast_column(col, override, False)


def _zero_for(t: Any):
    import pyarrow as pa

    return False if pa.types.is_boolean(t) else 0


def dtype_to_arrow(d: dt.DataType) -> Any:
    """Logical dtype -> pyarrow type (inverse of _arrow_dtype_to_polars)."""
    import pyarrow as pa

    n = type(d).__name__
    flat = {
        "Int8": pa.int8(), "Int16": pa.int16(), "Int32": pa.int32(), "Int64": pa.int64(), "UInt8": pa.uint8(),
        "UInt16": pa.uint16(), "UInt32": pa.uint32(), "UInt64": pa.uint64(), "Float32": pa.float32(),
        "Float64": pa.float64(), "Boolean": pa.bool_(), "String": pa.large_string(), "Binary": pa.large_binary(),
        "Date": pa.date32(), "Time": pa.time64("ns"), "Null": pa.null(), "Categorical": pa.large_string(),
        "Enum": pa.large_string(),
    }
    if n in flat:
        return flat[n]
    if n == "Datetime":
        return pa.timestamp(d.time_unit, tz=d.time_zone)
    if n == "Duration":
        return pa.duration(d.time_unit)
    if n == "Decimal":
        return pa.decimal128(d.precision or 38, d.scale)
    if n == "List":
        return pa.large_list(dtype_to_arrow(d.inner))
    if n == "Array":
        return pa.list_(dtype_to_arrow(d.inner), d.size)
    if n == "Struct":
        return pa.struct([(f.name, dtype_to_arrow(f.dtype)) for f in d.fields])
    raise TypeError(f"no arrow type for {d!r}")


def column_to_arrow(c: Column) -> Any:
    """A column as a pyarrow array of its logical type (``to_arrow`` and the
    Parquet and IPC writers): a Categorical or Enum dictionary-encoded so
    that a file round trip gives a Categorical back, a float NaN a value and
    not a null."""
    import pyarrow as pa

    d = c.dtype
    if isinstance(d, (dt.String, dt.Categorical, dt.Enum, dt.Binary)):
        values = c.to_numpy()
        arr = pa.array(values, type=pa.binary() if isinstance(d, dt.Binary) else pa.string())
        if isinstance(d, (dt.Categorical, dt.Enum)):
            import pyarrow.compute as pc

            return pc.dictionary_encode(arr)
        return arr
    if isinstance(d, (dt.List, dt.Array, dt.Struct, dt.Decimal)):
        return pa.array(c.to_pylist(), type=dtype_to_arrow(d))
    if isinstance(d, dt.Null):
        return pa.nulls(len(c))
    vals, validity = c._host()
    mask = None if validity is None else ~np.asarray(validity, bool)
    at = dtype_to_arrow(d)
    if isinstance(d, dt.Date):
        return pa.array(np.asarray(vals).astype(np.int32), type=at, mask=mask)
    if isinstance(d, (dt.Datetime, dt.Duration, dt.Time)):
        return pa.array(np.asarray(vals).astype(np.int64), type=at, mask=mask)
    return pa.array(np.asarray(vals), type=at, mask=mask)


def arrow_to_columns(table: Any, overrides: dict | None = None, *, device) -> list[Column]:
    overrides = overrides or {}
    cols = []
    for name in table.column_names:
        o = overrides.get(name)
        cols.append(arrow_array_to_column(name, table.column(name), dt.parse_into_dtype(o) if o is not None else None,
                                          device=device))
    return cols


def arrow_to_df(table: Any, overrides: dict | None = None, *, device=None):
    """An Arrow table (or record batch) as a frame on ``device`` (the
    default device when None)."""
    from polars_tpu_torch.config import resolve_device
    from polars_tpu_torch.core.frame import DataFrame

    dev = resolve_device(device)
    return DataFrame._from_columns(arrow_to_columns(table, overrides, device=dev), table.num_rows, device=dev)

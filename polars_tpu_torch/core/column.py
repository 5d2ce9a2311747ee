"""Typed columns: name + logical dtype + device buffer + (optional) dictionary.

The port of ``polars_tpu/core/column.py``, trimmed to the construction the
ported queries need: numpy arrays (float, int, bool, ``datetime64`` and
``timedelta64``, NaT as null) and object or str arrays / Python lists of
strings, numbers, bools, dates, datetimes, timedeltas, times and
``decimal.Decimal`` values (a Decimal holds int64 scaled by 10^scale and
goes back to Python as ``decimal.Decimal``). String
columns hold int32 dictionary codes in the buffer and the values in
``table``; Date holds int32 days, Datetime and Duration int64 ticks of their
time unit, Time int64 nanoseconds since midnight. A Datetime with a time
zone stores UTC instants; Python datetimes that share one ``tzinfo`` build
one, and it goes back to Python as datetimes of its zone.

Nested columns (the JAX package's layout, ``core/column.py:65-69``): a List
or Array column's buffer holds int64 ``(start << 32) | length`` into a flat
``child`` column, so rows gather and permute without touching the child,
and rows may share a range of it; a Struct column's buffer holds row ids
into its field columns (``child``, a list of columns, one per field).
"""

from __future__ import annotations

import datetime as _dt
import decimal as _decimal
from typing import Any

import numpy as np
import torch

from polars_tpu_torch import datatypes as dt
from polars_tpu_torch.core.buffer import Buffer
from polars_tpu_torch.errors import ComputeError, InvalidOperationError, ShapeError
from polars_tpu_torch.utils import strtable

_EPOCH_DATE = _dt.date(1970, 1, 1)
_EPOCH_DT = _dt.datetime(1970, 1, 1)
_EPOCH_DT_UTC = _dt.datetime(1970, 1, 1, tzinfo=_dt.timezone.utc)
_NS_PER = (3_600_000_000_000, 60_000_000_000, 1_000_000_000)  # hour, minute, second


def _needs_table(dtype: dt.DataType) -> bool:
    return isinstance(dtype, (dt.String, dt.Categorical, dt.Enum, dt.Binary))


class Column:
    """One named, typed column over a device buffer."""

    __slots__ = ("name", "dtype", "buffer", "table", "child")

    def __init__(self, name: str, dtype: dt.DataType, buffer: Buffer, table: strtable.StringTable | None = None,
                 child: Column | list[Column] | None = None) -> None:
        self.name = name
        self.dtype = dtype
        self.buffer = buffer
        self.table = table
        self.child = child
        if _needs_table(dtype) and table is None:
            self.table = strtable.empty_table()

    @staticmethod
    def from_values(name: str, values: Any, dtype: dt.DataType | None = None, *, device,
                    strict: bool = True) -> Column:
        """Build a column on ``device`` from a numpy array or Python sequence
        (an Enum's value outside its categories raises, or, without
        ``strict``, is null)."""
        if dtype is not None:
            dtype = dt.parse_into_dtype(dtype)
        if isinstance(values, np.ndarray) and values.dtype.kind not in ("O", "U", "S"):
            col = _from_numpy(name, values, device)
        else:
            col = _from_pylist(name, values, dtype, device, strict)
        if dtype is not None and dtype != col.dtype:  # a strict cast, as a one-column plan
            from polars_tpu_torch.core.frame import _cast_column

            col = _cast_column(col, dtype, True)
        return col

    def rename(self, name: str) -> Column:
        return Column(name, self.dtype, self.buffer, self.table, self.child)

    def with_buffer(self, buffer: Buffer) -> Column:
        """The same column (dtype, dictionary, child) over another buffer."""
        return Column(self.name, self.dtype, buffer, self.table, self.child)

    def null_count(self) -> int:
        v = self.buffer.validity
        return 0 if v is None else int((~v).sum())

    def __len__(self) -> int:
        return self.buffer.length

    def _host(self) -> tuple[np.ndarray, np.ndarray | None]:
        """(values, validity or None) on the host, the values in the logical
        numpy dtype: UInt16/UInt32 narrow from their wider signed tensor and
        UInt64 reinterprets the bits of its int64 tensor."""
        vals, validity = self.buffer.to_numpy()
        if isinstance(self.dtype, dt.UInt64):
            vals = vals.view(np.uint64)
        elif isinstance(self.dtype, (dt.UInt16, dt.UInt32)):
            vals = vals.astype(dt.dtype_to_numpy(self.dtype))
        return vals, validity

    def to_numpy(self) -> np.ndarray:
        """Materialize as numpy; nulls -> NaN for floats, None otherwise
        (a nested column: an object array of its Python values)."""
        if isinstance(self.dtype, dt.NestedType):
            return object_array(self.to_pylist())
        vals, validity = self._host()
        if _needs_table(self.dtype):
            return self.table.take(np.where(validity, vals, -1) if validity is not None else vals)
        if isinstance(self.dtype, dt.Date):
            out = vals.astype("datetime64[D]").astype(object)
            return _mask_to_object(out, validity)
        if isinstance(self.dtype, (dt.Datetime, dt.Duration)):
            kind = "datetime64" if isinstance(self.dtype, dt.Datetime) else "timedelta64"
            out = vals.astype(f"{kind}[{self.dtype.time_unit}]")
            if self.dtype.time_unit == "ns":  # Python's datetime and timedelta hold microseconds
                out = out.astype(f"{kind}[us]")
            out = out.astype(object)
            if isinstance(self.dtype, dt.Datetime) and self.dtype.time_zone:
                from polars_tpu_torch.kernels.timezone import zone

                tz = zone(self.dtype.time_zone)
                out = np.asarray([None if d is None else d.replace(tzinfo=_dt.timezone.utc).astimezone(tz)
                                  for d in out], dtype=object)
            return _mask_to_object(out, validity)
        if isinstance(self.dtype, dt.Time):
            out = np.empty(len(vals), dtype=object)
            for i, ns in enumerate(vals.tolist()):
                out[i] = _dt.time(ns // _NS_PER[0], ns // _NS_PER[1] % 60, ns // _NS_PER[2] % 60,
                                  ns % 1_000_000_000 // 1000)
            return _mask_to_object(out, validity)
        if isinstance(self.dtype, dt.Decimal):  # floats, as the JAX package gives them (NaN for null)
            out = vals.astype(np.float64) / 10.0**self.dtype.scale
            return out if validity is None else np.where(validity, out, np.nan)
        if validity is None:
            return vals
        if vals.dtype.kind == "f":
            return np.where(validity, vals, np.nan)
        return _mask_to_object(vals.astype(object), validity)

    def to_pylist(self) -> list:
        if isinstance(self.dtype, (dt.List, dt.Array)):
            packed, validity = self._host()
            ok = [True] * len(packed) if validity is None else validity.tolist()
            if self.child is None and any(good and p & 0xFFFFFFFF for p, good in zip(packed.tolist(), ok)):
                raise ComputeError(f"column {self.name!r} of {self.dtype!r} has lost its elements")
            items = self.child.to_pylist() if self.child is not None else []
            return [items[p >> 32:(p >> 32) + (p & 0xFFFFFFFF)] if good else None
                    for p, good in zip(packed.tolist(), ok)]
        if isinstance(self.dtype, dt.Struct):
            ids, validity = self._host()
            ok = [True] * len(ids) if validity is None else validity.tolist()
            if self.child is None and self.dtype.fields and any(ok):
                raise ComputeError(f"column {self.name!r} of {self.dtype!r} has lost its fields")
            fields = [(c.name, c.to_pylist()) for c in self.child or []]
            return [{name: vals[i] for name, vals in fields} if good else None for i, good in zip(ids.tolist(), ok)]
        if isinstance(self.dtype, dt.Decimal):  # decimal.Decimal values, exact
            vals, validity = self._host()
            ok = [True] * len(vals) if validity is None else validity.tolist()
            return [_decimal.Decimal(int(v)).scaleb(-self.dtype.scale) if good else None
                    for v, good in zip(vals.tolist(), ok)]
        if isinstance(self.dtype, dt.FloatType):
            # NaN is a VALUE for float columns (distinct from null)
            vals, validity = self._host()
            lst = vals.tolist()
            if validity is None:
                return lst
            return [v if ok else None for v, ok in zip(lst, validity.tolist())]
        arr = self.to_numpy()
        return arr.tolist() if arr.dtype != object else list(arr)

    def __repr__(self) -> str:
        return f"Column(name={self.name!r}, dtype={self.dtype!r}, len={len(self)})"


def object_array(values: list) -> np.ndarray:
    """A 1-D object array of ``values`` (numpy would make lists of one
    length a 2-D array)."""
    out = np.empty(len(values), dtype=object)
    for i, v in enumerate(values):
        out[i] = v
    return out


def _mask_to_object(out: np.ndarray, validity: np.ndarray | None) -> np.ndarray:
    if validity is not None:
        out = out.astype(object)
        out[~validity] = None
    return out


def _from_numpy(name: str, arr: np.ndarray, device) -> Column:
    if arr.ndim != 1:
        raise ShapeError(f"Column values must be 1-D, got shape {arr.shape}")
    validity = None
    if arr.dtype.kind == "f":
        # NaN in numpy input means null, as in polars_tpu
        nulls = np.isnan(arr)
        if nulls.any():
            validity = ~nulls
            arr = np.where(validity, arr, 0)
    if arr.dtype.kind in ("M", "m"):  # datetime64 / timedelta64; NaT is null
        logical = dt.numpy_to_dtype(arr.dtype)
        nat = np.isnat(arr)
        validity = ~nat if nat.any() else None
        if isinstance(logical, dt.Date):
            ints = arr.astype("datetime64[D]").astype(np.int64).astype(np.int32)
        else:
            kind = "datetime64" if arr.dtype.kind == "M" else "timedelta64"
            ints = arr.astype(f"{kind}[{logical.time_unit}]").astype(np.int64)
        if validity is not None:
            ints = np.where(validity, ints, 0)
        return Column(name, logical, Buffer.from_numpy(ints, validity, dtype=dt.dtype_to_torch(logical),
                                                       device=device))
    logical = dt.numpy_to_dtype(arr.dtype)
    return Column(name, logical, Buffer.from_numpy(arr, validity, dtype=dt.dtype_to_torch(logical), device=device))


def _infer_pylist_dtype(seq: list) -> dt.DataType:
    # numpy scalars count as the Python type they hold
    kinds = {int if isinstance(v, np.integer) else float if isinstance(v, np.floating) else
             bool if isinstance(v, np.bool_) else type(v) for v in seq if v is not None}
    if not kinds:
        return dt.Null()
    if kinds <= {str, np.str_}:
        return dt.String()
    if kinds <= {bytes, bytearray}:
        return dt.Binary()
    if kinds == {bool}:
        return dt.Boolean()
    if kinds <= {int}:
        return dt.Int64()
    if kinds <= {int, float}:
        return dt.Float64()
    if kinds == {_dt.date}:
        return dt.Date()
    if kinds <= {_dt.date, _dt.datetime}:
        # one zone among the aware values makes an aware Datetime (the JAX
        # package's rule: naive values read as UTC instants beside them)
        from polars_tpu_torch.kernels.timezone import zone_name

        zones = {zone_name(v.tzinfo) for v in seq if isinstance(v, _dt.datetime) and v.tzinfo is not None}
        return dt.Datetime("us", zones.pop() if len(zones) == 1 else None)
    if kinds == {_dt.timedelta}:
        return dt.Duration("us")
    if kinds == {_dt.time}:
        return dt.Time()
    if _decimal.Decimal in kinds and kinds <= {_decimal.Decimal, int}:
        # the largest scale among the values (the JAX package's inference)
        exps = [v.as_tuple().exponent for v in seq if isinstance(v, _decimal.Decimal)]
        return dt.Decimal(38, max([0] + [-e for e in exps if isinstance(e, int) and e < 0]))
    raise NotImplementedError(
        f"building a column from Python values of types {sorted(k.__name__ for k in kinds)} "
        "is not ported yet (port queue: expression breadth)"
    )


def _is_nested_value(v: Any) -> bool:
    return isinstance(v, (list, tuple, dict)) or (isinstance(v, np.ndarray) and v.ndim >= 1)


def _nested_dtype(seq: list) -> dt.DataType:
    """The dtype of Python lists or dicts: a List of the elements' dtype, or
    a Struct of each key's, in the order the keys first appear (the JAX
    package's inference)."""
    vals = [v for v in seq if v is not None]
    if all(isinstance(v, dict) for v in vals):
        names = list(dict.fromkeys(k for v in vals for k in v))
        return dt.Struct([(k, _infer_any([v.get(k) for v in vals])) for k in names])
    return dt.List(_infer_any([x for v in vals for x in v]))


def _infer_any(seq: list) -> dt.DataType:
    first = next((v for v in seq if v is not None), None)
    return _nested_dtype(seq) if _is_nested_value(first) else _infer_pylist_dtype(seq)


def _nested_from_pylist(name: str, seq: list, dtype: dt.DataType | None, device, strict: bool) -> Column:
    """A List, Array or Struct column from Python values: the elements (a
    field's values) become the child column, built by the same rules."""
    logical = dtype if dtype is not None else _nested_dtype(seq)
    n = len(seq)
    validity = np.fromiter((v is not None for v in seq), bool, n)
    if isinstance(logical, dt.Struct):
        fields = [Column.from_values(f.name, [None if v is None else v.get(f.name) for v in seq], f.dtype,
                                     device=device, strict=strict) for f in logical.fields]
        buf = Buffer.from_numpy(np.arange(n, dtype=np.int64), validity, dtype=torch.int64, device=device)
        return Column(name, logical, buf, None, fields)
    if not isinstance(logical, (dt.List, dt.Array)):
        raise InvalidOperationError(f"cannot build a {logical!r} column from nested Python values")
    lens = np.fromiter((0 if v is None else len(v) for v in seq), np.int64, n)
    if isinstance(logical, dt.Array) and (lens[validity] != logical.size).any():
        bad = int(lens[validity][lens[validity] != logical.size][0])
        raise InvalidOperationError(f"Array column expects lists of length {logical.size}, got {bad}")
    flat = [x for v in seq if v is not None for x in v]
    child = Column.from_values("", flat, logical.inner, device=device, strict=strict)
    starts = np.cumsum(lens) - lens
    buf = Buffer.from_numpy((starts << 32) | lens, validity, dtype=torch.int64, device=device)
    return Column(name, logical, buf, None, child)


def _from_pylist(name: str, seq: Any, dtype: dt.DataType | None, device, strict: bool = True) -> Column:
    if isinstance(dtype, dt.NestedType) or (
            dtype is None and _is_nested_value(next((v for v in seq if v is not None), None))):
        return _nested_from_pylist(name, list(seq), dtype, device, strict)
    arr = np.asarray(seq, dtype=object) if not isinstance(seq, np.ndarray) else seq
    if arr.dtype.kind in ("U", "S"):
        arr = arr.astype(object)
    logical = dtype if dtype is not None else _infer_pylist_dtype(arr.tolist() if arr.size < 4096 else _sample(arr))
    if _needs_table(logical):
        codes, validity, table = strtable.encode_strings(arr)
        if isinstance(logical, dt.Enum):  # codes are category positions
            table_e = strtable.enum_table(logical.categories)
            codes = table_e.codes_of(table.values.tolist())[codes] if len(codes) else codes
            valid = np.ones(len(codes), bool) if validity is None else validity
            if strict and (valid & (codes < 0)).any():
                bad = arr[valid & (codes < 0)][0]
                raise InvalidOperationError(f"value {bad!r} is not in the Enum categories {logical.categories}")
            validity = valid & (codes >= 0)
            codes, table = np.maximum(codes, 0).astype(np.int32), table_e
            validity = None if validity.all() else validity
        return Column(name, logical, Buffer.from_numpy(codes, validity, dtype=torch.int32, device=device), table)
    validity = np.fromiter((v is not None for v in arr), bool, len(arr))
    if isinstance(logical, dt.Null):
        zeros = np.zeros(len(arr), np.int32)
        return Column(name, logical, Buffer.from_numpy(zeros, validity, dtype=torch.int32, device=device))
    if isinstance(logical, dt.Date):
        days = np.fromiter(
            ((v - _EPOCH_DATE).days if v is not None else 0 for v in arr), np.int32, len(arr)
        )
        return Column(name, logical, Buffer.from_numpy(days, validity, dtype=torch.int32, device=device))
    if isinstance(logical, (dt.Datetime, dt.Duration, dt.Time)):
        ticks = np.asarray([0 if v is None else _ticks(v, logical) for v in arr], dtype=np.int64)
        return Column(name, logical, Buffer.from_numpy(ticks, validity, dtype=torch.int64, device=device))
    if isinstance(logical, dt.Decimal):
        scaled = np.fromiter((0 if v is None else _scaled_decimal(v, logical.scale) for v in arr), np.int64, len(arr))
        return Column(name, logical, Buffer.from_numpy(scaled, validity, dtype=torch.int64, device=device))
    if isinstance(logical, (dt.Boolean, dt.IntegerType, dt.FloatType)):
        np_d = dt.dtype_to_numpy(logical)
        vals = np.asarray([v if v is not None else 0 for v in arr], dtype=np_d)
        return Column(name, logical, Buffer.from_numpy(vals, validity, dtype=dt.dtype_to_torch(logical), device=device))
    raise InvalidOperationError(f"cannot build a {logical!r} column from Python values")


def _scaled_decimal(v: Any, scale: int) -> int:
    """One value as Decimal storage: its digits shifted by ``scale``, a
    decimal rounded half to even, an integer exact, a float rounded."""
    if isinstance(v, _decimal.Decimal):
        return int(v.scaleb(scale).to_integral_value(_decimal.ROUND_HALF_EVEN))
    if isinstance(v, (int, np.integer)):
        return int(v) * 10**scale
    return round(float(v) * 10**scale)


def _micros(delta: _dt.timedelta) -> int:
    """Exact microseconds of a timedelta (no float on the way)."""
    return (delta.days * 86_400 + delta.seconds) * 1_000_000 + delta.microseconds


def _ticks(v: Any, dtype: dt.DataType) -> int:
    """One Python value as the int64 storage of a Datetime, Duration or Time
    column: ticks of the time unit since the epoch (a date counts from its
    midnight), ticks of a timedelta, nanoseconds since midnight; an int is
    its storage already. Floor division takes micro- to milliseconds."""
    if isinstance(v, (int, np.integer)) and not isinstance(v, bool):
        return int(v)
    if isinstance(dtype, dt.Time):
        if not isinstance(v, _dt.time):
            raise InvalidOperationError(f"cannot build a Time value from {v!r}")
        if v.tzinfo is not None:
            raise InvalidOperationError(f"a Time holds no time zone: {v!r}")
        return v.hour * _NS_PER[0] + v.minute * _NS_PER[1] + v.second * _NS_PER[2] + v.microsecond * 1000
    if isinstance(dtype, dt.Duration):
        if not isinstance(v, _dt.timedelta):
            raise InvalidOperationError(f"cannot build a Duration value from {v!r}")
        micros = _micros(v)
    elif isinstance(v, _dt.datetime):
        # an aware datetime is its UTC instant; a naive one is read as one
        micros = _micros(v - _EPOCH_DT_UTC) if v.tzinfo is not None else _micros(v - _EPOCH_DT)
    elif isinstance(v, _dt.date):
        micros = (v - _EPOCH_DATE).days * 86_400_000_000
    else:
        raise InvalidOperationError(f"cannot build a {dtype!r} value from {v!r}")
    return micros * dt.TICKS_PER_SECOND[dtype.time_unit] // 1_000_000


def _sample(arr: np.ndarray) -> list:
    """Dtype inference on a large object array looks at its non-null values
    through a bounded prefix plus the full type scan only when mixed."""
    head = [v for v in arr[:4096].tolist() if v is not None]
    if head and all(isinstance(v, str) for v in head):
        return head
    return arr.tolist()

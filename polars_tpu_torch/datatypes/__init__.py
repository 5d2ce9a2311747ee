"""Data types for polars_tpu_torch (a copy of polars_tpu/datatypes/__init__.py, with a
PyTorch storage mapping added).

Logical type lattice mirroring the reference (polars-core/src/datatypes/dtype.rs:90-145
and py-polars/src/polars/datatypes/classes.py), mapped onto TPU-friendly physical
storage:

- integers/floats/bool -> dense torch tensors (+ validity mask)
- String/Categorical/Enum -> dictionary-encoded int32 codes + host-side value table
  (the BASELINE.json north star: "variable-length strings are handled via ...
  dictionary-encoded i32 keys so every operator stays dense and vectorizable")
- Date -> int32 days since epoch; Datetime -> int64 (us default); Duration -> int64;
  Time -> int64 nanoseconds since midnight
- List/Array/Struct -> nested (offsets/fixed-stride/children), kept minimal for now.
"""

from __future__ import annotations

import datetime as _pydt
from typing import Any

import numpy as np


class DataTypeClass(type):
    """Metaclass so bare classes (``Int64``) behave like instances."""

    def __repr__(cls) -> str:
        return cls.__name__

    def __hash__(cls) -> int:
        return hash(cls.__name__)

    def __eq__(cls, other: Any) -> bool:  # noqa: ANN401
        if other is None:
            return False
        if isinstance(other, DataTypeClass):
            return cls.__name__ == other.__name__
        if isinstance(other, DataType):
            # Bare class equals any parametrization of the same type.
            return cls.__name__ == type(other).__name__
        return NotImplemented

    def __ne__(cls, other: Any) -> bool:  # noqa: ANN401
        result = cls.__eq__(other)
        return result if result is NotImplemented else not result

    # Allow e.g. ``dtype in (pl.Int64, pl.Float64)`` and classification helpers
    def is_numeric(cls) -> bool:
        return cls().is_numeric()

    def is_integer(cls) -> bool:
        return cls().is_integer()

    def is_signed_integer(cls) -> bool:
        return cls().is_signed_integer()

    def is_unsigned_integer(cls) -> bool:
        return cls().is_unsigned_integer()

    def is_float(cls) -> bool:
        return cls().is_float()

    def is_temporal(cls) -> bool:
        return cls().is_temporal()

    def is_nested(cls) -> bool:
        return cls().is_nested()

    def is_(cls, other: Any) -> bool:  # noqa: ANN401
        return cls == other and hash(cls) == hash(other)

    def base_type(cls) -> DataTypeClass:
        return cls


class DataType(metaclass=DataTypeClass):
    """Base class for all polars_tpu data types."""

    __slots__ = ()

    def __repr__(self) -> str:
        return type(self).__name__

    def __eq__(self, other: Any) -> bool:  # noqa: ANN401
        if other is None:
            return False
        if isinstance(other, DataTypeClass):
            return type(self).__name__ == other.__name__
        if isinstance(other, DataType):
            return self._key() == other._key()
        return NotImplemented

    def __ne__(self, other: Any) -> bool:  # noqa: ANN401
        result = self.__eq__(other)
        return result if result is NotImplemented else not result

    def __hash__(self) -> int:
        return hash(type(self).__name__)

    def _key(self) -> tuple:
        return (type(self).__name__,)

    def base_type(self) -> DataTypeClass:
        return type(self)

    def is_(self, other: Any) -> bool:  # noqa: ANN401
        return self == other

    def is_numeric(self) -> bool:
        return isinstance(self, NumericType)

    def is_decimal(self) -> bool:
        return isinstance(self, Decimal)

    def is_integer(self) -> bool:
        return isinstance(self, IntegerType)

    def is_signed_integer(self) -> bool:
        return isinstance(self, SignedIntegerType)

    def is_unsigned_integer(self) -> bool:
        return isinstance(self, UnsignedIntegerType)

    def is_float(self) -> bool:
        return isinstance(self, FloatType)

    def is_temporal(self) -> bool:
        return isinstance(self, TemporalType)

    def is_nested(self) -> bool:
        return isinstance(self, NestedType)

    def max(self):
        raise NotImplementedError

    def min(self):
        raise NotImplementedError


class NumericType(DataType):
    __slots__ = ()


class IntegerType(NumericType):
    __slots__ = ()

    def max(self) -> int:
        return int(np.iinfo(dtype_to_numpy(self)).max)

    def min(self) -> int:
        return int(np.iinfo(dtype_to_numpy(self)).min)


class SignedIntegerType(IntegerType):
    __slots__ = ()


class UnsignedIntegerType(IntegerType):
    __slots__ = ()


class FloatType(NumericType):
    __slots__ = ()

    def max(self) -> float:
        return float(np.finfo(dtype_to_numpy(self)).max)

    def min(self) -> float:
        return float(np.finfo(dtype_to_numpy(self)).min)


class TemporalType(DataType):
    __slots__ = ()


class NestedType(DataType):
    __slots__ = ()


class ObjectType(DataType):
    __slots__ = ()


class Int8(SignedIntegerType):
    __slots__ = ()


class Int16(SignedIntegerType):
    __slots__ = ()


class Int32(SignedIntegerType):
    __slots__ = ()


class Int64(SignedIntegerType):
    __slots__ = ()


class Int128(SignedIntegerType):
    __slots__ = ()


class UInt8(UnsignedIntegerType):
    __slots__ = ()


class UInt16(UnsignedIntegerType):
    __slots__ = ()


class UInt32(UnsignedIntegerType):
    __slots__ = ()


class UInt64(UnsignedIntegerType):
    __slots__ = ()


class UInt128(UnsignedIntegerType):
    __slots__ = ()


class Float16(FloatType):
    """Half precision; stored as f32 on device. Reference: py-polars
    datatypes Float16 (itself marked experimental)."""

    __slots__ = ()


class Float32(FloatType):
    __slots__ = ()


class Float64(FloatType):
    __slots__ = ()


class Decimal(NumericType):
    """Fixed-point decimal; stored as int128-emulated int64 pair or int64 scaled.

    Round-1 physical storage: int64 scaled by 10**scale (covers PDS-H monetary
    columns, which fit easily; reference: dtype.rs Decimal(38)).
    """

    __slots__ = ("precision", "scale")

    def __init__(self, precision: int | None = None, scale: int = 0) -> None:
        self.precision = precision
        self.scale = scale

    def _key(self) -> tuple:
        return ("Decimal", self.precision, self.scale)

    def __hash__(self) -> int:
        return hash("Decimal")

    def __repr__(self) -> str:
        return f"Decimal(precision={self.precision}, scale={self.scale})"


class Boolean(DataType):
    __slots__ = ()


class String(DataType):
    """UTF-8 string, dictionary-encoded (i32 codes + host value table)."""

    __slots__ = ()


# Alias kept for API parity with py-polars
Utf8 = String


class Binary(DataType):
    __slots__ = ()


class Categorical(DataType):
    __slots__ = ("ordering",)

    def __init__(self, ordering: str = "physical") -> None:
        self.ordering = ordering

    def _key(self) -> tuple:
        return ("Categorical",)

    def __hash__(self) -> int:
        return hash("Categorical")


class Enum(DataType):
    __slots__ = ("categories",)

    def __init__(self, categories: Any = None) -> None:
        if categories is None:
            self.categories = []
        else:
            self.categories = list(categories)

    def _key(self) -> tuple:
        return ("Enum", tuple(self.categories))

    def __hash__(self) -> int:
        return hash("Enum")

    def __repr__(self) -> str:
        return f"Enum(categories={self.categories!r})"


class Date(TemporalType):
    """Days since UNIX epoch, int32."""

    __slots__ = ()


class Datetime(TemporalType):
    """Microseconds (default) since UNIX epoch, int64."""

    __slots__ = ("time_unit", "time_zone")

    def __init__(self, time_unit: str = "us", time_zone: str | None = None) -> None:
        if time_unit not in ("ms", "us", "ns"):
            from polars_tpu_torch.errors import InvalidOperationError

            raise InvalidOperationError(f"invalid time_unit: {time_unit!r}")
        self.time_unit = time_unit
        self.time_zone = time_zone

    def _key(self) -> tuple:
        return ("Datetime", self.time_unit, self.time_zone)

    def __hash__(self) -> int:
        return hash("Datetime")

    def __repr__(self) -> str:
        return f"Datetime(time_unit='{self.time_unit}', time_zone={self.time_zone!r})"


class Duration(TemporalType):
    __slots__ = ("time_unit",)

    def __init__(self, time_unit: str = "us") -> None:
        self.time_unit = time_unit

    def _key(self) -> tuple:
        return ("Duration", self.time_unit)

    def __hash__(self) -> int:
        return hash("Duration")

    def __repr__(self) -> str:
        return f"Duration(time_unit='{self.time_unit}')"


# ticks of each Datetime/Duration time unit in one second
TICKS_PER_SECOND = {"ms": 1_000, "us": 1_000_000, "ns": 1_000_000_000}


class Time(TemporalType):
    """Nanoseconds since midnight, int64."""

    __slots__ = ()


class List(NestedType):
    __slots__ = ("inner",)

    def __init__(self, inner: Any = None) -> None:
        self.inner = parse_into_dtype(inner) if inner is not None else Null()

    def _key(self) -> tuple:
        return ("List", self.inner)

    def __hash__(self) -> int:
        return hash("List")

    def __repr__(self) -> str:
        return f"List({self.inner!r})"


class Array(NestedType):
    __slots__ = ("inner", "size")

    def __init__(self, inner: Any = None, shape: Any = None, *, size: int | None = None) -> None:
        self.inner = parse_into_dtype(inner) if inner is not None else Null()
        if shape is not None:
            self.size = int(shape) if not isinstance(shape, (tuple, list)) else int(shape[0])
        else:
            self.size = int(size) if size is not None else 0

    def _key(self) -> tuple:
        return ("Array", self.inner, self.size)

    def __hash__(self) -> int:
        return hash("Array")

    def __repr__(self) -> str:
        return f"Array({self.inner!r}, shape=({self.size},))"


class Field:
    __slots__ = ("name", "dtype")

    def __init__(self, name: str, dtype: Any) -> None:
        self.name = name
        self.dtype = parse_into_dtype(dtype)

    def __eq__(self, other: Any) -> bool:  # noqa: ANN401
        return isinstance(other, Field) and self.name == other.name and self.dtype == other.dtype

    def __hash__(self) -> int:
        return hash((self.name, self.dtype))

    def __repr__(self) -> str:
        return f"Field({self.name!r}, {self.dtype!r})"


class Struct(NestedType):
    __slots__ = ("fields",)

    def __init__(self, fields: Any = None) -> None:
        if fields is None:
            self.fields = []
        elif isinstance(fields, dict):
            self.fields = [Field(n, d) for n, d in fields.items()]
        else:
            self.fields = [f if isinstance(f, Field) else Field(*f) for f in fields]

    def _key(self) -> tuple:
        return ("Struct", tuple(self.fields))

    def __hash__(self) -> int:
        return hash("Struct")

    def __repr__(self) -> str:
        return f"Struct({self.fields!r})"

    def to_schema(self) -> dict:
        return {f.name: f.dtype for f in self.fields}


class Null(DataType):
    __slots__ = ()


class Object(ObjectType):
    __slots__ = ()


class Unknown(DataType):
    __slots__ = ()


# ---------------------------------------------------------------------------
# numpy <-> dtype mapping (physical storage types)
# ---------------------------------------------------------------------------

_DTYPE_TO_NUMPY = {
    "Int8": np.int8,
    "Int16": np.int16,
    "Int32": np.int32,
    "Int64": np.int64,
    "UInt8": np.uint8,
    "UInt16": np.uint16,
    "UInt32": np.uint32,
    "UInt64": np.uint64,
    "Float16": np.float32,
    "Float32": np.float32,
    "Float64": np.float64,
    "Boolean": np.bool_,
    "Date": np.int32,
    "Datetime": np.int64,
    "Duration": np.int64,
    "Time": np.int64,
    "String": np.int32,  # dictionary codes
    "Categorical": np.int32,
    "Enum": np.int32,
    "Binary": np.int32,
    "Decimal": np.int64,
}

_NUMPY_TO_DTYPE = {
    np.dtype(np.int8): Int8,
    np.dtype(np.int16): Int16,
    np.dtype(np.int32): Int32,
    np.dtype(np.int64): Int64,
    np.dtype(np.uint8): UInt8,
    np.dtype(np.uint16): UInt16,
    np.dtype(np.uint32): UInt32,
    np.dtype(np.uint64): UInt64,
    np.dtype(np.float16): Float32,
    np.dtype(np.float32): Float32,
    np.dtype(np.float64): Float64,
    np.dtype(np.bool_): Boolean,
}


def dtype_to_numpy(dtype: Any) -> np.dtype:
    """Physical numpy storage dtype for a logical dtype."""
    dtype = parse_into_dtype(dtype)
    name = type(dtype).__name__
    try:
        return np.dtype(_DTYPE_TO_NUMPY[name])
    except KeyError:
        from polars_tpu_torch.errors import InvalidOperationError

        raise InvalidOperationError(f"no physical storage mapping for dtype {dtype!r}") from None


def numpy_to_dtype(np_dtype: Any) -> DataType:
    np_dtype = np.dtype(np_dtype)
    try:
        return _NUMPY_TO_DTYPE[np_dtype]()
    except KeyError:
        if np_dtype.kind in ("U", "S", "O"):
            return String()
        if np_dtype.kind == "M":  # datetime64
            unit = np.datetime_data(np_dtype)[0]
            if unit == "D":
                return Date()
            return Datetime(unit if unit in ("ms", "us", "ns") else "us")
        if np_dtype.kind == "m":
            unit = np.datetime_data(np_dtype)[0]
            return Duration(unit if unit in ("ms", "us", "ns") else "us")
        from polars_tpu_torch.errors import InvalidOperationError

        raise InvalidOperationError(f"unsupported numpy dtype {np_dtype!r}") from None


_PY_TO_DTYPE = {
    int: Int64,
    float: Float64,
    bool: Boolean,
    str: String,
    _pydt.datetime: Datetime,
    _pydt.date: Date,
    _pydt.time: Time,
    _pydt.timedelta: Duration,
}


def parse_into_dtype(obj: Any) -> DataType:
    """Convert a user dtype spec into a DataType instance."""
    if isinstance(obj, DataType):
        return obj
    if isinstance(obj, DataTypeClass):
        return obj()
    if isinstance(obj, type) and obj in _PY_TO_DTYPE:
        return _PY_TO_DTYPE[obj]()
    if isinstance(obj, (np.dtype, str)) or (isinstance(obj, type) and issubclass(obj, np.generic)):
        if isinstance(obj, str):
            # Accept polars-style lowercase names
            lut = {
                "i8": Int8, "i16": Int16, "i32": Int32, "i64": Int64,
                "u8": UInt8, "u16": UInt16, "u32": UInt32, "u64": UInt64,
                "f32": Float32, "f64": Float64, "bool": Boolean, "str": String,
                "date": Date, "datetime": Datetime, "duration": Duration,
                "time": Time, "null": Null,
            }
            if obj in lut:
                return lut[obj]()
        return numpy_to_dtype(np.dtype(obj))
    if obj is None:
        return Null()
    from polars_tpu_torch.errors import InvalidOperationError

    raise InvalidOperationError(f"cannot parse {obj!r} into a polars_tpu dtype")


# Groups, mirroring py-polars datatypes.group
INTEGER_DTYPES = frozenset([Int8, Int16, Int32, Int64, Int128, UInt8, UInt16, UInt32, UInt64, UInt128])
SIGNED_INTEGER_DTYPES = frozenset([Int8, Int16, Int32, Int64, Int128])
UNSIGNED_INTEGER_DTYPES = frozenset([UInt8, UInt16, UInt32, UInt64])
FLOAT_DTYPES = frozenset([Float16, Float32, Float64])
NUMERIC_DTYPES = INTEGER_DTYPES | FLOAT_DTYPES
TEMPORAL_DTYPES = frozenset([Date, Datetime, Duration, Time])
NESTED_DTYPES = frozenset([List, Array, Struct])

__all__ = [
    "DataType", "DataTypeClass", "NumericType", "IntegerType", "SignedIntegerType",
    "UnsignedIntegerType", "FloatType", "TemporalType", "NestedType",
    "Int8", "Int16", "Int32", "Int64", "Int128", "UInt8", "UInt16", "UInt32", "UInt64", "UInt128", "Float16",
    "Float32", "Float64", "Decimal", "Boolean", "String", "Utf8", "Binary",
    "Categorical", "Enum", "Date", "Datetime", "Duration", "Time",
    "List", "Array", "Struct", "Field", "Null", "Object", "Unknown",
    "dtype_to_numpy", "dtype_to_torch", "numpy_to_dtype", "parse_into_dtype",
    "INTEGER_DTYPES", "SIGNED_INTEGER_DTYPES", "UNSIGNED_INTEGER_DTYPES",
    "FLOAT_DTYPES", "NUMERIC_DTYPES", "TEMPORAL_DTYPES", "NESTED_DTYPES",
]

# ---------------------------------------------------------------------------
# torch storage types
# ---------------------------------------------------------------------------

# PyTorch has no add, compare or scatter for uint16/32/64, so those widen to
# the next signed type (UInt64 keeps its bit pattern in int64). The schema
# keeps the logical dtype; only the tensor is wider.
_DTYPE_TO_TORCH_NAME = {
    "Int8": "int8", "Int16": "int16", "Int32": "int32", "Int64": "int64",
    "UInt8": "uint8", "UInt16": "int32", "UInt32": "int64", "UInt64": "int64",
    "Float16": "float32", "Float32": "float32", "Float64": "float64",
    "Boolean": "bool",
    "Date": "int32", "Datetime": "int64", "Duration": "int64", "Time": "int64",
    "String": "int32", "Categorical": "int32", "Enum": "int32", "Binary": "int32",
    "Decimal": "int64", "Null": "int32",
    # nested columns: a List's or Array's packed (start << 32) | length into
    # its flat child, a Struct's row ids into its fields (core/column.py)
    "List": "int64", "Array": "int64", "Struct": "int64",
}


def dtype_to_torch(dtype: Any):
    """Physical torch storage dtype for a logical dtype."""
    import torch

    dtype = parse_into_dtype(dtype)
    try:
        return getattr(torch, _DTYPE_TO_TORCH_NAME[type(dtype).__name__])
    except KeyError:
        from polars_tpu_torch.errors import InvalidOperationError

        raise InvalidOperationError(f"no physical storage mapping for dtype {dtype!r}") from None



class DataTypeExpr:
    """A dtype resolved against a schema when its expression enters a plan
    (``plan/schema_resolve.expand_expr``): ``lit`` a dtype, ``col`` the
    dtype of a named column, ``self`` that of the expression cast, ``struct``
    a Struct whose fields may be DataTypeExprs."""

    __slots__ = ("kind", "arg")

    def __init__(self, kind: str, arg: Any = None) -> None:
        object.__setattr__(self, "kind", kind)
        object.__setattr__(self, "arg", arg)

    def __setattr__(self, *a: Any) -> None:
        raise AttributeError("DataTypeExpr is immutable")

    def __hash__(self) -> int:
        return hash(("DataTypeExpr", self.kind, self.arg))

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, DataTypeExpr) and (self.kind, self.arg) == (other.kind, other.arg)

    def __repr__(self) -> str:
        return f"DataTypeExpr({self.kind}, {self.arg!r})"

    def resolve(self, schema: Any = None, self_dtype: DataType | None = None) -> DataType:
        if self.kind == "lit":
            return self.arg
        if self.kind == "col":
            if schema is None or self.arg not in schema:
                from polars_tpu_torch.errors import SchemaError

                raise SchemaError(f"dtype_of: column {self.arg!r} is not in the schema")
            return schema[self.arg]
        if self.kind == "self":
            if self_dtype is None:
                from polars_tpu_torch.errors import InvalidOperationError

                raise InvalidOperationError("self_dtype() outside a cast")
            return self_dtype
        return Struct([(n, d.resolve(schema, self_dtype) if isinstance(d, DataTypeExpr) else parse_into_dtype(d))
                       for n, d in self.arg])

    def collect_dtype(self, context: Any) -> DataType:
        """The dtype against a schema or a mapping of names to dtypes."""
        return self.resolve(context)


def _to_dtype_expr(self) -> DataTypeExpr:
    return DataTypeExpr("lit", self)


DataType.to_dtype_expr = _to_dtype_expr


def dtype_of(col: str) -> DataTypeExpr:
    """The dtype of the column ``col``, read when the plan is built."""
    return DataTypeExpr("col", col)


def self_dtype() -> DataTypeExpr:
    """The dtype of the expression being cast."""
    return DataTypeExpr("self")


def struct_with_fields(mapping: Any) -> DataTypeExpr:
    """A Struct dtype whose fields' dtypes may be DataTypeExprs."""
    return DataTypeExpr("struct", tuple(dict(mapping).items()))


class Categories:
    """A named set of categories for a Categorical. Each String column here
    has its own dictionary and dictionaries merge where columns meet, so a
    Categories is a handle: equal name, namespace and physical type compare
    equal."""

    __slots__ = ("name", "namespace", "physical")

    def __init__(self, name: str | None = None, namespace: str = "", physical: Any = None) -> None:
        if not name and namespace:
            raise ValueError("global Categories cannot have a namespace")
        self.name = name or ""
        self.namespace = namespace
        self.physical = physical if physical is not None else UInt32()

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, Categories) and (self.name, self.namespace, type(self.physical).__name__) == (
            other.name, other.namespace, type(other.physical).__name__)

    def __hash__(self) -> int:
        return hash(("Categories", self.name, self.namespace, type(self.physical).__name__))

    def __repr__(self) -> str:
        return f"Categories(name={self.name!r}, namespace={self.namespace!r})"

    @classmethod
    def random(cls, namespace: str = "") -> Categories:
        import uuid

        return cls(uuid.uuid4().hex, namespace)

    def is_global(self) -> bool:
        return not self.name

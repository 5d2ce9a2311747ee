"""Ordered name->dtype schema (reference: polars-schema/src/schema.rs,
``Schema = IndexMap<PlSmallStr, DataType>``)."""

from __future__ import annotations

from collections.abc import Iterable, Mapping
from typing import Any

from polars_tpu_torch import datatypes as dt
from polars_tpu_torch.errors import ColumnNotFoundError, DuplicateError


class Schema:
    """Insertion-ordered mapping of column name -> DataType."""

    __slots__ = ("_fields",)

    def __init__(
        self,
        fields: Mapping[str, Any] | Iterable[tuple[str, Any]] | None = None,
    ) -> None:
        self._fields: dict[str, dt.DataType] = {}
        if fields is not None:
            items = fields.items() if isinstance(fields, Mapping) else fields
            for name, dtype in items:
                self._fields[name] = dt.parse_into_dtype(dtype)

    # -- mapping protocol ----------------------------------------------------

    def __getitem__(self, name: str) -> dt.DataType:
        try:
            return self._fields[name]
        except KeyError:
            raise ColumnNotFoundError(
                f"{name!r} not found; available: {list(self._fields)}"
            ) from None

    def __setitem__(self, name: str, dtype: Any) -> None:
        self._fields[name] = dt.parse_into_dtype(dtype)

    def __contains__(self, name: str) -> bool:
        return name in self._fields

    def __iter__(self):
        return iter(self._fields)

    def __len__(self) -> int:
        return len(self._fields)

    def __eq__(self, other: object) -> bool:
        if isinstance(other, Schema):
            return list(self._fields.items()) == list(other._fields.items())
        if isinstance(other, Mapping):
            return self._fields == {
                k: dt.parse_into_dtype(v) for k, v in other.items()
            } and list(self._fields) == list(other)
        return NotImplemented

    def __repr__(self) -> str:
        inner = ", ".join(f"{n!r}: {d!r}" for n, d in self._fields.items())
        return f"Schema({{{inner}}})"

    # -- accessors ------------------------------------------------------------

    def names(self) -> list[str]:
        return list(self._fields)

    def dtypes(self) -> list[dt.DataType]:
        return list(self._fields.values())

    def items(self):
        return self._fields.items()

    def keys(self):
        return self._fields.keys()

    def values(self):
        return self._fields.values()

    def get(self, name: str, default: Any = None) -> dt.DataType | None:
        return self._fields.get(name, default)

    def index_of(self, name: str) -> int:
        try:
            return list(self._fields).index(name)
        except ValueError:
            raise ColumnNotFoundError(f"{name!r} not found") from None

    def len(self) -> int:
        return len(self._fields)

    def copy(self) -> Schema:
        out = Schema()
        out._fields = dict(self._fields)
        return out

    def insert(self, name: str, dtype: Any) -> None:
        if name in self._fields:
            raise DuplicateError(f"column {name!r} already in schema")
        self._fields[name] = dt.parse_into_dtype(dtype)

    def with_column(self, name: str, dtype: Any) -> Schema:
        out = self.copy()
        out._fields[name] = dt.parse_into_dtype(dtype)
        return out

    def to_python(self) -> dict[str, type]:
        """Schema as python types (parity with py-polars Schema.to_python)."""
        lut = {
            "Int8": int, "Int16": int, "Int32": int, "Int64": int,
            "UInt8": int, "UInt16": int, "UInt32": int, "UInt64": int,
            "Float32": float, "Float64": float, "Boolean": bool, "String": str,
        }
        import datetime

        lut.update({
            "Date": datetime.date, "Datetime": datetime.datetime,
            "Duration": datetime.timedelta, "Time": datetime.time,
        })
        return {
            n: lut.get(type(d).__name__, object) for n, d in self._fields.items()
        }

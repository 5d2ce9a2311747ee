"""Exception hierarchy for polars_tpu_torch (a copy of polars_tpu/errors.py).

Mirrors the reference's error taxonomy (polars-error/src/lib.rs:83-113, a
15-variant enum) as Python exception classes, matching the names py-polars
exposes (py-polars/src/polars/exceptions.py).
"""

from __future__ import annotations


class PolarsError(Exception):
    """Base class for all polars_tpu_torch errors."""


class ColumnNotFoundError(PolarsError):
    """A specified column was not found."""


class ComputeError(PolarsError):
    """The engine could not finish a computation."""


class DuplicateError(PolarsError):
    """A column name occurs more than once."""


class InvalidOperationError(PolarsError):
    """The operation is not allowed on the given dtype or object."""


class NoDataError(PolarsError):
    """An operation could not be performed because no data was present."""


class OutOfBoundsError(PolarsError):
    """An index was out of bounds."""


class SchemaError(PolarsError):
    """An unexpected schema mismatch."""


class SchemaFieldNotFoundError(PolarsError):
    """A field was not found in a schema."""


class ShapeError(PolarsError):
    """Data has an unexpected shape."""


class SQLInterfaceError(PolarsError):
    """An error in the SQL interface."""


class SQLSyntaxError(SQLInterfaceError):
    """Invalid SQL syntax."""


class StringCacheMismatchError(PolarsError):
    """Categorical string caches do not match."""


class QueryCancelledError(PolarsError):
    """The query was cancelled (cancel token / timeout) at a plan barrier."""


class PerformanceWarning(Warning):
    """Emitted when an operation falls off the fast compiled path."""


class MapWithoutReturnDtypeWarning(Warning):
    """map_elements called without return_dtype."""

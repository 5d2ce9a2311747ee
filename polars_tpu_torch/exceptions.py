"""Exception namespace alias (reference: py-polars pl.exceptions)."""

from polars_tpu_torch.errors import (  # noqa: F401
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

# polars name aliases
PolarsDataTypeError = SchemaError

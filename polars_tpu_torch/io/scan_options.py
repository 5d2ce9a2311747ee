"""Scan cast/schema-mismatch policy (the port of
``polars_tpu/io/scan_options.py``; reference:
io/scan_options/cast_options.py).

Accepted by the scans as ``cast_options=``; the port, like the JAX package,
records it and reads every file with the schema of its own data."""

from __future__ import annotations

from typing import Any


class ScanCastOptions:
    def __init__(
        self,
        *,
        integer_cast: Any = "forbid",
        float_cast: Any = "forbid",
        datetime_cast: Any = "forbid",
        missing_struct_fields: str = "raise",
        extra_struct_fields: str = "raise",
        categorical_to_string: str = "forbid",
        _internal_call: bool = False,
    ) -> None:
        self.integer_cast = integer_cast
        self.float_cast = float_cast
        self.datetime_cast = datetime_cast
        self.missing_struct_fields = missing_struct_fields
        self.extra_struct_fields = extra_struct_fields
        self.categorical_to_string = categorical_to_string

    @classmethod
    def _default(cls) -> ScanCastOptions:
        return cls(_internal_call=True)

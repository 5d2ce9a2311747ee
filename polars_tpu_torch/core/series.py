"""Series: one named column with a read-only surface (the port of
``polars_tpu/core/series.py``, trimmed to conversion and inspection)."""

from __future__ import annotations

from typing import Any

import numpy as np

from polars_tpu_torch import datatypes as dt
from polars_tpu_torch.core.column import Column


class Series:
    __slots__ = ("_column",)

    def __init__(self, name: str = "", values: Any = None, dtype: Any = None, *, device=None) -> None:
        from polars_tpu_torch.config import resolve_device

        self._column = Column.from_values(
            name, [] if values is None else values, dtype, device=resolve_device(device)
        )

    @classmethod
    def _from_column(cls, column: Column) -> Series:
        s = cls.__new__(cls)
        s._column = column
        return s

    @property
    def name(self) -> str:
        return self._column.name

    @property
    def dtype(self) -> dt.DataType:
        return self._column.dtype

    @property
    def device(self):
        return self._column.buffer.device

    def __len__(self) -> int:
        return len(self._column)

    def len(self) -> int:
        return len(self._column)

    def to_list(self) -> list:
        return self._column.to_pylist()

    def to_numpy(self) -> np.ndarray:
        return self._column.to_numpy()

    def __repr__(self) -> str:
        return f"Series(name={self.name!r}, dtype={self.dtype!r}, len={len(self)})"

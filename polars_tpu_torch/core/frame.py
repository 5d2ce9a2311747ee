"""Eager DataFrame (the port of ``polars_tpu/core/frame.py``, trimmed).

A height-aligned list of columns on one device. Query operations go through
the lazy engine (``df.lazy()...collect()``), as in the JAX package;
``gather`` and ``drop`` work on the columns.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import TYPE_CHECKING, Any

from polars_tpu_torch import datatypes as dt
from polars_tpu_torch.core.column import Column
from polars_tpu_torch.core.schema import Schema
from polars_tpu_torch.errors import ColumnNotFoundError, DuplicateError, ShapeError

if TYPE_CHECKING:
    from polars_tpu_torch.core.series import Series
    from polars_tpu_torch.lazyframe import LazyFrame


class DataFrame:
    """A height-aligned collection of typed device columns."""

    __slots__ = ("_columns", "_height", "_device")

    def __init__(self, data: Mapping[str, Any] | None = None, *, device=None) -> None:
        """Build a frame from a mapping of column name -> numpy array or list,
        on ``device`` (default: the package default, ``cuda``)."""
        from polars_tpu_torch.config import resolve_device

        self._device = resolve_device(device)
        self._columns: list[Column] = []
        self._height = 0
        if data is None:
            return
        if not isinstance(data, Mapping):
            raise NotImplementedError("DataFrame input other than a mapping of columns is not ported yet")
        cols = [Column.from_values(str(k), v, device=self._device) for k, v in data.items()]
        heights = {len(c) for c in cols}
        if len(heights) > 1:
            raise ShapeError(f"could not create DataFrame: columns have differing lengths {sorted(heights)}")
        self._columns = cols
        self._height = len(cols[0]) if cols else 0

    @classmethod
    def _from_columns(cls, columns: list[Column], height: int | None = None, device=None) -> DataFrame:
        df = cls.__new__(cls)
        names = [c.name for c in columns]
        if len(set(names)) != len(names):
            raise DuplicateError(f"duplicate column names in {names}")
        df._columns = columns
        df._height = height if height is not None else (len(columns[0]) if columns else 0)
        if columns:
            df._device = columns[0].buffer.device
        else:
            from polars_tpu_torch.config import resolve_device

            df._device = resolve_device(device)
        return df

    def _get(self, name: str) -> Column:
        for c in self._columns:
            if c.name == name:
                return c
        raise ColumnNotFoundError(f"{name!r} not found; available: {self.columns}")

    @property
    def height(self) -> int:
        return self._height

    @property
    def width(self) -> int:
        return len(self._columns)

    @property
    def shape(self) -> tuple[int, int]:
        return (self._height, len(self._columns))

    @property
    def columns(self) -> list[str]:
        return [c.name for c in self._columns]

    @property
    def dtypes(self) -> list[dt.DataType]:
        return [c.dtype for c in self._columns]

    @property
    def schema(self) -> Schema:
        return Schema([(c.name, c.dtype) for c in self._columns])

    @property
    def device(self):
        return self._device

    def __len__(self) -> int:
        return self._height

    def get_column(self, name: str) -> Series:
        from polars_tpu_torch.core.series import Series

        return Series._from_column(self._get(name))

    def __getitem__(self, key: str) -> Series:
        if not isinstance(key, str):
            raise NotImplementedError("DataFrame indexing other than by column name is not ported yet")
        return self.get_column(key)

    def to_dict(self, *, as_series: bool = True) -> dict:
        if as_series:
            from polars_tpu_torch.core.series import Series

            return {c.name: Series._from_column(c) for c in self._columns}
        return {c.name: c.to_pylist() for c in self._columns}

    def gather(self, indices: Any) -> DataFrame:
        """The rows at ``indices`` (a sequence or a tensor; negative indices
        count from the end, ``None`` gives a null row)."""
        from polars_tpu_torch.engine.gather import gather_frame

        cols = gather_frame(self._columns, indices)
        height = len(cols[0]) if cols else len(indices)
        return DataFrame._from_columns(cols, height, device=self._device)

    def drop(self, *columns: str, strict: bool = True) -> DataFrame:
        names = {n for c in columns for n in ([c] if isinstance(c, str) else c)}
        if strict and names - set(self.columns):
            raise ColumnNotFoundError(f"{sorted(names - set(self.columns))} not found")
        return DataFrame._from_columns([c for c in self._columns if c.name not in names], self._height,
                                       device=self._device)

    def lazy(self) -> LazyFrame:
        from polars_tpu_torch.lazyframe import LazyFrame

        return LazyFrame._from_df(self)

    def group_by(self, *by: Any, maintain_order: bool = False):
        from polars_tpu_torch.groupby import GroupBy

        return GroupBy(self, by, maintain_order=maintain_order)

    def __repr__(self) -> str:
        cols = ", ".join(f"{c.name}: {c.dtype!r}" for c in self._columns)
        return f"DataFrame(shape={self.shape}, device={self._device}, {{{cols}}})"

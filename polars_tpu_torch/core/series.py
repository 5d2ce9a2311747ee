"""Series: one named column with an eager method surface (the port of
``polars_tpu/core/series.py``, trimmed).

As in the JAX package, nearly every operation runs through the expression
engine over a one-column frame (``_select``, ``_scalar``), so that Series,
DataFrame and LazyFrame cannot drift apart: the operators, ``cast``, the
math and null functions, and the aggregations, which return Python values.
An ``Expr`` method the Series lacks runs the same way (``__getattr__``):
one that aggregates returns its value, any other a Series.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from polars_tpu_torch import datatypes as dt
from polars_tpu_torch.core.column import Column
from polars_tpu_torch.core.frame import DataFrame


class Series:
    __slots__ = ("_column",)

    def __init__(self, name: Any = "", values: Any = None, dtype: Any = None, *, strict: bool = True,
                 device=None) -> None:
        from polars_tpu_torch.config import resolve_device

        if name is not None and not isinstance(name, str) and values is None:
            values, name = name, ""
        self._column = Column.from_values(name or "", [] if values is None else values, dtype,
                                          device=resolve_device(device), strict=strict)

    @classmethod
    def _from_column(cls, column: Column) -> Series:
        s = cls.__new__(cls)
        s._column = column
        return s

    # -- properties -----------------------------------------------------------

    @property
    def name(self) -> str:
        return self._column.name

    @property
    def dtype(self) -> dt.DataType:
        return self._column.dtype

    @property
    def device(self):
        return self._column.buffer.device

    @property
    def shape(self) -> tuple[int]:
        return (len(self._column),)

    def __len__(self) -> int:
        return len(self._column)

    def len(self) -> int:
        return len(self._column)

    def is_empty(self) -> bool:
        return len(self._column) == 0

    def alias(self, name: str) -> Series:
        return Series._from_column(self._column.rename(name))

    def rename(self, name: str) -> Series:
        return self.alias(name)

    def clone(self) -> Series:
        return Series._from_column(self._column)

    def null_count(self) -> int:
        return self._column.null_count()

    def has_nulls(self) -> bool:
        return self.null_count() > 0

    # -- the engine over a one-column frame -----------------------------------

    def _frame(self, *others: Series) -> DataFrame:
        cols = [self._column, *(o._column.rename(f"__other_{i}") for i, o in enumerate(others))]
        return DataFrame._from_columns(cols, len(self._column))

    def _expr(self):
        from polars_tpu_torch.functions.lazy import col

        return col(self.name)

    def _select(self, expr, *others: Series) -> Series:
        out = self._frame(*others).select(expr)
        return Series._from_column(out._columns[0].rename(self.name))

    def _scalar(self, expr) -> Any:
        return self._frame().select(expr).item()

    def _binary(self, method: str, other: Any, *, swap: bool = False) -> Series:
        """``self <op> other`` (or ``other <op> self``): a Series of the same
        length is a second column, one of length one a literal."""
        from polars_tpu_torch.functions.lazy import col, lit

        others: tuple = ()
        if isinstance(other, Series):
            if len(other) == len(self) and len(self) != 1:
                rhs, others = col("__other_0"), (other,)
            elif len(other) == 1:
                rhs = lit(other.to_list()[0], dtype=other.dtype)
            else:
                from polars_tpu_torch.errors import ShapeError

                raise ShapeError(f"cannot combine Series of lengths {len(self)} and {len(other)}")
        else:
            rhs = lit(other)
        lhs = self._expr()
        if swap:
            lhs, rhs = rhs, lhs
        return self._select(getattr(lhs, method)(rhs).alias(self.name), *others)

    # -- operators ------------------------------------------------------------

    def __add__(self, other: Any) -> Series:
        return self._binary("__add__", other)

    def __radd__(self, other: Any) -> Series:
        return self._binary("__add__", other, swap=True)

    def __sub__(self, other: Any) -> Series:
        return self._binary("__sub__", other)

    def __rsub__(self, other: Any) -> Series:
        return self._binary("__sub__", other, swap=True)

    def __mul__(self, other: Any) -> Series:
        return self._binary("__mul__", other)

    def __rmul__(self, other: Any) -> Series:
        return self._binary("__mul__", other, swap=True)

    def __truediv__(self, other: Any) -> Series:
        return self._binary("__truediv__", other)

    def __rtruediv__(self, other: Any) -> Series:
        return self._binary("__truediv__", other, swap=True)

    def __floordiv__(self, other: Any) -> Series:
        return self._binary("__floordiv__", other)

    def __rfloordiv__(self, other: Any) -> Series:
        return self._binary("__floordiv__", other, swap=True)

    def __mod__(self, other: Any) -> Series:
        return self._binary("__mod__", other)

    def __rmod__(self, other: Any) -> Series:
        return self._binary("__mod__", other, swap=True)

    def __pow__(self, other: Any) -> Series:
        return self._binary("__pow__", other)

    def __rpow__(self, other: Any) -> Series:
        return self._binary("__pow__", other, swap=True)

    def __eq__(self, other: Any) -> Series:  # type: ignore[override]
        return self._binary("__eq__", other)

    def __ne__(self, other: Any) -> Series:  # type: ignore[override]
        return self._binary("__ne__", other)

    def __lt__(self, other: Any) -> Series:
        return self._binary("__lt__", other)

    def __le__(self, other: Any) -> Series:
        return self._binary("__le__", other)

    def __gt__(self, other: Any) -> Series:
        return self._binary("__gt__", other)

    def __ge__(self, other: Any) -> Series:
        return self._binary("__ge__", other)

    def __and__(self, other: Any) -> Series:
        return self._binary("__and__", other)

    def __or__(self, other: Any) -> Series:
        return self._binary("__or__", other)

    def __xor__(self, other: Any) -> Series:
        return self._binary("__xor__", other)

    def __neg__(self) -> Series:
        return self._select(-self._expr())

    def __invert__(self) -> Series:
        return self._select(~self._expr())

    def __abs__(self) -> Series:
        return self._select(self._expr().abs())

    __hash__ = None

    # -- rows ------------------------------------------------------------------

    def __getitem__(self, key: Any) -> Any:
        """A value by position; a Series by slice, positions or a Boolean
        mask."""
        if isinstance(key, (int, np.integer)):
            k = int(key) + (len(self) if key < 0 else 0)
            if not 0 <= k < len(self):
                raise IndexError(f"index {key} is out of bounds for a Series of length {len(self)}")
            return self.gather([k]).to_list()[0]
        if isinstance(key, slice):
            start, stop, step = key.indices(len(self))
            if step == 1:
                return self.slice(start, max(stop - start, 0))
            return self.gather(np.arange(start, stop, step))
        if isinstance(key, Series):
            key = key.to_numpy()
        if isinstance(key, (list, np.ndarray)):
            arr = np.asarray(key)
            return self.filter(Series("", arr, device=self.device)) if arr.dtype == bool else self.gather(arr)
        raise TypeError(f"cannot index a Series with {key!r}")

    def __iter__(self):
        return iter(self.to_list())

    def __contains__(self, item: Any) -> bool:
        return item in self.to_list()

    def slice(self, offset: int, length: int | None = None) -> Series:
        return Series._from_column(self._frame().slice(offset, length)._columns[0])

    def head(self, n: int = 10) -> Series:
        return Series._from_column(self._frame().head(n)._columns[0])

    def tail(self, n: int = 10) -> Series:
        return Series._from_column(self._frame().tail(n)._columns[0])

    def limit(self, n: int = 10) -> Series:
        return self.head(n)

    def gather(self, indices: Any) -> Series:
        if isinstance(indices, Series):
            indices = indices.to_numpy()
        return Series._from_column(self._frame().gather(indices)._columns[0])

    def gather_every(self, n: int, offset: int = 0) -> Series:
        return Series._from_column(self._frame().gather_every(n, offset)._columns[0])

    def filter(self, predicate: Any) -> Series:
        if isinstance(predicate, Series):
            from polars_tpu_torch.functions.lazy import col

            out = self._frame(predicate).filter(col("__other_0"))
            return Series._from_column(out._columns[0])
        return Series._from_column(self._frame().filter(predicate)._columns[0])

    def drop_nulls(self) -> Series:
        return Series._from_column(self._frame().drop_nulls()._columns[0])

    def drop_nans(self) -> Series:
        return Series._from_column(self._frame().drop_nans()._columns[0])

    def reverse(self) -> Series:
        return Series._from_column(self._frame().reverse()._columns[0])

    def sort(self, *, descending: bool = False, nulls_last: bool = False) -> Series:
        return Series._from_column(self._frame().sort(self.name, descending=descending,
                                                      nulls_last=nulls_last)._columns[0])

    def unique(self, *, maintain_order: bool = False) -> Series:
        return Series._from_column(self._frame().unique(maintain_order=maintain_order)._columns[0])

    def value_counts(self, *, sort: bool = False, name: str | None = None, normalize: bool = False) -> DataFrame:
        """Each distinct value with its count (or share, ``normalize``)."""
        from polars_tpu_torch.functions.lazy import len as pl_len

        name = name or ("proportion" if normalize else "count")
        agg = (pl_len().cast(dt.Float64()) / len(self)) if normalize else pl_len()
        out = self._frame().group_by(self.name).agg(agg.alias(name))
        return out.sort(name, descending=True) if sort else out

    def to_torch(self):
        """The values' tensor on the Series' device, without a copy (a
        Boolean, integer, float or temporal column without nulls; a
        Datetime gives its ticks, a Date its days)."""
        col = self._column
        if col.buffer.validity is not None or col.table is not None or col.child is not None:
            from polars_tpu_torch.errors import InvalidOperationError

            raise InvalidOperationError(f"to_torch of {col.dtype!r} with nulls, a dictionary or a nested layout; "
                                        "cast or fill it first")
        return col.buffer.values

    def mode(self) -> Series:
        """The most frequent values (every one of a tie, in value order)."""
        return self._select(self._expr().mode())

    def append(self, other: Series) -> Series:
        from polars_tpu_torch.functions.eager import concat

        self._column = concat([self, other])._column.rename(self.name)
        return self

    def extend(self, other: Series) -> Series:
        return self.append(other)

    # -- the API tail -------------------------------------------------------------

    def scatter(self, indices: Any, values: Any) -> Series:
        """The values at ``indices`` set to ``values``, in place."""
        import torch

        from polars_tpu_torch.core.buffer import Buffer
        from polars_tpu_torch.engine.gather import _device_index

        idx, _ = _device_index(indices.to_list() if isinstance(indices, Series) else indices, len(self),
                               self.device)
        vals = values if isinstance(values, Series) else Series("", values if isinstance(values, (list, tuple))
                                                                 else [values] * idx.shape[0], device=self.device)
        vals = vals.cast(self.dtype) if vals.dtype != self.dtype else vals
        if vals._column.table is not self._column.table or self._column.child is not None:
            from polars_tpu_torch.functions.eager import concat

            merged = concat([self, vals])._column  # one dictionary for both
            own, new = merged.buffer.values[:len(self)], merged.buffer.values[len(self):]
            valid = None if merged.buffer.validity is None else merged.buffer.validity
            base = self._column.with_buffer(Buffer(own.clone(), None if valid is None else valid[:len(self)].clone()))
            base.table = merged.table
            nv = None if valid is None else valid[len(self):]
        else:
            base = self._column.with_buffer(Buffer(self._column.buffer.values.clone(), None if
                                                   self._column.buffer.validity is None else
                                                   self._column.buffer.validity.clone()))
            new, nv = vals._column.buffer.values, vals._column.buffer.validity
        base.buffer.values.index_put_((idx,), new.to(base.buffer.values.dtype))
        if nv is not None or base.buffer.validity is not None:
            validity = base.buffer.validity if base.buffer.validity is not None else torch.ones(
                len(self), dtype=torch.bool, device=self.device)
            validity.index_put_((idx,), nv if nv is not None else torch.ones_like(idx, dtype=torch.bool))
            base = base.with_buffer(Buffer(base.buffer.values, validity))
        self._column = base
        return self

    def set(self, filter: Series, value: Any) -> Series:  # noqa: A002
        """The values where ``filter`` is true set to ``value``."""
        from polars_tpu_torch.functions.lazy import col, lit, when

        return self._select(when(col("__other_0")).then(lit(value)).otherwise(self._expr()), filter)

    def zip_with(self, mask: Series, other: Series) -> Series:
        """These values where ``mask`` is true, ``other``'s elsewhere."""
        from polars_tpu_torch.functions.lazy import col, when

        return self._select(when(col("__other_0")).then(self._expr()).otherwise(col("__other_1")), mask, other)

    @property
    def flags(self) -> dict:
        """No sortedness flag is kept: both are False."""
        return {"SORTED_ASC": False, "SORTED_DESC": False}

    def describe(self, percentiles: Any = (0.25, 0.5, 0.75), *, interpolation: str = "nearest") -> DataFrame:
        """The frame's ``describe`` of this column: ``statistic`` and
        ``value``."""
        out = self.to_frame().describe()
        return out.rename({self.name: "value"})

    def to_dummies(self, *, separator: str = "_", drop_first: bool = False) -> DataFrame:
        return self.to_frame().to_dummies(separator=separator, drop_first=drop_first)

    def shrink_to_fit(self, *, in_place: bool = False) -> Series:
        return self

    def n_chunks(self) -> int:
        return 1

    def chunk_lengths(self) -> list[int]:
        return [len(self)]

    def get_chunks(self) -> list[Series]:
        return [self]

    def rechunk(self, *, in_place: bool = False) -> Series:
        return self

    def clear(self, n: int = 0) -> Series:
        """An empty Series of the same dtype (``n`` nulls)."""
        return Series._from_column(DataFrame._empty(self._frame().schema, n, self.device)._columns[0])

    def has_validity(self) -> bool:
        return self._column.buffer.validity is not None

    def estimated_size(self, unit: str = "b") -> float:
        """The bytes of the values and the validity (and the dictionary)."""
        buf = self._column.buffer
        size = buf.values.element_size() * buf.values.numel()
        if buf.validity is not None:
            size += buf.validity.numel()
        if self._column.table is not None:
            size += sum(len(str(v)) for v in self._column.table.values)
        scale = {"b": 1, "kb": 1024, "mb": 1024**2, "gb": 1024**3, "tb": 1024**4}[unit]
        return size / scale if unit != "b" else size

    def new_from_index(self, index: int, length: int) -> Series:
        """The value at ``index`` repeated ``length`` times."""
        from polars_tpu_torch.engine.gather import gather_column

        return Series._from_column(gather_column(self._column, [index] * length))

    def to_init_repr(self, n: int = 1000) -> str:
        return f"pl.Series({self.name!r}, {self.to_list()[:n]!r}, dtype=pl.{self.dtype!r})"

    # -- conversion -------------------------------------------------------------

    def to_list(self) -> list:
        return self._column.to_pylist()

    def to_numpy(self) -> np.ndarray:
        return self._column.to_numpy()

    def to_frame(self, name: str | None = None) -> DataFrame:
        col = self._column if name is None else self._column.rename(name)
        return DataFrame._from_columns([col], len(col))

    def to_arrow(self) -> Any:
        from polars_tpu_torch.io._arrow import column_to_arrow

        return column_to_arrow(self._column)

    def to_pandas(self) -> Any:
        import pandas as pd

        return pd.Series(self.to_numpy(), name=self.name)

    def item(self, index: int | None = None) -> Any:
        if index is None:
            if len(self) != 1:
                raise ValueError(f"can only call .item() on a Series of length 1, got {len(self)}")
            index = 0
        return self[index]

    def equals(self, other: Series, *, check_names: bool = False, null_equal: bool = True) -> bool:
        """Same length, dtype and values (NaN equals NaN; null equals null
        with ``null_equal``), and name with ``check_names``."""
        if len(self) != len(other) or self.dtype != other.dtype or (check_names and self.name != other.name):
            return False
        return values_equal(self.to_list(), other.to_list(), null_equal)

    def __repr__(self) -> str:
        from polars_tpu_torch.utils.fmt import format_series

        return format_series(self)

    # -- namespaces --------------------------------------------------------------

    @property
    def str(self):
        from polars_tpu_torch.core.series_ns import SeriesStringNamespace

        return SeriesStringNamespace(self)

    @property
    def dt(self):
        from polars_tpu_torch.core.series_ns import SeriesDateTimeNamespace

        return SeriesDateTimeNamespace(self)

    @property
    def cat(self):
        from polars_tpu_torch.core.series_ns import SeriesCatNamespace

        return SeriesCatNamespace(self)

    @property
    def bin(self):
        from polars_tpu_torch.core.series_ns import SeriesBinaryNamespace

        return SeriesBinaryNamespace(self)

    @property
    def list(self):
        from polars_tpu_torch.core.series_ns import SeriesListNamespace

        return SeriesListNamespace(self)

    @property
    def arr(self):
        from polars_tpu_torch.core.series_ns import SeriesArrayNamespace

        return SeriesArrayNamespace(self)

    @property
    def struct(self):
        from polars_tpu_torch.core.series_ns import SeriesStructNamespace

        return SeriesStructNamespace(self)

    def search_sorted(self, element: Any, side: str = "any") -> Any:
        """Where ``element`` would go in this sorted Series: an int for one
        value, a Series for a list or Series of them."""
        if isinstance(element, (list, tuple, np.ndarray, Series)):
            values = element.to_list() if isinstance(element, Series) else list(element)
            return Series(self.name, [self.search_sorted(v, side) for v in values], dt.UInt32(),
                          device=self._column.buffer.device)
        return self._scalar(self._expr().search_sorted(element, side))

    def __getattr__(self, name: str):
        """An ``Expr`` method run over the Series: an aggregation returns its
        value, anything else a Series."""
        from polars_tpu_torch.expr.expr import Expr
        from polars_tpu_torch.plan import exprs as E

        if name.startswith("_") or not callable(getattr(Expr, name, None)):
            raise AttributeError(f"'Series' object has no attribute {name!r}")

        def method(*args: Any, **kwargs: Any) -> Any:
            e = getattr(self._expr(), name)(*args, **kwargs)
            if E.reduces_in_agg(e._node):  # an aggregation, or a value made of them (nan_max, index_of)
                return self._scalar(e)
            return self._select(e)

        method.__name__ = name
        return method


def values_equal(left: list, right: list, null_equal: bool) -> bool:
    """Two value lists equal element by element: NaN equals NaN, and null
    equals null with ``null_equal``."""
    for x, y in zip(left, right):
        if x is None or y is None:
            if not (null_equal and x is None and y is None):
                return False
        elif isinstance(x, float) and isinstance(y, float):
            if x != y and not (x != x and y != y):
                return False
        elif x != y:
            return False
    return len(left) == len(right)

"""Eager DataFrame (the port of ``polars_tpu/core/frame.py``, trimmed).

A height-aligned list of columns on one device. Every query method builds a
lazy plan over the frame and collects it (``df.lazy()...collect()``), as the
JAX package does for its query methods, so that the eager and the lazy API
cannot drift apart: ``select``, ``with_columns``, ``filter``, ``sort``,
``group_by``, ``join`` and the asof and range joins, ``unique``, ``head``,
``tail``, ``slice``, ``reverse``, ``rename``, ``with_row_index``, the null
and NaN functions, ``cast``, ``top_k``/``bottom_k``, ``gather_every`` and
the frame aggregates. ``gather``, ``drop``, ``hstack`` and ``vstack`` work
on the columns; the row accessors read the frame to the host.
"""

from __future__ import annotations

from collections.abc import Iterable, Mapping, Sequence
from typing import TYPE_CHECKING, Any

import numpy as np

from polars_tpu_torch import datatypes as dt
from polars_tpu_torch.core.column import Column
from polars_tpu_torch.core.schema import Schema
from polars_tpu_torch.errors import ColumnNotFoundError, DuplicateError, InvalidOperationError, ShapeError

if TYPE_CHECKING:
    from polars_tpu_torch.core.series import Series
    from polars_tpu_torch.lazyframe import LazyFrame


class DataFrame:
    """A height-aligned collection of typed device columns."""

    __slots__ = ("_columns", "_height", "_device", "_sorted")

    def __init__(
        self,
        data: Any = None,
        schema: Any = None,
        *,
        schema_overrides: Mapping[str, Any] | None = None,
        strict: bool = True,
        orient: str | None = None,
        device=None,
    ) -> None:
        """Build a frame on ``device`` (default: the package default,
        ``cuda``) from a mapping of name to values (a list, a numpy array or
        a Series), a sequence of Series, of rows (tuples or lists) or of
        dicts, or a 2-D numpy array. ``schema`` names the columns, and
        gives their dtypes where it maps names to them;
        ``schema_overrides`` gives dtypes too. A column of one value is
        broadcast to the frame's height. Without data, ``schema`` makes an
        empty frame."""
        from polars_tpu_torch.config import resolve_device

        self._device = resolve_device(device)
        self._columns: list[Column] = []
        self._height = 0
        self._sorted: dict[str, str] = {}
        if data is None:
            self._columns = [Column.from_values(n, [], d, device=self._device) for n, d in _schema_items(schema)]
            return
        cols = _build_columns(data, schema, schema_overrides, strict, orient, self._device)
        heights = {len(c) for c in cols}
        if len(heights) > 1:
            top = max(heights)
            if not heights <= {1, top}:
                raise ShapeError(f"could not create DataFrame: columns have differing lengths {sorted(heights)}")
            cols = [c if len(c) == top else _repeat(c, top) for c in cols]
        names = [c.name for c in cols]
        if len(set(names)) != len(names):
            raise DuplicateError(f"duplicate column names in {names}")
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
        df._sorted = {}
        if columns:
            df._device = columns[0].buffer.device
        else:
            from polars_tpu_torch.config import resolve_device

            df._device = resolve_device(device)
        return df

    @classmethod
    def _empty(cls, schema: Schema, n: int, device) -> DataFrame:
        """``n`` rows of nulls of ``schema``."""
        return cls({name: [None] * n for name in schema.names()} if n else None, schema, device=device)

    def _get(self, name: str) -> Column:
        for c in self._columns:
            if c.name == name:
                return c
        raise ColumnNotFoundError(f"{name!r} not found; available: {self.columns}")

    # -- properties -----------------------------------------------------------

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

    def collect_schema(self) -> Schema:
        return self.schema

    @property
    def device(self):
        return self._device

    def __len__(self) -> int:
        return self._height

    def is_empty(self) -> bool:
        return self._height == 0

    def __contains__(self, name: str) -> bool:
        return name in self.columns

    def __iter__(self):
        return iter(self.get_columns())

    # -- column access --------------------------------------------------------

    def get_column(self, name: str) -> Series:
        from polars_tpu_torch.core.series import Series

        return Series._from_column(self._get(name))

    def get_columns(self) -> list[Series]:
        from polars_tpu_torch.core.series import Series

        return [Series._from_column(c) for c in self._columns]

    def get_column_index(self, name: str) -> int:
        return self.schema.index_of(name)

    def to_series(self, index: int = 0) -> Series:
        from polars_tpu_torch.core.series import Series

        return Series._from_column(self._columns[index])

    def __getitem__(self, key: Any) -> Any:
        """A column by name; rows by position, slice, positions or a Boolean
        Series; columns by a list of names; or a (rows, columns) pair."""
        from polars_tpu_torch.core.series import Series

        if isinstance(key, str):
            return self.get_column(key)
        if isinstance(key, (int, np.integer)):
            k = int(key)
            return self.slice(k if k >= 0 else self._height + k, 1)
        if isinstance(key, slice):
            start, stop, step = key.indices(self._height)
            if step == 1:
                return self.slice(start, max(stop - start, 0))
            return self.gather(np.arange(start, stop, step))
        if isinstance(key, Series):
            if isinstance(key.dtype, dt.Boolean):
                return self.filter(key)
            return self.gather(key.to_numpy())
        if isinstance(key, (list, np.ndarray)):
            items = key.tolist() if isinstance(key, np.ndarray) else list(key)
            if items and all(isinstance(k, str) for k in items):
                return self.select(items)
            if items and all(isinstance(k, (bool, np.bool_)) for k in items):
                return self.filter(Series("", items, device=self._device))
            return self.gather(np.asarray(items, dtype=np.int64))
        if isinstance(key, tuple) and len(key) == 2:
            rows, cols = key
            if isinstance(cols, (int, np.integer)):
                return Series._from_column(self._columns[int(cols)])[rows]
            return self[cols][rows]
        raise TypeError(f"cannot index DataFrame with {key!r}")

    # -- the lazy bridge ------------------------------------------------------

    def lazy(self) -> LazyFrame:
        from polars_tpu_torch.lazyframe import LazyFrame

        return LazyFrame._from_df(self)

    def _with_series(self, values: Iterable[Any]) -> tuple[DataFrame, list[Any]]:
        """The frame with each Series among ``values`` added as a hidden
        column, and ``values`` with those Series replaced by references to
        their columns (a Series of one value stays a literal)."""
        from polars_tpu_torch.core.series import Series

        extra, out = [], []
        for v in values:
            if isinstance(v, Series) and len(v) != 1:
                if len(v) != self._height:
                    raise ShapeError(f"unable to add a column of length {len(v)} to a DataFrame of height "
                                     f"{self._height}")
                name = f"__series_{len(extra)}"
                extra.append(v._column.rename(name))
                from polars_tpu_torch.expr.expr import Expr
                from polars_tpu_torch.plan import exprs as E

                out.append(Expr(E.EAlias(E.EColumn(name), v.name)))
            elif isinstance(v, Series):
                from polars_tpu_torch.functions.lazy import lit

                out.append(lit(v.to_list()[0], dtype=v.dtype).alias(v.name))
            else:
                out.append(v)
        if not extra:
            return self, out
        return DataFrame._from_columns(self._columns + extra, self._height, device=self._device), out

    # -- query methods: a plan and a collect ------------------------------------

    def select(self, *exprs: Any, **named_exprs: Any) -> DataFrame:
        items = [x for e in exprs for x in (e if isinstance(e, (list, tuple)) else [e])]
        df, items = self._with_series(items)
        names = list(named_exprs)
        df, named = df._with_series(named_exprs.values())
        return df.lazy().select(*items, **dict(zip(names, named))).collect()

    def select_seq(self, *exprs: Any, **named_exprs: Any) -> DataFrame:
        return self.select(*exprs, **named_exprs)

    def with_columns(self, *exprs: Any, **named_exprs: Any) -> DataFrame:
        items = [x for e in exprs for x in (e if isinstance(e, (list, tuple)) else [e])]
        df, items = self._with_series(items)
        names = list(named_exprs)
        df, named = df._with_series(named_exprs.values())
        out = df.lazy().with_columns(*items, **dict(zip(names, named))).collect()
        hidden = [n for n in out.columns if n.startswith("__series_")]
        return out.drop(*hidden) if hidden else out

    def with_columns_seq(self, *exprs: Any, **named_exprs: Any) -> DataFrame:
        return self.with_columns(*exprs, **named_exprs)

    def filter(self, *predicates: Any, **constraints: Any) -> DataFrame:
        df, preds = self._with_series(predicates)
        out = df.lazy().filter(*preds, **constraints).collect()
        hidden = [n for n in out.columns if n.startswith("__series_")]
        return out.drop(*hidden) if hidden else out

    def remove(self, *predicates: Any, **constraints: Any) -> DataFrame:
        return self.lazy().remove(*predicates, **constraints).collect()

    def sort(self, by: Any, *more_by: Any, descending: Any = False, nulls_last: Any = False,
             maintain_order: bool = False, multithreaded: bool = True) -> DataFrame:
        return self.lazy().sort(by, *more_by, descending=descending, nulls_last=nulls_last,
                                maintain_order=maintain_order).collect()

    def group_by(self, *by: Any, maintain_order: bool = False, **named_by: Any):
        from polars_tpu_torch.groupby import GroupBy

        return GroupBy(self, by, named_by, maintain_order=maintain_order)

    def group_by_dynamic(self, index_column: Any, **kwargs: Any):
        """``LazyFrame.group_by_dynamic``; its ``agg`` collects."""
        return _Collecting(self.lazy().group_by_dynamic(index_column, **kwargs))

    def rolling(self, index_column: Any, **kwargs: Any):
        """``LazyFrame.rolling``; its ``agg`` collects."""
        return _Collecting(self.lazy().rolling(index_column, **kwargs))

    def upsample(self, time_column: str, *, every: str, group_by: Any = None, maintain_order: bool = False):
        """Rows at every step of ``every`` between each group's first and
        last ``time_column`` value (per ``group_by`` group): a range per
        group (``datetime_ranges`` from its bounds, on the device),
        exploded and left-joined with the frame; a new row is null but for
        its time and keys."""
        from polars_tpu_torch.functions.lazy import col, date_ranges, datetime_ranges

        keys = [] if group_by is None else flatten_names([group_by])
        tdt = self.schema[time_column]
        ranges = date_ranges if isinstance(tdt, dt.Date) else datetime_ranges
        kwargs = {} if isinstance(tdt, dt.Date) else {"time_unit": tdt.time_unit}
        lf = self.lazy()
        rng = ranges(col(time_column).min(), col(time_column).max(), every, **kwargs).alias(time_column)
        bounds = lf.group_by(*keys, maintain_order=True).agg(rng) if keys else lf.select(rng)
        grid = bounds.explode(time_column).with_columns(col(time_column).cast(tdt))
        out = grid.join(lf, on=[*keys, time_column], how="left", coalesce=True)
        return out.sort([*keys, time_column]).select(self.columns).collect()

    def join(self, other: DataFrame, on: Any = None, how: str = "inner", **kwargs: Any) -> DataFrame:
        return self.lazy().join(other.lazy(), on, how, **kwargs).collect()

    def join_where(self, other: DataFrame, *predicates: Any, suffix: str = "_right") -> DataFrame:
        return self.lazy().join_where(other.lazy(), *predicates, suffix=suffix).collect()

    def join_asof(self, other: DataFrame, **kwargs: Any) -> DataFrame:
        return self.lazy().join_asof(other.lazy(), **kwargs).collect()

    def unique(self, subset: Any = None, *, keep: str = "any", maintain_order: bool = False) -> DataFrame:
        if subset is not None:
            subset = flatten_names([subset])
        return self.lazy().unique(subset, keep=keep, maintain_order=maintain_order).collect()

    def n_unique(self, subset: Any = None) -> int:
        return self.unique(subset).height

    def slice(self, offset: int, length: int | None = None) -> DataFrame:
        return self.lazy().slice(offset, length).collect()

    def head(self, n: int = 5) -> DataFrame:
        return self.lazy().head(n if n >= 0 else max(0, self._height + n)).collect()

    def tail(self, n: int = 5) -> DataFrame:
        return self.lazy().tail(n if n >= 0 else max(0, self._height + n)).collect()

    def limit(self, n: int = 5) -> DataFrame:
        return self.head(n)

    def first(self) -> DataFrame:
        return self.head(1)

    def last(self) -> DataFrame:
        return self.tail(1)

    def reverse(self) -> DataFrame:
        return self.lazy().reverse().collect()

    def gather_every(self, n: int, offset: int = 0) -> DataFrame:
        return self.lazy().gather_every(n, offset).collect()

    def explode(self, columns: Any, *more_columns: Any) -> DataFrame:
        return self.lazy().explode(columns, *more_columns).collect()

    def unnest(self, columns: Any, *more_columns: Any) -> DataFrame:
        return self.lazy().unnest(columns, *more_columns).collect()

    # -- the API tail: row-wise helpers, flags, schema matching -----------------

    def approx_n_unique(self) -> DataFrame:
        return self.lazy().approx_n_unique().collect()

    def estimated_size(self, unit: str = "b") -> float:
        return sum(s.estimated_size(unit) for s in self.get_columns())

    def n_chunks(self, strategy: str = "first") -> int | list[int]:
        return 1 if strategy == "first" else [1] * self.width

    def rechunk(self) -> DataFrame:
        return self

    def shrink_to_fit(self, *, in_place: bool = False) -> DataFrame:
        return self

    def show(self, limit: int | None = 5, **kwargs: Any) -> None:
        print(self.head(limit) if limit is not None else self)

    def to_init_repr(self, n: int = 1000) -> str:
        cols = ", ".join(s.to_init_repr(n) for s in self.get_columns())
        return f"pl.DataFrame([{cols}])"

    def shift(self, n: int = 1, *, fill_value: Any = None) -> DataFrame:
        return self.lazy().shift(n, fill_value=fill_value).collect()

    def interpolate(self) -> DataFrame:
        return self.lazy().interpolate().collect()

    def product(self) -> DataFrame:
        from polars_tpu_torch.functions.lazy import all as pl_all

        return self.select(pl_all().product())

    def _horizontal(self, fn: str, name: str, **kwargs: Any) -> Series:
        import polars_tpu_torch.functions.lazy as F

        return self.select(getattr(F, fn)(F.all(), **kwargs).alias(name)).to_series()

    def sum_horizontal(self, *, ignore_nulls: bool = True) -> Series:
        return self._horizontal("sum_horizontal", "sum", ignore_nulls=ignore_nulls)

    def mean_horizontal(self, *, ignore_nulls: bool = True) -> Series:
        return self._horizontal("mean_horizontal", "mean", ignore_nulls=ignore_nulls)

    def min_horizontal(self) -> Series:
        return self._horizontal("min_horizontal", "min")

    def max_horizontal(self) -> Series:
        return self._horizontal("max_horizontal", "max")

    def fold(self, operation: Any) -> Series:
        """``operation`` folded over the columns, left to right."""
        acc = self.to_series(0)
        for s in self.get_columns()[1:]:
            acc = operation(acc, s)
        return acc.rename(self._columns[0].name)

    def is_duplicated(self) -> Series:
        """Whether each row's values appear in another row too."""
        from polars_tpu_torch.functions.lazy import len as pl_len

        return self.select((pl_len().over(self.columns) > 1).alias("is_duplicated")).to_series()

    def is_unique(self) -> Series:
        from polars_tpu_torch.functions.lazy import len as pl_len

        return self.select((pl_len().over(self.columns) == 1).alias("is_unique")).to_series()

    def hash_rows(self, seed: int = 0, seed_1: int | None = None, seed_2: int | None = None,
                  seed_3: int | None = None) -> Series:
        """One UInt64 hash per row: the columns' hashes (strings by their
        text) combined; equal rows hash equal."""
        from polars_tpu_torch.functions.lazy import col

        h = None
        for i, name in enumerate(self.columns):
            e = col(name).hash(seed + i)
            h = e if h is None else (h * 31) ^ e
        return self.select(h.alias("hash")).to_series()

    def corr(self, **kwargs: Any) -> DataFrame:
        """The Pearson correlation of every pair of columns (a square frame)."""
        from polars_tpu_torch.functions.lazy import corr

        names = self.columns
        row = self.select([corr(a, b).alias(f"{i}_{j}") for i, a in enumerate(names) for j, b in enumerate(names)])
        vals = row.row(0)
        k = len(names)
        return DataFrame({b: [vals[i * k + j] for i in range(k)] for j, b in enumerate(names)}, device=self._device)

    def to_struct(self, name: str = "") -> Series:
        """The columns as the fields of one Struct Series."""
        import torch

        from polars_tpu_torch.core.buffer import Buffer
        from polars_tpu_torch.core.series import Series

        ids = torch.arange(self._height, dtype=torch.int64, device=self._device)
        return Series._from_column(Column(name, dt.Struct([(c.name, c.dtype) for c in self._columns]),
                                          Buffer(ids, None), None, list(self._columns)))

    def insert_column(self, index: int, column: Series) -> DataFrame:
        """``column`` inserted at ``index``, in place."""
        cols = list(self._columns)
        cols.insert(index if index >= 0 else len(cols) + 1 + index, column._column)
        self._columns = DataFrame._from_columns(cols, self._height, device=self._device)._columns
        return self

    def replace_column(self, index: int, column: Series) -> DataFrame:
        """The column at ``index`` replaced by ``column``, in place."""
        cols = list(self._columns)
        cols[index] = column._column
        self._columns = DataFrame._from_columns(cols, self._height, device=self._device)._columns
        return self

    def drop_in_place(self, name: str) -> Series:
        """The column ``name``, removed from the frame."""
        from polars_tpu_torch.core.series import Series

        col = self._get(name)
        self._columns = [c for c in self._columns if c.name != name]
        return Series._from_column(col)

    def rows_by_key(self, key: Any, *, named: bool = False, include_key: bool = False,
                    unique: bool = False) -> dict:
        """The rows (read once) grouped by their ``key`` values: a list of
        rows per key (the last row with ``unique``)."""
        names = flatten_names([key])
        keys = list(zip(*[self._get(n).to_pylist() for n in names]))
        rest = [c for c in self.columns if include_key or c not in names]
        rows = self.select(rest).rows(named=named) if rest else [{} if named else () for _ in keys]
        out: dict = {}
        for k, r in zip(keys, rows):
            kv = k[0] if len(names) == 1 else k
            if unique:
                out[kv] = r
            else:
                out.setdefault(kv, []).append(r)
        return out

    def iter_columns(self):
        return iter(self.get_columns())

    def iter_slices(self, n_rows: int = 10000):
        for off in range(0, self._height, n_rows):
            yield self.slice(off, n_rows)

    def with_row_count(self, name: str = "row_nr", offset: int = 0) -> DataFrame:
        return self.with_row_index(name, offset)

    def set_sorted(self, column: str, *, descending: bool = False) -> DataFrame:
        """The frame with ``column`` flagged as sorted (nothing is checked)."""
        out = self.clone()
        out._sorted = {**self._sorted, column: "desc" if descending else "asc"}
        return out

    @property
    def flags(self) -> dict:
        return {c.name: {"SORTED_ASC": self._sorted.get(c.name) == "asc",
                         "SORTED_DESC": self._sorted.get(c.name) == "desc"} for c in self._columns}

    def is_sorted(self, by: Any, *more_by: str, descending: Any = False, nulls_last: Any = False) -> bool:
        """Whether the rows are in the order of ``by`` (lexicographic over
        several columns): each row against the one before, on the device,
        one read of the answer."""
        from polars_tpu_torch.engine.reshape import rows_sorted

        names = flatten_names([by, *more_by])
        k = len(names)
        desc = list(descending) if isinstance(descending, (list, tuple)) else [bool(descending)] * k
        nl = list(nulls_last) if isinstance(nulls_last, (list, tuple)) else [bool(nulls_last)] * k
        return rows_sorted([self._get(n) for n in names], desc, nl)

    def match_to_schema(self, schema: Any, **kwargs: Any) -> DataFrame:
        return self.lazy().match_to_schema(schema, **kwargs).collect()

    def to_torch(self, return_type: str = "dict", *, dtype: Any = None):
        """The columns' tensors on the frame's device, without a copy: a
        dict of name to values (``"dict"``), or one 2-D tensor of them cast
        to ``dtype`` (Float32 by default; a copy) with ``"tensor"``. A
        column with nulls, a dictionary or a nested layout is refused."""
        import torch

        from polars_tpu_torch.core.series import Series

        if return_type == "dict":
            return {c.name: Series._from_column(c).to_torch() for c in self._columns}
        if return_type != "tensor":
            raise InvalidOperationError(f"to_torch: unknown return_type {return_type!r}")
        target = torch.float32 if dtype is None else dt.dtype_to_torch(dt.parse_into_dtype(dtype))
        return torch.stack([Series._from_column(c).to_torch().to(target) for c in self._columns], 1)

    def update(self, other: DataFrame, on: Any = None, how: str = "left", **kwargs: Any) -> DataFrame:
        return self.lazy().update(other.lazy(), on, how, **kwargs).collect()

    def merge_sorted(self, other: DataFrame, key: str) -> DataFrame:
        return self.lazy().merge_sorted(other.lazy(), key).collect()

    # -- reshaping (engine/reshape.py) ------------------------------------------

    def unpivot(self, on: Any = None, *, index: Any = None, variable_name: str = "variable",
                value_name: str = "value") -> DataFrame:
        return self.lazy().unpivot(on, index=index, variable_name=variable_name, value_name=value_name).collect()

    def melt(self, id_vars: Any = None, value_vars: Any = None, variable_name: str = "variable",
             value_name: str = "value") -> DataFrame:
        return self.unpivot(value_vars, index=id_vars, variable_name=variable_name, value_name=value_name)

    def pivot(self, on: Any, *, index: Any = None, values: Any = None, aggregate_function: str | None = None,
              maintain_order: bool = True, sort_columns: bool = False, separator: str = "_") -> DataFrame:
        """One row per distinct ``index`` tuple (in order of first
        appearance), one column per distinct ``on`` value and ``values``
        column, each cell the ``aggregate_function`` of its rows (first,
        last, sum, mean, median, min, max, len or count; None raises where
        a cell holds several). ``index`` defaults to the other columns,
        ``values`` to the columns neither names."""
        from polars_tpu_torch.engine.reshape import pivot_frame

        on_names = flatten_names([on])
        if len(on_names) != 1:
            raise InvalidOperationError("pivot supports a single `on` column")
        on_name = on_names[0]
        value_names = None if values is None else flatten_names([values])
        if index is None:
            index_names = [c for c in self.columns if c != on_name and c not in (value_names or [])]
        else:
            index_names = flatten_names([index])
        if value_names is None:
            value_names = [c for c in self.columns if c != on_name and c not in index_names]
        return pivot_frame(self, on_name, index_names, value_names, aggregate_function, maintain_order,
                           sort_columns, separator)

    def transpose(self, *, include_header: bool = False, header_name: str = "column",
                  column_names: Any = None) -> DataFrame:
        """Rows become columns, in the supertype of every column."""
        from polars_tpu_torch.engine.reshape import transpose_frame

        return transpose_frame(self, include_header, header_name, column_names)

    def unstack(self, *, step: int, how: str = "vertical", columns: Any = None,
                fill_values: Any = None) -> DataFrame:
        """Each column cut into columns of ``step`` rows (``how="vertical"``:
        consecutive rows; ``"horizontal"``: every n-th row), the last padded
        with nulls or ``fill_values``."""
        from polars_tpu_torch.engine.reshape import unstack_frame

        return unstack_frame(self, step, how, columns, fill_values)

    def to_dummies(self, columns: Any = None, *, separator: str = "_", drop_first: bool = False) -> DataFrame:
        """A UInt8 indicator column per distinct value of each of
        ``columns`` (every column when None), in value order."""
        from polars_tpu_torch.engine.reshape import to_dummies_frame

        return to_dummies_frame(self, None if columns is None else flatten_names([columns]), separator, drop_first)

    # -- a user's functions (engine/udf.py) --------------------------------------

    def map_columns(self, column_names: Any, function: Any, *args: Any, **kwargs: Any) -> DataFrame:
        """The named columns replaced by ``function`` of each (a Series)."""
        from polars_tpu_torch.core.series import Series
        from polars_tpu_torch.engine.udf import as_column

        names = set(flatten_names([column_names]))
        cols = [as_column(function(Series._from_column(c), *args, **kwargs), c.name, self._device)
                if c.name in names else c for c in self._columns]
        return DataFrame._from_columns(cols, self._height, device=self._device)

    def map_rows(self, function: Any, return_dtype: Any = None, *, inference_size: int = 256) -> DataFrame:
        """``function`` of each row (a tuple), read to the host once: a tuple
        result gives ``column_0``, ``column_1``, ...; anything else one
        column ``map`` (its dtype ``return_dtype``, else inferred from the
        first ``inference_size`` results, as the JAX package does)."""
        outs = [function(r) for r in self.rows()]
        if outs and isinstance(outs[0], tuple):
            return DataFrame({f"column_{i}": [o[i] for o in outs] for i in range(len(outs[0]))},
                             device=self._device)
        return DataFrame({"map": outs}, schema_overrides={"map": return_dtype} if return_dtype else None,
                         device=self._device)

    def rename(self, mapping: Any, *, strict: bool = True) -> DataFrame:
        return self.lazy().rename(mapping, strict=strict).collect()

    def with_row_index(self, name: str = "index", offset: int = 0) -> DataFrame:
        return self.lazy().with_row_index(name, offset).collect()

    def drop_nulls(self, subset: Any = None) -> DataFrame:
        return self.lazy().drop_nulls(subset).collect()

    def drop_nans(self, subset: Any = None) -> DataFrame:
        return self.lazy().drop_nans(subset).collect()

    def fill_null(self, value: Any = None, strategy: str | None = None, limit: int | None = None,
                  **kwargs: Any) -> DataFrame:
        return self.lazy().fill_null(value, strategy, limit).collect()

    def fill_nan(self, value: Any) -> DataFrame:
        return self.lazy().fill_nan(value).collect()

    def cast(self, dtypes: Any, *, strict: bool = True) -> DataFrame:
        return self.lazy().cast(dtypes, strict=strict).collect()

    def top_k(self, k: int, *, by: Any, reverse: Any = False) -> DataFrame:
        return self.lazy().top_k(k, by=by, reverse=reverse).collect()

    def bottom_k(self, k: int, *, by: Any, reverse: Any = False) -> DataFrame:
        return self.lazy().bottom_k(k, by=by, reverse=reverse).collect()

    def pipe(self, function: Any, *args: Any, **kwargs: Any):
        return function(self, *args, **kwargs)

    def partition_by(self, by: Any, *more_by: Any, maintain_order: bool = True, include_key: bool = True,
                     as_dict: bool = False):
        """One frame per distinct value of the ``by`` columns (a filter
        each), in order of first appearance with ``maintain_order``."""
        from polars_tpu_torch.functions.lazy import col, lit

        names = flatten_names([by, *more_by])
        keys = self.select(names).unique(maintain_order=maintain_order).rows()
        parts = {}
        for row in keys:
            pred = None
            for n, v in zip(names, row):
                p = col(n).eq_missing(lit(v, dtype=self.schema[n]) if v is not None else lit(None))
                pred = p if pred is None else pred & p
            sub = self.filter(pred)
            parts[tuple(row)] = sub.drop(*names) if not include_key else sub
        return parts if as_dict else list(parts.values())

    def sample(self, n: int | None = None, *, fraction: float | None = None, with_replacement: bool = False,
               shuffle: bool = False, seed: int | None = None) -> DataFrame:
        """``n`` rows (or ``fraction`` of them) drawn by numpy's generator
        from ``seed``, in frame order unless ``shuffle``."""
        rng = np.random.default_rng(seed)
        if n is None:
            n = self._height if fraction is None else int(self._height * fraction)
        if with_replacement:
            idx = rng.integers(0, self._height, size=n)
        else:
            idx = rng.choice(self._height, size=min(n, self._height), replace=False)
            if not shuffle:
                idx = np.sort(idx)
        return self.gather(idx)

    def glimpse(self, *, max_items_per_column: int = 10, max_colname_length: int = 50,
                return_as_string: bool = False) -> str | None:
        """Each column's name, dtype and first values, one line each."""
        lines = [f"Rows: {self.height}", f"Columns: {self.width}"]
        for c in self._columns:
            vals = c.to_pylist()[:max_items_per_column]
            lines.append(f"$ {c.name[:max_colname_length]:<15} <{c.dtype!r}> {vals}")
        out = "\n".join(lines)
        if return_as_string:
            return out
        print(out)
        return None

    def describe(self) -> DataFrame:
        """Count, null count, mean, std, min and max of each column, one
        row per statistic (as text for a column that is not numeric)."""
        stats = ["count", "null_count", "mean", "std", "min", "max"]
        data: dict[str, list] = {"statistic": stats}
        for s in self.get_columns():
            numeric = s.dtype.is_numeric()
            vals = [float(len(s) - s.null_count()), float(s.null_count())]
            vals += [s.mean() if numeric else None, s.std() if numeric else None]
            vals += [s.min(), s.max()] if numeric or isinstance(s.dtype, dt.String) else [None, None]
            data[s.name] = [None if v is None else (float(v) if numeric else str(v)) for v in vals]
        return DataFrame(data, device=self._device)

    # -- frame aggregates -----------------------------------------------------

    def sum(self) -> DataFrame:
        return self.lazy().sum().collect()

    def mean(self) -> DataFrame:
        return self.lazy().mean().collect()

    def min(self) -> DataFrame:
        return self.lazy().min().collect()

    def max(self) -> DataFrame:
        return self.lazy().max().collect()

    def median(self) -> DataFrame:
        return self.lazy().median().collect()

    def std(self, ddof: int = 1) -> DataFrame:
        return self.lazy().std(ddof).collect()

    def var(self, ddof: int = 1) -> DataFrame:
        return self.lazy().var(ddof).collect()

    def quantile(self, quantile: float, interpolation: str = "nearest") -> DataFrame:
        return self.lazy().quantile(quantile, interpolation).collect()

    def count(self) -> DataFrame:
        return self.lazy().count().collect()

    def null_count(self) -> DataFrame:
        return self.lazy().null_count().collect()

    def item(self, row: int | None = None, column: int | str | None = None) -> Any:
        """The one value of a 1x1 frame, or the value at (row, column)."""
        if row is None and column is None:
            if self.shape != (1, 1):
                raise ValueError(f"can only call .item() on a 1x1 frame, got {self.shape}")
            return self._columns[0].to_pylist()[0]
        if row is None or column is None:
            raise ValueError("item() needs both a row and a column, or neither")
        col = self._columns[column] if isinstance(column, int) else self._get(column)
        return col.to_pylist()[row]

    # -- column operations ----------------------------------------------------

    def gather(self, indices: Any) -> DataFrame:
        """The rows at ``indices`` (a sequence or a tensor; negative indices
        count from the end, ``None`` gives a null row)."""
        from polars_tpu_torch.engine.gather import gather_frame

        cols = gather_frame(self._columns, indices)
        height = len(cols[0]) if cols else len(indices)
        return DataFrame._from_columns(cols, height, device=self._device)

    def drop(self, *columns: Any, strict: bool = True) -> DataFrame:
        names = set(flatten_names(columns))
        if strict and names - set(self.columns):
            raise ColumnNotFoundError(f"{sorted(names - set(self.columns))} not found")
        return DataFrame._from_columns([c for c in self._columns if c.name not in names], self._height,
                                       device=self._device)

    def clone(self) -> DataFrame:
        return DataFrame._from_columns(list(self._columns), self._height, device=self._device)

    def clear(self, n: int = 0) -> DataFrame:
        """An empty frame of the same schema (``n`` rows of nulls)."""
        return DataFrame._empty(self.schema, n, self._device)

    def hstack(self, columns: Any, *, in_place: bool = False) -> DataFrame:
        """The columns of ``columns`` (a frame or Series) beside these."""
        new = columns._columns if isinstance(columns, DataFrame) else [c._column for c in columns]
        if any(len(c) != self._height for c in new) and self._columns:
            raise ShapeError("hstack needs columns of the frame's height")
        height = self._height if self._columns else (len(new[0]) if new else 0)
        out = DataFrame._from_columns(self._columns + list(new), height, device=self._device)
        if in_place:
            self._columns, self._height = out._columns, out._height
            return self
        return out

    def vstack(self, other: DataFrame, *, in_place: bool = False) -> DataFrame:
        from polars_tpu_torch.functions.eager import concat

        out = concat([self, other])
        if in_place:
            self._columns, self._height = out._columns, out._height
            return self
        return out

    def extend(self, other: DataFrame) -> DataFrame:
        return self.vstack(other, in_place=True)

    # -- to the host ----------------------------------------------------------

    def to_dict(self, *, as_series: bool = True) -> dict:
        if as_series:
            return {c.name: s for c, s in zip(self._columns, self.get_columns())}
        return {c.name: c.to_pylist() for c in self._columns}

    def to_dicts(self) -> list[dict]:
        lists = [(c.name, c.to_pylist()) for c in self._columns]
        return [{name: vals[i] for name, vals in lists} for i in range(self._height)]

    def rows(self, *, named: bool = False) -> list:
        if named:
            return self.to_dicts()
        return list(zip(*[c.to_pylist() for c in self._columns])) if self._columns else []

    def iter_rows(self, *, named: bool = False):
        return iter(self.rows(named=named))

    def row(self, index: int | None = None, *, by_predicate: Any = None, named: bool = False):
        """One row as a tuple (a dict with ``named``): by position, or the
        one row ``by_predicate`` keeps."""
        if by_predicate is not None:
            sub = self.filter(by_predicate)
            if sub.height != 1:
                raise ValueError(f"predicate matched {sub.height} rows, not one")
            return sub.row(0, named=named)
        if index is None:
            raise ValueError("row() needs an index or a predicate")
        return self.slice(index, 1).rows(named=named)[0]

    def to_numpy(self) -> np.ndarray:
        arrs = [c.to_numpy() for c in self._columns]
        if not arrs:
            return np.empty((0, 0))
        return np.column_stack(arrs) if len(arrs) > 1 else arrs[0].reshape(-1, 1)

    # -- interchange and files (io/) --------------------------------------------

    def to_arrow(self) -> Any:
        import pyarrow as pa

        from polars_tpu_torch.io._arrow import column_to_arrow

        return pa.table({c.name: column_to_arrow(c) for c in self._columns})

    def to_pandas(self) -> Any:
        import pandas as pd

        return pd.DataFrame({c.name: c.to_numpy() for c in self._columns})

    def __arrow_c_stream__(self, requested_schema: Any = None) -> Any:
        """Arrow PyCapsule C-stream export."""
        return self.to_arrow().__arrow_c_stream__(requested_schema)

    def __dataframe__(self, nan_as_null: bool = False, allow_copy: bool = True) -> Any:
        """The dataframe interchange protocol, through the Arrow table."""
        return self.to_arrow().__dataframe__(nan_as_null, allow_copy)

    def write_parquet(self, file: Any, **kwargs: Any) -> None:
        from polars_tpu_torch.io.parquet import write_parquet

        write_parquet(self, file, **kwargs)

    def write_csv(self, file: Any = None, **kwargs: Any):
        from polars_tpu_torch.io.csv import write_csv

        return write_csv(self, file, **kwargs)

    def write_ipc(self, file: Any, **kwargs: Any) -> None:
        from polars_tpu_torch.io.ipc import write_ipc

        write_ipc(self, file, **kwargs)

    def write_ipc_stream(self, file: Any, **kwargs: Any) -> None:
        from polars_tpu_torch.io.ipc import write_ipc_stream

        write_ipc_stream(self, file, **kwargs)

    def write_ndjson(self, file: Any = None, **kwargs: Any):
        from polars_tpu_torch.io.ndjson import write_ndjson

        return write_ndjson(self, file, **kwargs)

    def write_json(self, file: Any = None, **kwargs: Any):
        from polars_tpu_torch.io.ndjson import write_json

        return write_json(self, file, **kwargs)

    def write_database(self, table_name: str, connection: Any, *, if_table_exists: str = "fail",
                       engine: str = "sqlalchemy", **kwargs: Any) -> int:
        from polars_tpu_torch.io.database import write_database

        return write_database(self, table_name, connection, if_table_exists=if_table_exists)

    def write_avro(self, file: Any, compression: str = "uncompressed", **kwargs: Any) -> None:
        _needs("write_avro", "fastavro")

    def write_excel(self, workbook: Any = None, worksheet: Any = None, **kwargs: Any):
        _needs("write_excel", "xlsxwriter")

    def write_clipboard(self, *, separator: str = "\t", **kwargs: Any) -> None:
        from polars_tpu_torch.io.extra import _missing_dep

        _missing_dep("write_clipboard", "a clipboard backend (headless environment)")

    def write_delta(self, target: Any, *, mode: str = "error", **kwargs: Any):
        _needs("write_delta", "deltalake").write_deltalake(target, self.to_arrow(), mode=mode, **kwargs)

    def write_iceberg(self, target: Any, *, mode: str = "append", **kwargs: Any):
        _needs("write_iceberg", "pyiceberg")
        raise NotImplementedError("write_iceberg: writing an Iceberg table is not supported")

    def equals(self, other: DataFrame, *, null_equal: bool = True) -> bool:
        """Same columns, dtypes and values (NaN equals NaN; null equals null
        with ``null_equal``)."""
        if self.shape != other.shape or self.columns != other.columns or self.dtypes != other.dtypes:
            return False
        from polars_tpu_torch.core.series import values_equal

        return all(values_equal(a.to_pylist(), b.to_pylist(), null_equal)
                   for a, b in zip(self._columns, other._columns))

    def __eq__(self, other: object) -> Any:
        if isinstance(other, DataFrame):
            return self.equals(other)
        return NotImplemented

    __hash__ = None

    def __repr__(self) -> str:
        from polars_tpu_torch.utils.fmt import format_table

        return format_table(self)

    def __str__(self) -> str:
        return self.__repr__()


def _needs(fn: str, module: str):
    """``module``, imported, or the optional dependency's ``ImportError``."""
    import importlib

    try:
        return importlib.import_module(module)
    except ImportError:
        from polars_tpu_torch.io.extra import _missing_dep

        _missing_dep(fn, module)


def _repeat(col: Column, n: int) -> Column:
    """A column of one value as ``n`` rows of it."""
    from polars_tpu_torch.core.buffer import Buffer

    buf = col.buffer
    validity = None if buf.validity is None else buf.validity.expand(n).contiguous()
    return col.with_buffer(Buffer(buf.values.expand(n).contiguous(), validity, n))


def _schema_items(schema: Any) -> list[tuple[str, Any]]:
    """(name, dtype or None) of a schema given as a mapping or a sequence of
    names and (name, dtype) pairs."""
    if schema is None:
        return []
    if isinstance(schema, (Schema, Mapping)):
        return [(n, None if d is None else dt.parse_into_dtype(d)) for n, d in schema.items()]
    out = []
    for entry in schema:
        out.append((entry, None) if isinstance(entry, str) else (entry[0], dt.parse_into_dtype(entry[1])))
    return out


def flatten_names(items: Any) -> list[str]:
    """The column names in ``items``: strings, or nested sequences of them."""
    if isinstance(items, str):
        return [items]
    out: list[str] = []
    for it in items:
        out.extend([it] if isinstance(it, str) else flatten_names(it))
    return out


def _build_columns(data: Any, schema: Any, schema_overrides: Mapping[str, Any] | None, strict: bool,
                   orient: str | None, device) -> list[Column]:
    """The columns of the constructor's input (the JAX package's
    ``_build_columns``), each cast to the dtype ``schema`` or
    ``schema_overrides`` gives it."""
    from polars_tpu_torch.core.series import Series

    items = _schema_items(schema)
    names = [n for n, _ in items]
    dtypes = {n: d for n, d in items if d is not None}
    dtypes.update({n: dt.parse_into_dtype(d) for n, d in (schema_overrides or {}).items()})
    kind = (type(data).__module__.split(".")[0], type(data).__name__)
    if kind == ("pandas", "DataFrame"):
        data = _pandas_columns(data)
    elif kind in (("pyarrow", "Table"), ("pyarrow", "RecordBatch")):
        from polars_tpu_torch.io._arrow import arrow_to_columns

        return arrow_to_columns(data, dtypes, device=device)

    def build(name: str, values: Any) -> Column:
        d = dtypes.get(name)
        if isinstance(values, Series):
            col = values._column.rename(name)
            return col if d is None or d == col.dtype else _cast_column(col, d, strict)
        return Column.from_values(name, values, d, device=device)

    if isinstance(data, Mapping):
        cols = [build(str(k), v) for k, v in data.items()]
        if names and [c.name for c in cols] != names:
            if len(names) != len(cols):
                raise ShapeError(f"the schema names {len(names)} columns, the data has {len(cols)}")
            cols = [build(n, Series._from_column(c)) for n, c in zip(names, cols)]
        return cols
    if isinstance(data, np.ndarray):
        if data.ndim == 1:
            return [build(names[0] if names else "column_0", data)]
        if data.ndim != 2:
            raise ShapeError("numpy input must be 1-D or 2-D")
        if orient == "col":  # each row of the array is a column
            data = data.T
        cols_np = [data[:, i] for i in range(data.shape[1])]
        return [build(names[i] if names else f"column_{i}", c) for i, c in enumerate(cols_np)]
    if isinstance(data, Sequence) and not isinstance(data, str):
        data = list(data)
        if not data:
            return [Column.from_values(n, [], dtypes.get(n), device=device) for n in names]
        first = data[0]
        if isinstance(first, Series):
            return [build(names[i] if i < len(names) else (s.name or f"column_{i}"), s) for i, s in enumerate(data)]
        if isinstance(first, Mapping):
            keys = names or list(dict.fromkeys(k for row in data for k in row))
            return [build(k, [row.get(k) for row in data]) for k in keys]
        if isinstance(first, (list, tuple)) and orient != "col":
            width = len(first)
            return [build(names[i] if names else f"column_{i}", [row[i] for row in data]) for i in range(width)]
        if isinstance(first, (list, tuple)):
            return [build(names[i] if names else f"column_{i}", list(c)) for i, c in enumerate(data)]
        return [build(names[0] if names else "column_0", data)]
    raise TypeError(f"cannot create DataFrame from {type(data).__name__}")


def _pandas_columns(pdf: Any) -> dict:
    """A pandas frame's columns as numpy arrays (NaN a null, as for any
    numpy input; pandas' missing-value sentinels in object and string
    columns None)."""
    import pandas as pd

    out = {}
    for k in pdf.columns:
        arr = pdf[k].to_numpy()
        if arr.dtype.kind in ("O", "U", "T"):
            arr = np.asarray([None if pd.isna(x) else x for x in arr], dtype=object)
        out[str(k)] = arr
    return out


def _cast_column(col: Column, dtype: dt.DataType, strict: bool) -> Column:
    """``col`` cast to ``dtype`` by a one-column plan."""
    from polars_tpu_torch.plan import exprs as E

    df = DataFrame._from_columns([col], len(col))
    return df.lazy().select(E.ECast(E.EColumn(col.name), dtype, strict)).collect()._columns[0]


class _Collecting:
    """A lazy window grouping whose ``agg`` gives a DataFrame."""

    __slots__ = ("_lazy",)

    def __init__(self, lazy) -> None:
        self._lazy = lazy

    def agg(self, *aggs: Any, **named_aggs: Any) -> DataFrame:
        return self._lazy.agg(*aggs, **named_aggs).collect()

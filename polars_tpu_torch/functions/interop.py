"""``QueryOptFlags`` (the port of the class in
``polars_tpu/functions/interop.py``; reference: py-polars
lazyframe/opt_flags.py), the interchange constructors (``from_torch``,
``from_arrow``, ``from_pandas``, ``from_repr``, ``json_normalize``,
``defer``) and ``CompatLevel`` and ``FileProviderArgs``."""

from __future__ import annotations

import dataclasses
from typing import Any

_PASSES = (
    "predicate_pushdown", "projection_pushdown", "simplify_expression", "slice_pushdown", "comm_subplan_elim",
    "comm_subexpr_elim", "cluster_with_columns", "collapse_joins", "check_order_observe", "fast_projection",
)


class QueryOptFlags:
    """The optimizer's toggles. ``collect(optimizations=...)`` and
    ``explain(optimizations=...)`` hand them to ``plan.optimizer.optimize``,
    which runs a pass only while its toggle is on: simplify_expression,
    comm_subexpr_elim (aggregates repeated across a sort), check_order_observe
    (sorts nothing observes), predicate_pushdown, collapse_joins (a filtered
    cross join becomes an equi join), fast_projection (COUNT(*) from the
    frame's height), projection_pushdown, slice_pushdown (top-k) and
    comm_subplan_elim (subplans used twice run once). type_check resolves the
    whole plan's schema first. cluster_with_columns and type_coercion are
    accepted and change nothing."""

    def __init__(
        self,
        *,
        predicate_pushdown: bool = True,
        projection_pushdown: bool = True,
        simplify_expression: bool = True,
        slice_pushdown: bool = True,
        comm_subplan_elim: bool = True,
        comm_subexpr_elim: bool = True,
        cluster_with_columns: bool = True,
        collapse_joins: bool = True,
        check_order_observe: bool = True,
        fast_projection: bool = True,
        type_coercion: bool = True,
        type_check: bool = True,
    ) -> None:
        self.predicate_pushdown = predicate_pushdown
        self.projection_pushdown = projection_pushdown
        self.simplify_expression = simplify_expression
        self.slice_pushdown = slice_pushdown
        self.comm_subplan_elim = comm_subplan_elim
        self.comm_subexpr_elim = comm_subexpr_elim
        self.cluster_with_columns = cluster_with_columns
        self.collapse_joins = collapse_joins
        self.check_order_observe = check_order_observe
        self.fast_projection = fast_projection
        self.type_coercion = type_coercion
        self.type_check = type_check

    @classmethod
    def none(cls) -> QueryOptFlags:
        """Every pass off (the schema check stays)."""
        return cls(**{k: False for k in _PASSES})


# -- conversions (the JAX package's functions/interop.py) -------------------------------------------

_DTYPE_NAMES = {
    "i8": "Int8", "i16": "Int16", "i32": "Int32", "i64": "Int64", "u8": "UInt8", "u16": "UInt16", "u32": "UInt32",
    "u64": "UInt64", "f32": "Float32", "f64": "Float64", "bool": "Boolean", "str": "String", "date": "Date",
    "time": "Time", "binary": "Binary", "null": "Null", "cat": "Categorical",
}


def from_torch(tensor, schema=None, *, device=None):
    """A Series (1-D) or a DataFrame (2-D: a column per trailing index) of a
    tensor. A 1-D tensor already on the target device (the default one, or
    ``device``) is the Series' buffer itself, without a copy."""
    import torch

    from polars_tpu_torch import datatypes as dt
    from polars_tpu_torch.config import resolve_device
    from polars_tpu_torch.core.buffer import Buffer
    from polars_tpu_torch.core.column import Column
    from polars_tpu_torch.core.frame import DataFrame
    from polars_tpu_torch.core.series import Series

    target = resolve_device(device)
    t = tensor.detach()

    def column(name: str, x: torch.Tensor) -> Column:
        d = dt.numpy_to_dtype(torch.empty(0, dtype=x.dtype).numpy().dtype)
        return Column(name, d, Buffer(x.to(target).contiguous(), None))

    if t.dim() == 1 and schema is None:
        return Series._from_column(column("", t))
    if t.dim() != 2:
        raise ValueError(f"from_torch takes a 1-D or 2-D tensor, got {t.dim()} dimensions")
    names = [f"column_{i}" for i in range(t.shape[1])] if schema is None else list(
        schema.keys() if hasattr(schema, "keys") else schema)
    return DataFrame._from_columns([column(n, t[:, i]) for i, n in enumerate(names)], t.shape[0], device=target)


def _dtype_of_token(tok: str):
    import re

    from polars_tpu_torch import datatypes as dt

    name = _DTYPE_NAMES.get(tok, tok)
    m = re.fullmatch(r"(?:datetime|Datetime)\[(\w+)\]|Datetime\(time_unit='(\w+)'.*\)", name)
    if m:
        return dt.Datetime((m.group(1) or m.group(2)).replace("μs", "us"))
    try:
        return dt.parse_into_dtype(getattr(dt, name)) if hasattr(dt, name) else None
    except Exception:  # noqa: BLE001 (a token that names no dtype)
        return None


def _cell(tok: str, dtype):
    import datetime as _d

    tok = tok.strip()
    if tok in ("null", ""):
        return None
    kind = type(dtype).__name__
    if kind in ("Float32", "Float64"):
        return float(tok)
    if dtype.is_integer():
        return int(tok)
    parse = {"Boolean": lambda t: t == "true", "Date": _d.date.fromisoformat, "Datetime": _d.datetime.fromisoformat,
             "Time": _d.time.fromisoformat}.get(kind)
    if parse is not None:
        return parse(tok)
    return tok[1:-1] if len(tok) >= 2 and tok[0] == tok[-1] == '"' else tok


def from_repr(data: str):
    """A DataFrame from its printed table (this package's or Polars'; rows
    marked … are skipped)."""
    from polars_tpu_torch import datatypes as dt
    from polars_tpu_torch.core.frame import DataFrame

    rows = [ln for ln in data.splitlines() if "│" in ln or "┆" in ln]
    if not rows:
        raise ValueError("from_repr: no table found")

    def split(ln: str) -> list[str]:
        ln = ln.strip().strip("│")
        return [c.strip() for c in ln.split("┆" if "┆" in ln else "│")]

    header = split(rows[0])
    start, dtypes = 1, None
    if len(rows) > 2 and split(rows[1]) == ["---"] * len(header):
        dtypes, start = [_dtype_of_token(t) or dt.String() for t in split(rows[2])], 3
    cols: dict[str, list] = {h: [] for h in header}
    use = dtypes or [dt.String()] * len(header)
    for ln in rows[start:]:
        cells = split(ln)
        if len(cells) != len(header) or all(c == "…" for c in cells):
            continue
        for h, c, d in zip(header, cells, use):
            cols[h].append(_cell(c, d))
    return DataFrame(cols, schema=dict(zip(header, dtypes)) if dtypes else None)


def json_normalize(data, *, separator: str = ".", max_level: int | None = None, schema=None, strict: bool = True,
                   infer_schema_length: int | None = 100):
    """Nested dicts flattened into dotted columns."""
    from polars_tpu_torch.core.frame import DataFrame

    if isinstance(data, dict):
        data = [data]

    def flatten(d: dict, prefix: str = "", level: int = 0) -> dict:
        out = {}
        for k, v in d.items():
            key = f"{prefix}{separator}{k}" if prefix else str(k)
            if isinstance(v, dict) and (max_level is None or level < max_level):
                out.update(flatten(v, key, level + 1))
            else:
                out[key] = v
        return out

    flat = [flatten(d) for d in data]
    keys = list(dict.fromkeys(k for d in flat for k in d))
    return DataFrame({k: [d.get(k) for d in flat] for k in keys}, schema=schema)


def defer(function, *, schema, validate_schema: bool = True):
    """A LazyFrame whose data ``function()`` makes when it is collected (a
    map function over an empty frame)."""
    from polars_tpu_torch import datatypes as dt
    from polars_tpu_torch.core.frame import DataFrame
    from polars_tpu_torch.errors import SchemaError

    want = {k: dt.parse_into_dtype(v) for k, v in dict(schema).items()}

    def make(_):
        out = function()
        if validate_schema and dict(out.schema) != want:
            raise SchemaError(f"defer: the function's schema {dict(out.schema)} is not {want}")
        return out

    return DataFrame(schema=want).lazy().map_batches(make, schema=want)


class CompatLevel:
    """Arrow format compat level (reference: _utils/compat_level.py)."""

    def __init__(self, level: int = 1) -> None:
        self._level = level

    @classmethod
    def newest(cls) -> CompatLevel:
        return cls(1)

    @classmethod
    def oldest(cls) -> CompatLevel:
        return cls(0)


@dataclasses.dataclass
class FileProviderArgs:
    """Arguments handed to a custom ``file_path_provider`` callback of a
    partitioned write (the JAX package's ``io/partition.py``)."""

    index: int
    part: int
    in_part_index: int
    keys: dict[str, Any]


def from_arrow(data, **kwargs):
    """A DataFrame of an Arrow table or record batch, or a Series of an
    Arrow array, on the default device."""
    import pyarrow as pa

    from polars_tpu_torch.core.frame import DataFrame

    if isinstance(data, (pa.Table, pa.RecordBatch)):
        return DataFrame(data, **kwargs)
    if isinstance(data, (pa.Array, pa.ChunkedArray)):
        from polars_tpu_torch.config import resolve_device
        from polars_tpu_torch.core.series import Series
        from polars_tpu_torch.io._arrow import arrow_array_to_column

        return Series._from_column(arrow_array_to_column("", data, device=resolve_device(kwargs.get("device"))))
    raise TypeError(f"cannot create from {type(data).__name__}")


def from_pandas(df, **kwargs):
    from polars_tpu_torch.core.frame import DataFrame

    return DataFrame(df, **kwargs)

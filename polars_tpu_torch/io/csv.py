"""CSV read, scan and write (the port of ``polars_tpu/io/csv.py``;
reference: polars-io/src/csv; the host reads with Arrow C++'s
multithreaded CSV reader)."""

from __future__ import annotations

import io as _io
from typing import Any

from polars_tpu_torch import datatypes as dt
from polars_tpu_torch.plan import logical as L


def scan_csv(
    source: Any,
    *,
    has_header: bool = True,
    separator: str = ",",
    comment_prefix: str | None = None,
    quote_char: str | None = '"',
    skip_rows: int = 0,
    schema_overrides: Any = None,
    null_values: Any = None,
    try_parse_dates: bool = False,
    n_rows: int | None = None,
    encoding: str = "utf8",
    infer_schema_length: int | None = 100,
    row_index_name: str | None = None,
    row_index_offset: int = 0,
    storage_options: Any = None,
    **kwargs: Any,
):
    from polars_tpu_torch.io.parquet import _expand_paths
    from polars_tpu_torch.lazyframe import LazyFrame

    source = _materialize_filelike(source)
    overrides = ()
    if schema_overrides:
        if isinstance(schema_overrides, dict):
            overrides = tuple((k, dt.parse_into_dtype(v)) for k, v in schema_overrides.items())
        else:
            overrides = tuple((f"column_{i + 1}", dt.parse_into_dtype(v)) for i, v in enumerate(schema_overrides))
    node = L.LScan(
        sources=_expand_paths(source, storage_options=storage_options),
        fmt="csv",
        options=(
            ("storage_options", tuple(sorted(dict(storage_options).items())) if storage_options else ()),
            ("has_header", has_header),
            ("separator", separator),
            ("quote_char", quote_char),
            ("skip_rows", skip_rows),
            ("schema_overrides", overrides),
            ("null_values", tuple(null_values) if isinstance(null_values, (list, tuple)) else null_values),
            ("try_parse_dates", try_parse_dates),
            ("comment_prefix", comment_prefix),
        ),
        n_rows=n_rows,
        row_index=(row_index_name, row_index_offset) if row_index_name else None,
    )
    return LazyFrame._from_node(node)


def _materialize_filelike(source: Any) -> Any:
    """File-like objects and raw bytes become a temporary file the Arrow
    reader can open (``read_csv`` takes paths, ``Path``,
    ``BytesIO``/``StringIO`` and bytes)."""
    import tempfile

    data = None
    if hasattr(source, "read"):
        data = source.read()
    elif isinstance(source, (bytes, bytearray)):
        data = bytes(source)
    if data is None:
        return source
    if isinstance(data, str):
        data = data.encode()
    with tempfile.NamedTemporaryFile(suffix=".csv", delete=False) as f:
        f.write(data)
    return f.name


def read_csv(source: Any, *, columns: Any = None, new_columns: Any = None, **kwargs: Any):
    lf = scan_csv(source, **kwargs)
    if columns is not None:
        lf = lf.select(list(columns))
    out = lf.collect()
    if new_columns:
        out = out.rename(dict(zip(out.columns, list(new_columns))))
    return out


def write_csv(
    df,
    file: Any = None,
    *,
    include_header: bool = True,
    separator: str = ",",
    quote_char: str = '"',
    null_value: str = "",
    **kwargs: Any,
):
    lines = []
    if include_header:
        lines.append(separator.join(_quote(c, separator, quote_char) for c in df.columns))
    cols = [c.to_pylist() for c in df._columns]
    for i in range(df.height):
        parts = []
        for vals in cols:
            v = vals[i]
            if v is None:
                parts.append(null_value)
            elif isinstance(v, bool):
                parts.append("true" if v else "false")
            elif isinstance(v, str):
                parts.append(_quote(v, separator, quote_char))
            elif isinstance(v, float):
                parts.append(repr(v))
            else:
                parts.append(str(v))
        lines.append(separator.join(parts))
    out = "\n".join(lines) + "\n"
    if file is None:
        return out
    if isinstance(file, str) or hasattr(file, "__fspath__"):
        with open(file, "w") as f:
            f.write(out)
        return None
    file.write(out.encode() if isinstance(file, _io.BytesIO) else out)
    return None


def _quote(s: str, sep: str, q: str) -> str:
    if sep in s or q in s or "\n" in s:
        return q + s.replace(q, q + q) + q
    return s

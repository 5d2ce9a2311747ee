"""NDJSON / JSON read, scan and write (the port of
``polars_tpu/io/ndjson.py``; reference: polars-json)."""

from __future__ import annotations

import json as _json
from typing import Any

from polars_tpu_torch.plan import logical as L


def scan_ndjson(source: Any, *, n_rows: int | None = None, storage_options: Any = None, **kwargs: Any):
    from polars_tpu_torch.io.csv import _materialize_filelike
    from polars_tpu_torch.io.parquet import _expand_paths
    from polars_tpu_torch.lazyframe import LazyFrame

    node = L.LScan(
        sources=_expand_paths(_materialize_filelike(source), storage_options=storage_options),
        fmt="ndjson",
        options=(("storage_options", tuple(sorted(dict(storage_options).items())) if storage_options else ()),),
        n_rows=n_rows,
    )
    return LazyFrame._from_node(node)


def read_ndjson(source: Any, **kwargs: Any):
    return scan_ndjson(source, **kwargs).collect()


def read_json(source: Any, **kwargs: Any):
    from polars_tpu_torch.core.frame import DataFrame

    if hasattr(source, "read"):
        data = _json.load(source)
    elif isinstance(source, (bytes, bytearray)):
        data = _json.loads(source)
    else:
        with open(source) as f:
            data = _json.load(f)
    return DataFrame(data)


def _write_text(out: str, file: Any):
    if file is None:
        return out
    if isinstance(file, str) or hasattr(file, "__fspath__"):
        with open(file, "w") as f:
            f.write(out)
        return None
    file.write(out)
    return None


def write_ndjson(df, file: Any = None, **kwargs: Any):
    return _write_text("".join(_json.dumps(r, default=str) + "\n" for r in df.to_dicts()), file)


def write_json(df, file: Any = None, **kwargs: Any):
    return _write_text(_json.dumps(df.to_dicts(), default=str), file)

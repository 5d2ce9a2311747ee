"""Schema resolution for LScan nodes (the port of
``polars_tpu/io/scan_schema.py``): cached per source list and keyed by the
first file's (mtime, size), so that a rewritten file shows its new
schema."""

from __future__ import annotations

import functools

from polars_tpu_torch import datatypes as dt
from polars_tpu_torch.core.schema import Schema
from polars_tpu_torch.errors import ComputeError
from polars_tpu_torch.plan import logical as L


def _fingerprint(sources: tuple[str, ...]) -> tuple:
    """(mtime_ns, size) of the first local source."""
    import os

    if not sources:
        return ()
    try:
        st = os.stat(sources[0])
        return (st.st_mtime_ns, st.st_size)
    except OSError:
        return ()


@functools.lru_cache(maxsize=512)
def _schema_for(sources: tuple[str, ...], fmt: str, options, _fp: tuple = ()) -> Schema:
    if not sources:
        return Schema()
    from polars_tpu_torch.io._arrow import arrow_schema_to_schema

    path = sources[0]  # a local path: io/parquet._expand_paths refuses remote ones
    if fmt == "parquet":
        import pyarrow.parquet as pq

        return arrow_schema_to_schema(pq.read_schema(path))
    if fmt == "ipc":
        import pyarrow.ipc as ipc

        with open(path, "rb") as f:
            try:
                return arrow_schema_to_schema(ipc.open_file(f).schema)
            except Exception:  # noqa: BLE001 (not the file format: the stream format)
                f.seek(0)
                return arrow_schema_to_schema(ipc.open_stream(f).schema)
    if fmt == "csv":
        from polars_tpu_torch.io.scan_exec import _read_csv_arrow

        sch = arrow_schema_to_schema(_read_csv_arrow(path, dict(options), n_rows=100).schema)
        for name, d in dict(options).get("schema_overrides", ()):
            if name in sch:
                sch[name] = d
        return sch
    if fmt == "ndjson":
        import pyarrow.json as pj

        return arrow_schema_to_schema(pj.read_json(path).schema)
    if fmt == "pyarrow_dataset":
        from polars_tpu_torch.io.extra import get_dataset

        return arrow_schema_to_schema(get_dataset(path).schema)
    raise ComputeError(f"unknown scan format {fmt!r}")


def scan_schema(node: L.LScan) -> Schema:
    sch = _schema_for(node.sources, node.fmt, node.options, _fingerprint(node.sources)).copy()
    if node.opt("hive") and node.sources:
        from polars_tpu_torch.io.scan_exec import hive_parts

        hs = node.opt("hive_schema")
        hs = dict(hs) if hs else None
        for k, v in hive_parts(node.sources[0], hs).items():
            if k in sch:
                continue
            if hs and k in hs:
                sch[k] = dt.parse_into_dtype(hs[k])
            elif isinstance(v, (bool, int)):
                sch[k] = dt.Int64()
            elif isinstance(v, float):
                sch[k] = dt.Float64()
            else:
                sch[k] = dt.String()
    return sch

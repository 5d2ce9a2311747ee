"""Arrow IPC / Feather read, scan and write (the port of
``polars_tpu/io/ipc.py``; reference: polars-arrow/src/io/ipc)."""

from __future__ import annotations

from typing import Any

from polars_tpu_torch.plan import logical as L


def scan_ipc(source: Any, *, n_rows: int | None = None, row_index_name: str | None = None, row_index_offset: int = 0,
             storage_options: Any = None, **kwargs: Any):
    from polars_tpu_torch.io.parquet import _expand_paths
    from polars_tpu_torch.lazyframe import LazyFrame

    node = L.LScan(
        sources=_expand_paths(source, storage_options=storage_options),
        fmt="ipc",
        options=(("storage_options", tuple(sorted(dict(storage_options).items())) if storage_options else ()),),
        n_rows=n_rows,
        row_index=(row_index_name, row_index_offset) if row_index_name else None,
    )
    return LazyFrame._from_node(node)


def read_ipc(source: Any, *, columns: Any = None, **kwargs: Any):
    lf = scan_ipc(source, **kwargs)
    if columns is not None:
        lf = lf.select(list(columns))
    return lf.collect()


def write_ipc(df, file: Any, *, compression: str = "zstd", **kwargs: Any) -> None:
    import pyarrow as pa

    table = df.to_arrow()
    comp = {"uncompressed": None, "lz4": "lz4", "zstd": "zstd"}.get(compression or "uncompressed", "zstd")
    with pa.ipc.new_file(file, table.schema, options=pa.ipc.IpcWriteOptions(compression=comp)) as w:
        w.write_table(table)


def write_ipc_stream(df, file: Any, *, compression: str | None = "uncompressed", **kwargs: Any) -> None:
    import pyarrow.ipc as pa_ipc

    table = df.to_arrow()
    with pa_ipc.new_stream(file, table.schema) as w:
        w.write_table(table)

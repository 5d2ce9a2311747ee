"""Parquet read, scan and write (the port of ``polars_tpu/io/parquet.py``;
reference: polars-parquet + polars-io's parquet module).

The host reads with Arrow C++'s Parquet reader (``io/scan_exec.py``); the
scan's projection, predicate and row limit map onto column selection,
statistics, bloom-filter and page-index pruning, as the reference's
scan-statistics pruning
(polars-plan/src/plans/optimizer/predicate_pushdown/join/predicate_pruning.rs).
"""

from __future__ import annotations

import glob as _glob
from typing import Any

from polars_tpu_torch.plan import logical as L


def _expand_paths(source: Any, suffix: str = "", storage_options: Any = None) -> tuple[str, ...]:
    """The files of ``source``: a path, a list of them, a directory (every
    file with ``suffix`` below it, the hive layout) or a glob."""
    import os

    if isinstance(source, (list, tuple)):
        out: list[str] = []
        for s in source:
            out.extend(_expand_paths(s, suffix, storage_options))
        return tuple(out)
    s = str(source)
    from polars_tpu_torch.io.cloud import expand_remote_paths, is_remote_path

    if is_remote_path(s) and not s.startswith("pyarrow-dataset://"):
        return expand_remote_paths(s, suffix, storage_options)
    if s.startswith("file://"):
        s = s[len("file://"):]
    if suffix and os.path.isdir(s):
        return tuple(sorted(_glob.glob(os.path.join(s, "**", f"*{suffix}"), recursive=True)))
    if any(ch in s for ch in "*?["):
        return tuple(sorted(_glob.glob(s, recursive=True)))
    return (s,)


def scan_parquet(
    source: Any,
    *,
    n_rows: int | None = None,
    row_index_name: str | None = None,
    row_index_offset: int = 0,
    parallel: str = "auto",
    rechunk: bool = False,
    low_memory: bool = False,
    cache: bool = True,
    storage_options: Any = None,
    hive_partitioning: bool | None = None,
    hive_schema: Any = None,
    **kwargs: Any,
):
    import os

    from polars_tpu_torch.lazyframe import LazyFrame

    is_dir = not isinstance(source, (list, tuple)) and os.path.isdir(str(source))
    sources = _expand_paths(source, suffix=".parquet", storage_options=storage_options)
    # polars semantics: hive partitioning defaults on for directory datasets
    hive = bool(hive_partitioning) if hive_partitioning is not None else is_dir
    options: tuple = ()
    if hive:
        options += (("hive", True),)
        if hive_schema is not None:
            options += (("hive_schema", tuple(dict(hive_schema).items())),)
    if storage_options:
        options += (("storage_options", tuple(sorted(dict(storage_options).items()))),)
    node = L.LScan(sources=sources, fmt="parquet", options=options, n_rows=n_rows,
                   row_index=(row_index_name, row_index_offset) if row_index_name else None)
    return LazyFrame._from_node(node)


def read_parquet(source: Any, *, columns: Any = None, n_rows: int | None = None, **kwargs: Any):
    lf = scan_parquet(source, n_rows=n_rows, **kwargs)
    if columns is not None:
        lf = lf.select(list(columns))
    return lf.collect()


def read_parquet_schema(source: Any):
    import pyarrow.parquet as pq

    from polars_tpu_torch.io._arrow import arrow_schema_to_schema

    return arrow_schema_to_schema(pq.read_schema(_expand_paths(source)[0]))


def write_parquet(
    df,
    file: Any,
    *,
    compression: str = "zstd",
    compression_level: int | None = None,
    statistics: bool | str = True,
    row_group_size: int | None = None,
    **kwargs: Any,
) -> None:
    import pyarrow.parquet as pq

    from polars_tpu_torch.io.cloud import is_remote_path, open_remote

    if kwargs.pop("partition_by", None) is not None:
        from polars_tpu_torch.later import ITEM_6

        raise NotImplementedError(f"write_parquet(partition_by=...) is not ported yet (port queue: item {ITEM_6})")
    if (isinstance(file, str) or hasattr(file, "__fspath__")) and is_remote_path(file):
        open_remote(file)
    extra = {k: v for k, v in kwargs.items()
             if k in ("write_page_index", "bloom_filter_options", "data_page_size", "use_dictionary",
                      "sorting_columns")}
    pq.write_table(df.to_arrow(), file, compression=compression if compression != "uncompressed" else "none",
                   compression_level=compression_level, row_group_size=row_group_size,
                   write_statistics=bool(statistics), **extra)

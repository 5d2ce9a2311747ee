"""Long-tail IO entry points (the port of ``polars_tpu/io/extra.py``;
reference: py-polars/src/polars/io/*).

The formats pyarrow reads (the IPC stream, Parquet metadata, pyarrow
datasets, Arrow C-stream producers) are read; those that need a library
the port does not use (Avro, Excel, ODS, the clipboard) raise the
``ImportError`` py-polars raises without its optional dependency.
"""

from __future__ import annotations

from typing import Any

from polars_tpu_torch.errors import ComputeError


def read_ipc_schema(source: Any) -> dict:
    """The schema of an IPC file, without reading its data."""
    import pyarrow.ipc as paipc

    from polars_tpu_torch.io._arrow import arrow_schema_to_schema

    with paipc.open_file(source) as r:
        return dict(arrow_schema_to_schema(r.schema).items())


def read_parquet_metadata(source: Any) -> dict:
    """A Parquet file's key/value metadata (but Arrow's own schema)."""
    import pyarrow.parquet as pq

    md = pq.read_metadata(source).metadata or {}
    return {(k.decode() if isinstance(k, bytes) else k): (v.decode() if isinstance(v, bytes) else v)
            for k, v in md.items() if k != b"ARROW:schema"}


def read_ipc_stream(source: Any, *, columns: Any = None, **kwargs: Any):
    """Read the Arrow IPC stream format (no footer)."""
    import pyarrow.ipc as paipc

    from polars_tpu_torch.io._arrow import arrow_to_df

    with paipc.open_stream(source) as r:
        df = arrow_to_df(r.read_all())
    return df.select(list(columns)) if columns is not None else df


# live pyarrow Dataset objects keyed by their scan token (the LScan source
# string), so that the plan stays hashable
_DATASETS: dict[str, Any] = {}


def get_dataset(token: str) -> Any:
    try:
        return _DATASETS[token]
    except KeyError:
        raise ComputeError(f"pyarrow dataset {token!r} is no longer registered") from None


def scan_pyarrow_dataset(source: Any, *, allow_pyarrow_filter: bool = True, **kwargs: Any):
    """A LazyFrame over a ``pyarrow.dataset.Dataset``: the pushed projection
    and the pushed ``column <op> literal`` conjuncts go to
    ``dataset.to_table(columns=, filter=)`` (``scan_exec._read_one_source``);
    the whole predicate still filters the rows it gives."""
    from polars_tpu_torch.lazyframe import LazyFrame
    from polars_tpu_torch.plan import logical as L

    token = f"pyarrow-dataset://{id(source)}"
    _DATASETS[token] = source
    return LazyFrame._from_node(L.LScan(sources=(token,), fmt="pyarrow_dataset",
                                        options=(("allow_pyarrow_filter", bool(allow_pyarrow_filter)),)))


def scan_arrow_c_stream(source: Any, **kwargs: Any):
    """A LazyFrame over any Arrow C-stream (``__arrow_c_stream__``)
    producer."""
    import pyarrow as pa

    from polars_tpu_torch.io._arrow import arrow_to_df

    return arrow_to_df(pa.table(source)).lazy()


def read_lines(source: Any) -> Any:
    """One String column named ``lines``."""
    from polars_tpu_torch.core.frame import DataFrame

    with open(source, "rb") as f:
        lines = f.read().decode("utf8").split("\n")
    if lines and lines[-1] == "":
        lines.pop()
    return DataFrame({"lines": lines})


def scan_lines(source: Any) -> Any:
    return read_lines(source).lazy()


def read_csv_batched(source: Any, *, batch_size: int = 50_000, **kwargs: Any):
    """The BatchedCsvReader analogue: ``next_batches(n)`` gives frames."""
    import pyarrow as pa
    import pyarrow.csv as pacsv

    from polars_tpu_torch.io._arrow import arrow_to_df

    reader = pacsv.open_csv(source, read_options=pacsv.ReadOptions(block_size=max(batch_size * 64, 1 << 16)))

    class BatchedCsvReader:
        def __init__(self) -> None:
            self._done = False

        def next_batches(self, n: int) -> list | None:
            if self._done:
                return None
            out = []
            for _ in range(n):
                try:
                    batch = reader.read_next_batch()
                except StopIteration:
                    self._done = True
                    break
                out.append(arrow_to_df(pa.Table.from_batches([batch])))
            return out or None

    return BatchedCsvReader()


def _missing_dep(fn: str, dep: str):
    raise ImportError(f"{fn} requires the {dep!r} package, which is not installed in this environment "
                      "(matches py-polars' optional-dependency behavior)")


def read_avro(source: Any, **kwargs: Any):
    try:
        import fastavro
    except ImportError:
        _missing_dep("read_avro", "fastavro")
    from polars_tpu_torch.core.frame import DataFrame

    with open(source, "rb") as f:
        return DataFrame(list(fastavro.reader(f)))


def read_excel(source: Any, **kwargs: Any):
    try:
        import openpyxl  # noqa: F401
    except ImportError:
        _missing_dep("read_excel", "openpyxl")
    import pandas as pd

    from polars_tpu_torch.core.frame import DataFrame

    return DataFrame(pd.read_excel(source, **kwargs))


def read_ods(source: Any, **kwargs: Any):
    try:
        import odf  # noqa: F401
    except ImportError:
        _missing_dep("read_ods", "odfpy")
    import pandas as pd

    from polars_tpu_torch.core.frame import DataFrame

    return DataFrame(pd.read_excel(source, engine="odf", **kwargs))


def read_clipboard(separator: str = "\t", **kwargs: Any):
    _missing_dep("read_clipboard", "a clipboard backend (headless environment)")

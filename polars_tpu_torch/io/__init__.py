"""IO: host-side readers and writers, each column copied once to the
frame's device (the port of ``polars_tpu/io/``; reference: polars-io +
polars-parquet).

The host reads with Arrow C++ (pyarrow), as the JAX package does; every
module imports pyarrow (and pandas) inside the functions that need them, so
``import polars_tpu_torch`` works where neither is installed and only a
scan or a writer raises ``ImportError`` there. Scan nodes take the
projection, the predicate and the row limit (``io/scan_exec.py``).
``read_database`` over ``sqlite3`` needs neither.
"""

from polars_tpu_torch.io.csv import read_csv, scan_csv
from polars_tpu_torch.io.database import read_database, read_database_uri
from polars_tpu_torch.io.delta import read_delta, scan_delta
from polars_tpu_torch.io.extra import (
    read_avro,
    read_clipboard,
    read_csv_batched,
    read_excel,
    read_ipc_schema,
    read_ipc_stream,
    read_lines,
    read_ods,
    read_parquet_metadata,
    scan_arrow_c_stream,
    scan_lines,
    scan_pyarrow_dataset,
)
from polars_tpu_torch.io.ipc import read_ipc, scan_ipc
from polars_tpu_torch.io.ndjson import read_json, read_ndjson, scan_ndjson
from polars_tpu_torch.io.parquet import read_parquet, read_parquet_schema, scan_parquet

__all__ = [
    "read_avro", "read_clipboard", "read_csv", "read_csv_batched", "read_database", "read_database_uri",
    "read_delta", "read_excel", "read_ipc", "read_ipc_schema", "read_ipc_stream", "read_json", "read_lines",
    "read_ndjson", "read_ods", "read_parquet", "read_parquet_metadata", "read_parquet_schema",
    "scan_arrow_c_stream", "scan_csv", "scan_delta", "scan_iceberg", "scan_ipc", "scan_lines", "scan_ndjson",
    "scan_parquet", "scan_pyarrow_dataset",
]


def scan_iceberg(source, *, snapshot_id=None, **kwargs):
    """Scan an Apache Iceberg table (needs ``pyiceberg`` for its Avro
    manifests; reference py-polars/src/polars/io/iceberg/)."""
    try:
        from pyiceberg.table import StaticTable
    except ImportError:
        raise ImportError("scan_iceberg requires the `pyiceberg` package (iceberg manifests are avro; no native "
                          "decoder is bundled)") from None
    from polars_tpu_torch.io._arrow import arrow_to_df

    tbl = StaticTable.from_metadata(str(source)) if isinstance(source, str) else source
    scan = tbl.scan(snapshot_id=snapshot_id) if snapshot_id else tbl.scan()
    return arrow_to_df(scan.to_arrow()).lazy()

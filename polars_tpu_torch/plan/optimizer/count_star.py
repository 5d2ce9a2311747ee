"""COUNT(*) without reading a column (the port of
``polars_tpu/plan/optimizer/count_star.py``; reference:
polars-plan/src/plans/optimizer/count_star.rs): ``select(pl.len())``
straight over an in-memory frame becomes a one-row frame of its height, and
over a Parquet or IPC scan without a predicate or a row limit, one of the
files' row count from their metadata (no page is read or decoded)."""

from __future__ import annotations

import numpy as np

from polars_tpu_torch import datatypes as dt
from polars_tpu_torch.plan import exprs as E
from polars_tpu_torch.plan import logical as L
from polars_tpu_torch.utils.tokens import obj_token


def _len_name(e: E.ENode) -> str | None:
    name = "len"
    while isinstance(e, E.EAlias):
        name = e.name
        e = e.input
    return name if isinstance(e, E.ELen) else None


def _file_count(scan: L.LScan) -> int | None:
    """The rows of a scan's files from their metadata, or None where that
    cannot answer (a predicate, a row limit, another format, an unreadable
    file: the scan then runs)."""
    if scan.predicate is not None or scan.n_rows is not None or scan.fmt not in ("parquet", "ipc"):
        return None
    total = 0
    try:
        for path in scan.sources:
            if scan.fmt == "parquet":
                import pyarrow.parquet as pq

                total += pq.ParquetFile(path).metadata.num_rows
            else:
                import pyarrow as pa

                with pa.memory_map(path) as src:
                    reader = pa.ipc.open_file(src)
                    total += sum(reader.get_batch(i).num_rows for i in range(reader.num_record_batches))
    except Exception:  # noqa: BLE001 (the scan itself reports what is wrong with the file)
        return None
    return total


def count_star(node: L.LNode) -> L.LNode:
    inputs = node.inputs()
    new_inputs = tuple(count_star(i) for i in inputs)
    if any(a is not b for a, b in zip(new_inputs, inputs)):
        node = L.rebuild(node, new_inputs)
    if not (isinstance(node, L.LSelect) and len(node.expressions) == 1
            and isinstance(node.input, (L.LDataFrameScan, L.LScan))):
        return node
    name = _len_name(node.expressions[0])
    if name is None:
        return node
    from polars_tpu_torch.config import resolve_device
    from polars_tpu_torch.core.column import Column
    from polars_tpu_torch.core.frame import DataFrame

    if isinstance(node.input, L.LScan):
        n, device = _file_count(node.input), resolve_device(None)
        if n is None:
            return node
    else:
        n, device = node.input.df.height, node.input.df.device
    col = Column.from_values(name, np.asarray([n], np.uint32), dt.UInt32(), device=device)
    df = DataFrame._from_columns([col], 1, device=device)
    return L.LDataFrameScan(df=df, ident=obj_token(df))

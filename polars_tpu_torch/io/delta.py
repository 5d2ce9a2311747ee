"""Delta Lake scan: a native transaction-log reader (the port of
``polars_tpu/io/delta.py``).

Reference surface: py-polars scan_delta/read_delta
(py-polars/src/polars/io/delta.py), which delegates to the
`deltalake` package. A Delta table is just parquet files plus a JSON
transaction log (`_delta_log/NNNNNNN.json`, optionally compacted into
checkpoint parquet files), so this module reads the log natively — pyarrow
covers the checkpoint — and lowers the active file set onto the engine's
multi-file parquet scan. Partition columns come from the log's
`partitionValues`, typed via the table's schemaString.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any

from polars_tpu_torch import datatypes as dt
from polars_tpu_torch.errors import ComputeError

_COMMIT_RE = re.compile(r"^(\d{20})\.json$")
_CHECKPOINT_RE = re.compile(r"^(\d{20})\.checkpoint(?:\.\d+\.\d+)?\.parquet$")

# Spark schemaString primitive -> dtype (delta PROTOCOL.md primitive types)
_DELTA_TYPES = {
    "string": dt.String(),
    "long": dt.Int64(),
    "integer": dt.Int32(),
    "short": dt.Int16(),
    "byte": dt.Int8(),
    "float": dt.Float32(),
    "double": dt.Float64(),
    "boolean": dt.Boolean(),
    "date": dt.Date(),
    "timestamp": dt.Datetime("us"),
    "timestamp_ntz": dt.Datetime("us"),
    "binary": dt.Binary(),
}


def _parse_schema_string(schema_string: str) -> dict[str, dt.DataType]:
    out: dict[str, dt.DataType] = {}
    try:
        fields = json.loads(schema_string).get("fields", [])
    except Exception:  # noqa: BLE001
        return out
    for f in fields:
        t = f.get("type")
        if isinstance(t, str) and t in _DELTA_TYPES:
            out[f["name"]] = _DELTA_TYPES[t]
        elif isinstance(t, str) and t.startswith("decimal"):
            m = re.match(r"decimal\((\d+),\s*(\d+)\)", t)
            if m:
                out[f["name"]] = dt.Decimal(int(m.group(1)), int(m.group(2)))
    return out


def _read_checkpoint(paths: list[str]) -> tuple[dict[str, dict], dict | None]:
    """Active files + metaData from checkpoint parquet part-files."""
    import pyarrow.parquet as pq

    active: dict[str, dict] = {}
    meta = None
    for p in paths:
        tbl = pq.read_table(p, columns=["add", "metaData"])
        for row in tbl.to_pylist():
            add = row.get("add")
            if add and add.get("path"):
                pv = add.get("partitionValues") or {}
                if not isinstance(pv, dict):  # arrow map type -> [(k, v), ...]
                    pv = dict(pv)
                active[add["path"]] = pv
            md = row.get("metaData")
            if md and md.get("schemaString"):
                meta = md
    return active, meta


def _delta_snapshot(table_path: str, version: int | None = None):
    """(active files {relpath: partitionValues}, metaData action) at a version."""
    log_dir = os.path.join(table_path, "_delta_log")
    if not os.path.isdir(log_dir):
        raise ComputeError(f"not a Delta table (no _delta_log): {table_path!r}")
    names = os.listdir(log_dir)
    commits = sorted(
        (int(m.group(1)), n) for n in names if (m := _COMMIT_RE.match(n))
    )
    checkpoints: dict[int, list[str]] = {}
    for n in names:
        m = _CHECKPOINT_RE.match(n)
        if m:
            checkpoints.setdefault(int(m.group(1)), []).append(os.path.join(log_dir, n))

    cp_version = -1
    usable = [v for v in checkpoints if version is None or v <= version]
    active: dict[str, dict] = {}
    meta: dict | None = None
    if usable:
        cp_version = max(usable)
        active, meta = _read_checkpoint(sorted(checkpoints[cp_version]))

    applied = cp_version
    for v, name in commits:
        if v <= cp_version or (version is not None and v > version):
            continue
        applied = max(applied, v)
        with open(os.path.join(log_dir, name), encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                action = json.loads(line)
                if "add" in action:
                    a = action["add"]
                    active[a["path"]] = a.get("partitionValues") or {}
                elif "remove" in action:
                    active.pop(action["remove"]["path"], None)
                elif "metaData" in action:
                    meta = action["metaData"]
    if version is not None and applied < version:
        raise ComputeError(f"Delta table version {version} not found (have {applied})")
    return active, meta


def _partition_lit(raw: str | None, dtype: dt.DataType):
    import datetime as _dt

    if raw is None or raw == "__HIVE_DEFAULT_PARTITION__":
        return None
    if isinstance(dtype, (dt.Int8, dt.Int16, dt.Int32, dt.Int64)):
        return int(raw)
    if isinstance(dtype, (dt.Float32, dt.Float64)):
        return float(raw)
    if isinstance(dtype, dt.Boolean):
        return raw.lower() == "true"
    if isinstance(dtype, dt.Date):
        return _dt.date.fromisoformat(raw)
    return raw


def scan_delta(source: Any, *, version: int | None = None, **kwargs: Any):
    """Lazily scan a local Delta Lake table (optionally time-travelled to
    ``version``). The active file set is resolved from the transaction log at
    plan-build time; partition columns materialize as typed literals per file
    group, pruned like any other predicate."""
    import polars_tpu_torch as pl

    table_path = str(source)
    active, meta = _delta_snapshot(table_path, version)
    if meta is None:
        raise ComputeError(f"Delta log has no metaData action: {table_path!r}")
    schema_types = _parse_schema_string(meta.get("schemaString", "{}"))
    part_cols = list(meta.get("partitionColumns") or [])

    if not active:
        empty = {n: pl.Series(n, [], dtype=t) for n, t in schema_types.items()}
        return pl.DataFrame(empty).lazy()

    if not part_cols:
        files = sorted(os.path.join(table_path, p) for p in active)
        return pl.scan_parquet(files, hive_partitioning=False)

    # group files by partition tuple; each group scans with literal columns
    groups: dict[tuple, list[str]] = {}
    for relpath, pvals in active.items():
        key = tuple(pvals.get(c) for c in part_cols)
        groups.setdefault(key, []).append(os.path.join(table_path, relpath))
    frames = []
    for key, files in sorted(groups.items(), key=lambda kv: tuple(map(str, kv[0]))):
        lf = pl.scan_parquet(sorted(files), hive_partitioning=False)
        lits = []
        for c, raw in zip(part_cols, key):
            d = schema_types.get(c, dt.String())
            lits.append(pl.lit(_partition_lit(raw, d), dtype=d).alias(c))
        frames.append(lf.with_columns(*lits))
    from polars_tpu_torch.functions.eager import concat

    return concat(frames, how="vertical_relaxed")


def read_delta(source: Any, *, version: int | None = None, **kwargs: Any):
    return scan_delta(source, version=version, **kwargs).collect()

"""LScan execution: host read, then one copy per column to the frame's
device (the port of ``polars_tpu/io/scan_exec.py``).

The MultiScan analogue (polars-stream/src/nodes/io_sources/multi_scan/):
several files are read by a thread pool and taken in order; the projection
and the row limit go into the Arrow readers; the pushed predicate's
``column <op> literal`` conjuncts skip hive partitions whose values
contradict them (the file is never opened), Parquet row groups whose
statistics or bloom filters rule them out, and pages whose column index
does (``io/parquet_index.py``); a pyarrow dataset takes them as its filter.
Pruning only has to be sound: the whole predicate filters the decoded rows
again on the device (a segment over the scanned frame).

pyarrow is imported inside each function that reads: the package imports
without it, and a scan without it raises ``ImportError``.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from polars_tpu_torch import datatypes as dt
from polars_tpu_torch.core.frame import DataFrame
from polars_tpu_torch.errors import ComputeError
from polars_tpu_torch.plan import exprs as E
from polars_tpu_torch.plan import logical as L
from polars_tpu_torch.utils.tokens import obj_token


def _read_csv_arrow(path: Any, options: dict, n_rows: int | None = None):
    import pyarrow.csv as pacsv

    null_values = options.get("null_values")
    parse_opts = pacsv.ParseOptions(delimiter=options.get("separator", ","),
                                    quote_char=options.get("quote_char") or False)
    # an empty field is null, as in Polars (polars_tpu reads the text "null"
    # as null too)
    nv = [""]
    if null_values:
        nv = [null_values] if isinstance(null_values, str) else list(null_values)
    convert = pacsv.ConvertOptions(null_values=nv, strings_can_be_null=True)
    read_opts = pacsv.ReadOptions(skip_rows=options.get("skip_rows", 0),
                                  autogenerate_column_names=not options.get("has_header", True))
    src: Any = path
    comment = options.get("comment_prefix")
    if comment:
        # Arrow's CSV reader has no comment support: commented lines are
        # dropped on the host (reference: polars-io csv comment_prefix)
        import io as _io

        cb = comment.encode() if isinstance(comment, str) else comment
        with open(path, "rb") as f:
            lines = [ln for ln in f.readlines() if not ln.lstrip().startswith(cb)]
        src = _io.BytesIO(b"".join(lines))
    table = pacsv.read_csv(src, read_options=read_opts, parse_options=parse_opts, convert_options=convert)
    if not options.get("has_header", True):
        table = table.rename_columns([f"column_{i + 1}" for i in range(table.num_columns)])
    if n_rows is not None:
        table = table.slice(0, n_rows)
    return table


def _pred_to_parquet_filter(pred: E.ENode):
    """The pushed predicate's ``column <op> literal`` conjuncts, as (column,
    op, literal) triples (the others only filter the decoded rows)."""
    out = []
    flip = {"<": ">", "<=": ">=", ">": "<", ">=": "<=", "==": "=="}

    def visit(n: E.ENode) -> None:
        if isinstance(n, E.EBinary) and n.op == "&":
            visit(n.left)
            visit(n.right)
        elif isinstance(n, E.EBinary) and n.op in flip:
            a, b = n.left, n.right
            if isinstance(a, E.EColumn) and isinstance(b, E.ELiteral):
                out.append((a.name, n.op, b))
            elif isinstance(b, E.EColumn) and isinstance(a, E.ELiteral):
                out.append((b.name, flip[n.op], a))

    visit(pred)
    # a null or a list literal has no place in the statistics' order
    return [c for c in out if c[2].value is not None and not isinstance(c[2].value, tuple)]


def _conjuncts_to_dataset_filter(conjuncts):
    """Pushed (col, op, literal) conjuncts as one ``pyarrow.dataset`` filter
    expression (py-polars io/pyarrow_dataset pushdown analogue)."""
    import pyarrow.dataset as pds

    expr = None
    for col, op, lit in conjuncts:
        v = _literal_plain(lit)
        f = pds.field(col)
        e = {"<": f < v, "<=": f <= v, ">": f > v, ">=": f >= v, "==": f == v}[op]
        expr = e if expr is None else (expr & e)
    return expr


def _literal_plain(lit: E.ELiteral):
    v = lit.value
    if lit.dtype is not None:
        d = dt.parse_into_dtype(lit.dtype)
        if isinstance(d, dt.Date) and isinstance(v, str):
            return np.datetime64(v, "D").astype("datetime64[D]").astype("O")
        if isinstance(d, dt.Datetime) and isinstance(v, str):
            return np.datetime64(v, d.time_unit).astype("O")
    return v


def _comparable(a: Any, b: Any) -> bool:
    """Two Python values that compare by value: numbers with numbers, text
    with text, the same kind of other values."""
    import numbers

    return (isinstance(a, numbers.Number) and isinstance(b, numbers.Number)) or type(a) is type(b)


def _may_hold(op: str, lo: Any, hi: Any, v: Any) -> bool:
    """Whether ``x <op> v`` may hold for some ``x`` in [lo, hi]: True where
    the bounds do not compare with ``v`` (nothing is pruned then)."""
    if not (_comparable(lo, v) and _comparable(hi, v)):
        return True
    try:
        return {"<": lambda: lo < v, "<=": lambda: lo <= v, ">": lambda: hi > v, ">=": lambda: hi >= v,
                "==": lambda: lo <= v <= hi}[op]()
    except TypeError:  # naive against aware datetimes
        return True


def _prune_row_groups(pf, conjuncts) -> list[int]:
    """The row groups whose statistics do not rule out a conjunct
    (reference: parquet_metadata_prune.rs / predicate pruning)."""
    md = pf.metadata
    keep = []
    name_to_idx = {md.schema.column(i).name: i for i in range(md.num_columns)}
    for rg in range(md.num_row_groups):
        rgm = md.row_group(rg)
        ok = True
        for col, op, lit in conjuncts:
            ci = name_to_idx.get(col)
            if ci is None:
                continue
            stats = rgm.column(ci).statistics
            if stats is None or not stats.has_min_max:
                continue
            ok = _may_hold(op, stats.min, stats.max, _literal_plain(lit))
            if not ok:
                break
        if ok:
            keep.append(rg)
    return keep


# ---------------------------------------------------------------------------
# hive partitioning (reference: polars-io/src/hive.rs)
# ---------------------------------------------------------------------------


def hive_parts(path: str, hive_schema: dict | None = None) -> dict:
    """Parse ``key=value`` directory components of ``path`` into typed
    partition values. Types follow ``hive_schema`` when given, else polars'
    inference (int64 if all-digit, float64 if float-like, else string)."""
    import os
    import urllib.parse

    out: dict = {}
    for comp in os.path.dirname(path).split(os.sep):
        if "=" not in comp:
            continue
        k, _, raw = comp.partition("=")
        raw = urllib.parse.unquote(raw)
        if hive_schema and k in hive_schema:
            d = dt.parse_into_dtype(hive_schema[k])
            out[k] = int(raw) if d.is_integer() else float(raw) if d.is_float() else raw
            continue
        if raw.lstrip("-").isdigit():
            out[k] = int(raw)
        else:
            try:
                out[k] = float(raw)
            except ValueError:
                out[k] = None if raw == "__HIVE_DEFAULT_PARTITION__" else raw
    return out


def _hive_schema_opt(node: L.LScan) -> dict | None:
    hs = node.opt("hive_schema")
    return dict(hs) if hs else None


def _hive_pruned(parts: dict, conjuncts) -> bool:
    """True when the file's partition values contradict a pushed conjunct:
    the file is never opened (reference: hive partition pruning). A value
    that does not compare with the literal (a number against text) prunes
    nothing."""
    for col, op, lit in conjuncts:
        if col not in parts:
            continue
        v = parts[col]
        if v is not None and not _may_hold(op, v, v, _literal_plain(lit)):
            return True
    return False


def _attach_hive(t, parts: dict, columns):
    """Append constant partition columns to an arrow table (post-read)."""
    import pyarrow as pa

    for k, v in parts.items():
        if columns is not None and k not in columns:
            continue
        if k in t.column_names:
            continue
        t = t.append_column(k, pa.array([v] * t.num_rows))
    return t


SCAN_WORKERS = 4  # files read at once by a multi-file scan


# per-process IO metrics (reset with reset_scan_metrics(); the test hook for
# bloom/page pruning and the `rows read` counter — reference:
# polars-io/src/metrics.rs)
_SCAN_METRICS: dict = {
    "row_groups_total": 0,
    "row_groups_kept": 0,
    "bloom_skipped_row_groups": 0,
    "rows_read": 0,
    "rows_page_pruned": 0,
}


def scan_metrics() -> dict:
    return dict(_SCAN_METRICS)


def reset_scan_metrics() -> None:
    for k in _SCAN_METRICS:
        _SCAN_METRICS[k] = 0


def _slice_page_ranges(t, pf, rgs: list[int], row_ranges: dict):
    """Narrow a read row-group concatenation to the page row ranges the
    column index could not rule out (the exact filter still runs on the
    device)."""
    import pyarrow as pa

    pieces = []
    offset = 0
    pruned = 0
    for rg in rgs:
        n = pf.metadata.row_group(rg).num_rows
        rr = row_ranges.get(rg)
        if rr is None:
            pieces.append(t.slice(offset, n))
        else:
            for s, e in rr:
                pieces.append(t.slice(offset + s, e - s))
            pruned += n - sum(e - s for s, e in rr)
        offset += n
    _SCAN_METRICS["rows_page_pruned"] += pruned
    return pa.concat_tables(pieces) if pieces else t.slice(0, 0)


def _parquet_row_groups(node: L.LScan, path: str, pf, conjuncts, *, count: bool) -> tuple[list[int], dict | None]:
    """The row groups of ``pf`` that the conjuncts do not rule out, and the
    page row ranges of each (None: every row of the kept groups)."""
    rgs = list(range(pf.metadata.num_row_groups))
    if not conjuncts:
        return rgs, None
    if count:
        _SCAN_METRICS["row_groups_total"] += pf.metadata.num_row_groups
    rgs = _prune_row_groups(pf, conjuncts)
    row_ranges = None
    try:
        from polars_tpu_torch.io.parquet_index import refine_pruning

        rgs, row_ranges = refine_pruning(path, pf, rgs, conjuncts, _SCAN_METRICS)
    except Exception:  # noqa: BLE001 (index pruning is best-effort; the filter still runs)
        row_ranges = None
    if count:
        _SCAN_METRICS["row_groups_kept"] += len(rgs)
    return rgs, row_ranges


def _read_one_source(node: L.LScan, path: str, columns, conjuncts, hive_sch):
    """Read one file -> arrow table (None when fully pruned). Thread-safe:
    Arrow C++ releases the GIL, so a pool overlaps file reads."""
    parts = hive_parts(path, hive_sch) if node.opt("hive") else {}
    if parts and conjuncts and _hive_pruned(parts, conjuncts):
        return None
    file_cols = [c for c in columns if c not in parts] if columns is not None else None
    if node.fmt == "parquet":
        import pyarrow.parquet as pq

        pf = pq.ParquetFile(path)
        rgs, row_ranges = _parquet_row_groups(node, path, pf, conjuncts, count=True)
        if not rgs:
            return None
        t = pf.read_row_groups(rgs, columns=file_cols)
        if row_ranges:
            t = _slice_page_ranges(t, pf, rgs, row_ranges)
    elif node.fmt == "csv":
        t = _read_csv_arrow(path, dict(node.options))
        if file_cols is not None:
            t = t.select([c for c in file_cols if c in t.column_names])
    elif node.fmt == "ipc":
        import pyarrow as pa

        with open(path, "rb") as src:
            try:
                t = pa.ipc.open_file(src).read_all()
            except pa.lib.ArrowInvalid:
                src.seek(0)
                t = pa.ipc.open_stream(src).read_all()
        if file_cols is not None:
            t = t.select([c for c in file_cols if c in t.column_names])
    elif node.fmt == "ndjson":
        import pyarrow.json as pj

        t = pj.read_json(path)
        if file_cols is not None:
            t = t.select([c for c in file_cols if c in t.column_names])
    elif node.fmt == "pyarrow_dataset":
        from polars_tpu_torch.io.extra import get_dataset

        filt = None
        if conjuncts and node.opt("allow_pyarrow_filter", True):
            filt = _conjuncts_to_dataset_filter(conjuncts)
        t = get_dataset(path).to_table(columns=file_cols, filter=filt)
    else:
        raise ComputeError(f"unknown scan format {node.fmt!r}")
    if parts:
        t = _attach_hive(t, parts, columns)
    _SCAN_METRICS["rows_read"] += t.num_rows
    return t


def _scan_setup(node: L.LScan):
    """(columns to read or None, the conjuncts that prune, the hive schema).
    A row index numbers, and ``n_rows`` counts, the files' rows before the
    predicate, as in Polars: such a scan prunes nothing (``polars_tpu``
    prunes first, and numbers and counts the rows that are left)."""
    columns = list(node.projection) if node.projection is not None else None
    prunes = node.predicate is not None and node.row_index is None and node.n_rows is None
    conjuncts = _pred_to_parquet_filter(node.predicate) if prunes else []
    return columns, conjuncts, _hive_schema_opt(node)


def execute_scan(node: L.LScan) -> DataFrame:
    """The scan's frame on the default device: the files read (several at
    once), cut to ``n_rows``, numbered by ``row_index``, then filtered by
    the whole pushed predicate."""
    from polars_tpu_torch.io._arrow import arrow_to_df

    columns, conjuncts, hive_sch = _scan_setup(node)
    tables = []
    remaining = node.n_rows

    def take(t) -> bool:
        """Keep ``t`` (cut to what the limit leaves); False once it is met."""
        nonlocal remaining
        if t is not None:
            if remaining is not None:
                t = t.slice(0, remaining)
                remaining -= t.num_rows
            tables.append(t)
        return remaining is None or remaining > 0

    if len(node.sources) > 1:
        # multi-file: overlap host reads across a thread pool; results are
        # consumed in order (reference: multi_scan reader pre-init + prefetch)
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=SCAN_WORKERS) as pool:
            for t in pool.map(lambda p: _read_one_source(node, p, columns, conjuncts, hive_sch), node.sources):
                if not take(t):
                    break
    else:
        for path in node.sources:
            if (remaining is not None and remaining <= 0) or not take(
                    _read_one_source(node, path, columns, conjuncts, hive_sch)):
                break

    if not tables:
        from polars_tpu_torch.plan.schema_resolve import node_schema

        return DataFrame(None, node_schema(node))
    import pyarrow as pa

    table = pa.concat_tables(tables, promote_options="permissive") if len(tables) > 1 else tables[0]
    overrides = dict(dict(node.options).get("schema_overrides", ())) if node.fmt == "csv" else {}
    df = arrow_to_df(table, overrides)
    df, _ = _apply_scan_extras(node, df, node.row_index[1] if node.row_index is not None else 0)
    return df


def _prefetched(gen, depth: int = 2):
    """Run ``gen`` in a producer thread, handing items through a bounded
    queue: the host read and decode and the device copy of batch N+1
    overlap the consumer's compute on batch N (the reference's
    double-buffered morsel prefetch, multi_scan/mod.rs:31-60)."""
    import queue
    import threading

    q: queue.Queue = queue.Queue(maxsize=depth)
    end = object()

    def produce():
        try:
            for item in gen:
                q.put(item)
            q.put(end)
        except BaseException as e:  # noqa: BLE001 (handed to the consumer)
            q.put(e)

    threading.Thread(target=produce, daemon=True, name="polars-tpu-torch-scan-prefetch").start()
    while True:
        item = q.get()
        if item is end:
            return
        if isinstance(item, BaseException):
            raise item
        yield item


def iter_scan_batches(node: L.LScan, batch_rows: int):
    """Frames of at most ``batch_rows`` rows from a scan, one batch at a
    time, read, decoded and copied to the device on a background thread
    (MultiScan's morsel stream); a ``row_index`` runs on across batches."""
    return _prefetched(_iter_scan_batches_inner(node, batch_rows))


def _iter_scan_batches_inner(node: L.LScan, batch_rows: int):
    from polars_tpu_torch.io._arrow import arrow_to_df

    columns, conjuncts, hive_sch = _scan_setup(node)
    remaining = node.n_rows
    row_at = node.row_index[1] if node.row_index is not None else 0
    for path in node.sources:
        if remaining is not None and remaining <= 0:
            return
        parts = hive_parts(path, hive_sch) if node.opt("hive") else {}
        if parts and conjuncts and _hive_pruned(parts, conjuncts):
            continue
        if node.fmt == "parquet":
            import pyarrow as pa
            import pyarrow.parquet as pq

            file_cols = [c for c in columns if c not in parts] if columns is not None else None
            pf = pq.ParquetFile(path)
            rgs, _ = _parquet_row_groups(node, path, pf, conjuncts, count=False)
            if not rgs:
                continue
            for batch in pf.iter_batches(batch_size=batch_rows, row_groups=rgs, columns=file_cols):
                t = pa.Table.from_batches([batch])
                if remaining is not None:
                    t = t.slice(0, remaining)
                    remaining -= t.num_rows
                if parts:
                    t = _attach_hive(t, parts, columns)
                df, row_at = _apply_scan_extras(node, arrow_to_df(t, {}), row_at)
                yield df
                if remaining is not None and remaining <= 0:
                    return
        else:
            sub = L.LScan(sources=(path,), fmt=node.fmt, options=node.options, projection=node.projection,
                          predicate=None, n_rows=remaining, row_index=None)
            df = execute_scan(sub)
            for start in range(0, df.height, batch_rows):
                b, row_at = _apply_scan_extras(node, df.slice(start, batch_rows), row_at)
                yield b
            if remaining is not None:
                remaining -= df.height


def _apply_scan_extras(node: L.LScan, df: DataFrame, row_at: int) -> tuple[DataFrame, int]:
    """The row index (from ``row_at``, running across batches) before the
    rest, then the whole pushed predicate as a filter over the frame (one
    segment on its device); the next batch's ``row_at``."""
    if node.row_index is not None:
        from polars_tpu_torch.core.column import Column

        name, _ = node.row_index
        idx = Column.from_values(name, np.arange(row_at, row_at + df.height, dtype=np.uint32), dt.UInt32(),
                                 device=df.device)
        df = DataFrame._from_columns([idx, *df._columns], df.height, device=df.device)
    row_at += df.height
    if node.predicate is not None:
        from polars_tpu_torch.engine.run import execute_plan

        df = execute_plan(L.LFilter(L.LDataFrameScan(df=df, ident=obj_token(df)), node.predicate))
    return df, row_at

"""Database IO: DB-API2 query ingestion and ``DataFrame.write_database``
(the port of ``polars_tpu/io/database.py``; reference surface: py-polars
read_database / read_database_uri).

The core path is plain DB-API2 (cursor, description, fetchall), with the
fast paths of connections that give Arrow tables (ADBC ``fetch_arrow_table``,
turbodbc ``fetchallarrow``), and the standard library's ``sqlite3`` for
``sqlite://`` URIs, so a local database needs neither pyarrow nor pandas.
The rows become a frame on the default device, one copy per column.
"""

from __future__ import annotations

from typing import Any

from polars_tpu_torch.errors import ComputeError, InvalidOperationError


def _from_cursor(cursor) -> Any:
    """A frame of an executed DB-API2 cursor's result set."""
    from polars_tpu_torch.core.frame import DataFrame

    for meth in ("fetch_arrow_table", "fetchallarrow"):  # connections that give Arrow tables
        fn = getattr(cursor, meth, None)
        if fn is not None:
            from polars_tpu_torch.io._arrow import arrow_to_df

            return arrow_to_df(fn())
    desc = cursor.description
    if desc is None:
        raise ComputeError("query returned no result set")
    names = [d[0] for d in desc]
    rows = cursor.fetchall()
    return DataFrame({n: [r[i] for r in rows] for i, n in enumerate(names)})


def read_database(
    query: str,
    connection: Any,
    *,
    iter_batches: bool = False,
    batch_size: int | None = None,
    schema_overrides: Any = None,
    infer_schema_length: int | None = None,
    execute_options: dict | None = None,
) -> Any:
    """Run ``query`` over an open connection and return a DataFrame
    (DB-API2 connections such as sqlite3, psycopg or ADBC, and SQLAlchemy
    engines or connections)."""
    if iter_batches:
        raise InvalidOperationError("iter_batches is not supported yet")
    opts = execute_options or {}
    conn = connection
    if hasattr(conn, "raw_connection"):  # a SQLAlchemy Engine
        conn = conn.raw_connection()
    elif type(conn).__module__.startswith("sqlalchemy") and hasattr(conn, "connection"):
        conn = getattr(conn.connection, "dbapi_connection", conn.connection)
    if not hasattr(conn, "cursor"):
        raise InvalidOperationError(f"unsupported connection type {type(connection).__name__!r}: "
                                    "expected a DB-API2 connection or SQLAlchemy engine")
    cursor = conn.cursor()
    try:
        args = opts.get("parameters")
        cursor.execute(query, *((args,) if args is not None else ()))
        df = _from_cursor(cursor)
    finally:
        try:
            cursor.close()
        except Exception:  # noqa: BLE001 (a connection whose cursor cannot close)
            pass
    if schema_overrides:
        from polars_tpu_torch.functions.lazy import col

        df = df.with_columns(*(col(n).cast(d) for n, d in dict(schema_overrides).items()))
    return df


def read_database_uri(
    query: str,
    uri: str,
    *,
    partition_on: str | None = None,
    partition_num: int | None = None,
    engine: str | None = None,
    schema_overrides: Any = None,
    execute_options: dict | None = None,
) -> Any:
    """Run ``query`` against a database URI: ``sqlite://`` through the
    standard library; other schemes need connectorx."""
    scheme = uri.split(":", 1)[0].lower()
    if scheme in ("sqlite", "sqlite3", "file"):
        import sqlite3

        path = uri.split("://", 1)[-1] if "://" in uri else uri.split(":", 1)[1]
        conn = sqlite3.connect(path)
        try:
            return read_database(query, conn, schema_overrides=schema_overrides, execute_options=execute_options)
        finally:
            conn.close()
    try:
        import connectorx
    except ImportError:
        raise ImportError(f"read_database_uri on {scheme!r} URIs requires `connectorx` or ADBC; "
                          "pass an open connection to read_database instead") from None
    from polars_tpu_torch.io._arrow import arrow_to_df

    return arrow_to_df(connectorx.read_sql(uri, query, return_type="arrow"))


_SQLITE_TYPES = {"Boolean": "INTEGER", "Float32": "REAL", "Float64": "REAL", "String": "TEXT",
                 "Categorical": "TEXT", "Enum": "TEXT", "Binary": "BLOB"}


def write_database(df, table_name: str, connection: Any, *, if_table_exists: str = "fail", **kwargs: Any) -> int:
    """Write ``df`` to ``table_name``: over a ``sqlite3`` connection with the
    standard library (dates and times as ISO text), over any other through
    pandas' ``to_sql``, as the JAX package does. Returns the rows
    written."""
    import sqlite3

    if if_table_exists not in ("fail", "append", "replace"):
        raise InvalidOperationError(f"if_table_exists must be 'fail', 'append' or 'replace', got {if_table_exists!r}")
    if not isinstance(connection, sqlite3.Connection):
        df.to_pandas().to_sql(table_name, connection, if_exists=if_table_exists, index=False)
        return df.height

    from polars_tpu_torch import datatypes as dt

    def sql_type(d) -> str:
        return "INTEGER" if isinstance(d, dt.IntegerType) else _SQLITE_TYPES.get(type(d).__name__, "TEXT")

    def value(v):
        return v.isoformat() if hasattr(v, "isoformat") else v

    quoted = '"' + table_name.replace('"', '""') + '"'
    cols = ", ".join('"' + n.replace('"', '""') + '" ' + sql_type(d) for n, d in df.schema.items())
    if if_table_exists == "replace":
        connection.execute(f"DROP TABLE IF EXISTS {quoted}")
    exists = "IF NOT EXISTS " if if_table_exists == "append" else ""
    connection.execute(f"CREATE TABLE {exists}{quoted} ({cols})")
    marks = ", ".join("?" * df.width)
    rows = [tuple(value(v) for v in row) for row in df.rows()]
    connection.executemany(f"INSERT INTO {quoted} VALUES ({marks})", rows)
    connection.commit()
    return df.height

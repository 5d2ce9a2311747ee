"""What the port does not have yet: every public method of the JAX
package's ``DataFrame``, ``LazyFrame``, ``Expr`` and ``Series`` and every
name of its package that the port lacks, by the ROADMAP item that brings
it (or "not to port"). Each stands in as a stub that raises
``NotImplementedError`` naming that item when it is called (a property
when it is read), so that a gap is an error that says where it is queued,
not an ``AttributeError``. ``tests/test_torch_eager.py`` holds this table
against the JAX package's names.
"""

from __future__ import annotations

from typing import Any

ITEM_5 = "5 (scans, IO and Arrow/pandas interchange)"
ITEM_6 = "6 (streaming, sinks and cancellation)"
ITEM_7 = "7 (SQL, serialization, profiling, plugins and extension types)"
NOT_TO_PORT = "not to port"

# class -> item -> names; names read as attributes in the JAX package
# (properties) are in PROPERTIES
LATER: dict[str, dict[str, tuple[str, ...]]] = {
    "DataFrame": {
        ITEM_5: ("to_arrow", "to_pandas", "write_avro", "write_clipboard", "write_csv", "write_database",
                 "write_delta", "write_excel", "write_iceberg", "write_ipc", "write_ipc_stream", "write_json",
                 "write_ndjson", "write_parquet"),
        ITEM_7: ("deserialize", "serialize", "sql"),
        NOT_TO_PORT: ("plot", "style", "to_jax"),
    },
    "LazyFrame": {
        ITEM_6: ("sink_batches", "sink_csv", "sink_delta", "sink_iceberg", "sink_ipc", "sink_ndjson",
                 "sink_parquet"),
        ITEM_7: ("deserialize", "profile", "serialize", "show_graph", "sql"),
        NOT_TO_PORT: ("execute", "remote", "with_context"),
    },
    "Expr": {
        ITEM_7: ("deserialize", "ext", "from_json", "meta", "meta_output_name", "register_plugin"),
    },
    "Series": {
        ITEM_5: ("to_arrow", "to_pandas"),
        ITEM_7: ("sql",),
        NOT_TO_PORT: ("plot", "to_jax"),
    },
    "package": {
        ITEM_5: ("Catalog", "CompatLevel", "CredentialProvider", "CredentialProviderAWS", "CredentialProviderAzure",
                 "CredentialProviderFunction", "CredentialProviderFunctionReturn", "CredentialProviderGCP",
                 "FileProviderArgs", "ScanCastOptions", "read_avro", "read_clipboard",
                 "read_csv", "read_csv_batched", "read_database", "read_database_uri", "read_delta", "read_excel",
                 "read_ipc", "read_ipc_schema", "read_ipc_stream", "read_json", "read_lines", "read_ndjson",
                 "read_ods", "read_parquet", "read_parquet_metadata", "read_parquet_schema", "scan_arrow_c_stream",
                 "scan_csv", "scan_delta", "scan_iceberg", "scan_ipc", "scan_lines", "scan_ndjson", "scan_parquet",
                 "scan_pyarrow_dataset"),
        ITEM_6: ("CancelToken", "PartitionBy"),
        ITEM_7: ("BaseExtension", "Extension", "SQLContext", "get_extension_type", "plugins",
                 "register_extension_type", "sql_expr", "unregister_extension_type"),
        NOT_TO_PORT: ("GPUEngine",),
    },
}
PROPERTIES = frozenset({"plot", "style", "meta", "ext"})


def _stub(owner: str, name: str, item: str):
    def refuse(*args: Any, **kwargs: Any):
        raise NotImplementedError(f"{owner}.{name} is not ported yet (port queue: item {item})"
                                  if item != NOT_TO_PORT else f"{owner}.{name} is not ported (not to port)")

    refuse.__name__ = name
    refuse.later_item = item
    return refuse


def install(owner: str, cls: type) -> None:
    """Stand a stub in for each of ``cls``'s names in the table that it does
    not define."""
    for item, names in LATER[owner].items():
        for name in names:
            if hasattr(cls, name):
                continue
            stub = _stub(owner, name, item)
            setattr(cls, name, property(stub) if name in PROPERTIES else stub)


def package_stubs() -> dict[str, Any]:
    """The package's stubs, by name."""
    return {name: _stub("polars_tpu_torch", name, item) for item, names in LATER["package"].items()
            for name in names}

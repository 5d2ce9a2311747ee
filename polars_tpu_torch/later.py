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

ITEM_6 = "6 (streaming, sinks and cancellation)"
ITEM_7 = "7 (SQL, serialization, profiling, plugins and extension types)"
NOT_TO_PORT = "not to port"

# class -> item -> names; names read as attributes in the JAX package
# (properties) are in PROPERTIES
LATER: dict[str, dict[str, tuple[str, ...]]] = {
    "DataFrame": {
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
        ITEM_7: ("sql",),
        NOT_TO_PORT: ("plot", "to_jax"),
    },
    "package": {
        ITEM_6: ("CancelToken", "PartitionBy"),
        ITEM_7: ("BaseExtension", "Extension", "SQLContext", "get_extension_type", "plugins",
                 "register_extension_type", "sql_expr", "unregister_extension_type"),
        NOT_TO_PORT: ("GPUEngine",),
    },
}
PROPERTIES = frozenset({"plot", "style", "meta", "ext"})
# package names that are modules in the JAX package: their attributes are stubs
MODULES = frozenset({"plugins"})


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


class _ModuleStub:
    """A module of the JAX package that the port lacks: calling it, or any
    function read from it, raises as a stub does."""

    def __init__(self, name: str, item: str) -> None:
        self.__name__ = name
        self.later_item = item
        self._call = _stub("polars_tpu_torch", name, item)

    def __call__(self, *args: Any, **kwargs: Any):
        return self._call(*args, **kwargs)

    def __getattr__(self, attr: str):
        if attr.startswith("__"):
            raise AttributeError(attr)
        return _stub(f"polars_tpu_torch.{self.__name__}", attr, self.later_item)


def package_stubs() -> dict[str, Any]:
    """The package's stubs, by name."""
    return {name: _ModuleStub(name, item) if name in MODULES else _stub("polars_tpu_torch", name, item)
            for item, names in LATER["package"].items() for name in names}

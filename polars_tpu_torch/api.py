"""Custom-namespace registration (the port of ``polars_tpu/api.py``;
reference: py-polars api.py, ``register_expr_namespace`` and friends). A
namespace is a Python class whose methods compose existing expressions, so
whatever it builds runs in the same fused segments as any other expression.

    @pl.api.register_expr_namespace("greetings")
    class Greetings:
        def __init__(self, expr): self._expr = expr
        def hello(self): return pl.lit("hello ") + self._expr

    pl.col("name").greetings.hello()
"""

from __future__ import annotations

from typing import Any, Callable


class _NamespaceDescriptor:
    def __init__(self, name: str, cls: type):
        self._name = name
        self._cls = cls

    def __get__(self, instance: Any, owner: type | None = None) -> Any:
        if instance is None:
            return self._cls
        return self._cls(instance)


def _register(host_cls: type, reserved: set[str]):
    def deco_factory(name: str) -> Callable[[type], type]:
        def deco(cls: type) -> type:
            # vars()-based lookup: __getattr__ pass-throughs (series_ns.py)
            # would make hasattr() claim every name exists
            existing = next(
                (vars(k)[name] for k in host_cls.__mro__ if name in vars(k)), None
            )
            if name in reserved or (
                existing is not None and not isinstance(existing, _NamespaceDescriptor)
            ):
                from polars_tpu_torch.errors import DuplicateError

                raise DuplicateError(
                    f"namespace {name!r} conflicts with an existing "
                    f"{host_cls.__name__} attribute"
                )
            setattr(host_cls, name, _NamespaceDescriptor(name, cls))
            return cls

        return deco

    return deco_factory


def register_expr_namespace(name: str) -> Callable[[type], type]:
    """Register a custom namespace on :class:`Expr` (py-polars
    pl.api.register_expr_namespace)."""
    from polars_tpu_torch.expr.expr import Expr

    return _register(Expr, {"list", "str", "dt", "cat", "struct", "name", "arr", "bin"})(name)


def register_series_namespace(name: str) -> Callable[[type], type]:
    from polars_tpu_torch.core.series import Series

    return _register(Series, {"list", "str", "dt", "cat", "struct", "arr", "bin"})(name)


def register_dataframe_namespace(name: str) -> Callable[[type], type]:
    from polars_tpu_torch.core.frame import DataFrame

    return _register(DataFrame, set())(name)


def register_lazyframe_namespace(name: str) -> Callable[[type], type]:
    from polars_tpu_torch.lazyframe import LazyFrame

    return _register(LazyFrame, set())(name)

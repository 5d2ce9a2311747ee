"""Series namespaces (the port of ``polars_tpu/core/series_ns.py``: ``str``,
``dt``, ``cat``, ``bin``, ``list``, ``arr`` and ``struct``): each method runs the ``Expr`` namespace's
method over a one-column frame."""

from __future__ import annotations

from typing import Any


class _SeriesNamespace:
    _expr_ns: str = ""

    def __init__(self, series) -> None:
        self._s = series

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)

        def method(*args: Any, **kwargs: Any):
            ns = getattr(self._s._expr(), self._expr_ns)
            return self._s._select(getattr(ns, name)(*args, **kwargs))

        return method


class SeriesStringNamespace(_SeriesNamespace):
    _expr_ns = "str"


class SeriesDateTimeNamespace(_SeriesNamespace):
    _expr_ns = "dt"


class SeriesCatNamespace(_SeriesNamespace):
    _expr_ns = "cat"


class SeriesBinaryNamespace(_SeriesNamespace):
    _expr_ns = "bin"


class SeriesListNamespace(_SeriesNamespace):
    _expr_ns = "list"


class SeriesArrayNamespace(_SeriesNamespace):
    _expr_ns = "arr"


class SeriesStructNamespace(_SeriesNamespace):
    _expr_ns = "struct"

    @property
    def fields(self) -> list[str]:
        return [f.name for f in self._s.dtype.fields]

    def field(self, name: str):
        return self._s._select(self._s._expr().struct.field(name)).alias(name)

    def unnest(self):
        return self._s.to_frame().unnest(self._s.name)

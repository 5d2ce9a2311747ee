"""Eager GroupBy builder (the port of ``polars_tpu/groupby.py``, trimmed to
``agg``, ``len`` and the aggregate shortcuts): each is the lazy group-by
and a collect."""

from __future__ import annotations

from typing import Any

from polars_tpu_torch.core.frame import DataFrame


class GroupBy:
    __slots__ = ("_df", "_by", "_named_by", "_maintain_order")

    def __init__(self, df: DataFrame, by: tuple, named_by: dict | None = None, *, maintain_order: bool = False) -> None:
        self._df = df
        self._by = by
        self._named_by = named_by or {}
        self._maintain_order = maintain_order

    def _lazy(self):
        return self._df.lazy().group_by(*self._by, maintain_order=self._maintain_order, **self._named_by)

    def agg(self, *aggs: Any, **named_aggs: Any) -> DataFrame:
        return self._lazy().agg(*aggs, **named_aggs).collect()

    def len(self, name: str = "len") -> DataFrame:
        return self._lazy().len(name).collect()

    def quantile(self, quantile: float, interpolation: str = "nearest") -> DataFrame:
        return self._lazy()._agg_all("quantile", quantile=quantile, interpolation=interpolation).collect()

    def __getattr__(self, name: str):
        if name in ("sum", "mean", "min", "max", "median", "first", "last", "n_unique"):
            return lambda: getattr(self._lazy(), name)().collect()
        raise AttributeError(f"'GroupBy' object has no attribute {name!r}")

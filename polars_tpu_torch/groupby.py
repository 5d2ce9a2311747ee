"""Eager GroupBy builder (the port of ``polars_tpu/groupby.py``, trimmed to
``agg``)."""

from __future__ import annotations

from typing import Any

from polars_tpu_torch.core.frame import DataFrame


class GroupBy:
    __slots__ = ("_df", "_by", "_maintain_order")

    def __init__(self, df: DataFrame, by: tuple, *, maintain_order: bool = False) -> None:
        self._df = df
        self._by = by
        self._maintain_order = maintain_order

    def agg(self, *aggs: Any, **named_aggs: Any) -> DataFrame:
        return (
            self._df.lazy()
            .group_by(*self._by, maintain_order=self._maintain_order)
            .agg(*aggs, **named_aggs)
            .collect()
        )

"""Temporal expression namespace (the port of ``polars_tpu/expr/datetime.py``,
trimmed to the calendar fields of a Date; ``engine/fn_temporal.py``
evaluates them). Time-of-day fields, truncation, offsets and time zones
need Datetime columns and are not ported yet."""

from __future__ import annotations

from typing import TYPE_CHECKING

if TYPE_CHECKING:
    from polars_tpu_torch.expr.expr import Expr


class ExprDateTimeNamespace:
    __slots__ = ("_expr",)

    def __init__(self, expr: Expr) -> None:
        self._expr = expr

    def _fn(self, name: str) -> Expr:
        return self._expr._fn(f"dt.{name}")

    def year(self) -> Expr:
        return self._fn("year")

    def quarter(self) -> Expr:
        return self._fn("quarter")

    def month(self) -> Expr:
        return self._fn("month")

    def week(self) -> Expr:
        return self._fn("week")

    def weekday(self) -> Expr:
        return self._fn("weekday")

    def day(self) -> Expr:
        return self._fn("day")

    def ordinal_day(self) -> Expr:
        return self._fn("ordinal_day")

    def iso_year(self) -> Expr:
        return self._fn("iso_year")

    def leap_year(self) -> Expr:
        return self._fn("leap_year")

    def is_leap_year(self) -> Expr:
        return self._fn("leap_year")

    def days_in_month(self) -> Expr:
        return self._fn("days_in_month")

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        raise NotImplementedError(f"dt.{name} is not ported yet (port queue: temporal breadth and asof/range joins)")

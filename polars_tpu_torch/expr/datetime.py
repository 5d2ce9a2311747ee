"""Temporal expression namespace (the port of ``polars_tpu/expr/datetime.py``;
``engine/fn_temporal.py`` evaluates it, and ``engine/hostops.py`` formats
``to_string``/``strftime`` on the host)."""

from __future__ import annotations

from typing import TYPE_CHECKING, Any

from polars_tpu_torch.plan import exprs as E

if TYPE_CHECKING:
    from polars_tpu_torch.expr.expr import Expr


class ExprDateTimeNamespace:
    __slots__ = ("_expr",)

    def __init__(self, expr: Expr) -> None:
        self._expr = expr

    def _fn(self, name: str, *inputs: Any, **options: Any) -> Expr:
        return self._expr._fn(f"dt.{name}", *inputs, **options)

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

    def hour(self) -> Expr:
        return self._fn("hour")

    def minute(self) -> Expr:
        return self._fn("minute")

    def second(self, *, fractional: bool = False) -> Expr:
        return self._fn("second", fractional=fractional)

    def millisecond(self) -> Expr:
        return self._fn("millisecond")

    def microsecond(self) -> Expr:
        return self._fn("microsecond")

    def nanosecond(self) -> Expr:
        return self._fn("nanosecond")

    def iso_year(self) -> Expr:
        return self._fn("iso_year")

    def leap_year(self) -> Expr:
        return self._fn("leap_year")

    def is_leap_year(self) -> Expr:
        return self._fn("leap_year")

    def date(self) -> Expr:
        return self._fn("date")

    def time(self) -> Expr:
        return self._fn("time")

    def datetime(self) -> Expr:
        return self._fn("datetime")

    def truncate(self, every: str) -> Expr:
        return self._fn("truncate", every=every)

    def round(self, every: str) -> Expr:
        return self._fn("dt_round", every=every)

    def offset_by(self, by: str) -> Expr:
        return self._fn("offset_by", by=by)

    def month_start(self) -> Expr:
        return self._fn("month_start")

    def month_end(self) -> Expr:
        return self._fn("month_end")

    def days_in_month(self) -> Expr:
        return self._fn("days_in_month")

    def timestamp(self, time_unit: str = "us") -> Expr:
        return self._fn("timestamp", time_unit=time_unit)

    def epoch(self, time_unit: str = "us") -> Expr:
        return self._fn("timestamp", time_unit=time_unit)

    def with_time_unit(self, time_unit: str) -> Expr:
        return self._fn("with_time_unit", time_unit=time_unit)

    def cast_time_unit(self, time_unit: str) -> Expr:
        return self._fn("cast_time_unit", time_unit=time_unit)

    def total_days(self) -> Expr:
        return self._fn("total", unit="d")

    def total_hours(self) -> Expr:
        return self._fn("total", unit="h")

    def total_minutes(self) -> Expr:
        return self._fn("total", unit="m")

    def total_seconds(self) -> Expr:
        return self._fn("total", unit="s")

    def total_milliseconds(self) -> Expr:
        return self._fn("total", unit="ms")

    def total_microseconds(self) -> Expr:
        return self._fn("total", unit="us")

    def total_nanoseconds(self) -> Expr:
        return self._fn("total", unit="ns")

    def to_string(self, format: str | None = None) -> Expr:
        """Each value as text in chrono's ``strftime`` format (``None``: the
        value as Python prints it)."""
        return self._fn("to_string", format=format)

    def strftime(self, format: str) -> Expr:
        return self._fn("to_string", format=format)

    def replace_time_zone(self, time_zone: str | None, *, ambiguous: Any = "raise",
                          non_existent: str = "raise") -> Expr:
        """``ambiguous``: ``earliest``, ``latest``, ``null`` or ``raise``, or
        an expression that gives one of them per row."""
        if not isinstance(ambiguous, str):
            return self._fn("replace_time_zone", ambiguous, time_zone=time_zone, ambiguous="expression",
                            non_existent=non_existent)
        return self._fn("replace_time_zone", time_zone=time_zone, ambiguous=ambiguous, non_existent=non_existent)

    def convert_time_zone(self, time_zone: str) -> Expr:
        return self._fn("convert_time_zone", time_zone=time_zone)

    def base_utc_offset(self) -> Expr:
        return self._fn("base_utc_offset")

    def dst_offset(self) -> Expr:
        return self._fn("dst_offset")

    def century(self) -> Expr:
        return self._fn("century")

    def millennium(self) -> Expr:
        return self._fn("millennium")

    def combine(self, time: Any, time_unit: str = "us") -> Expr:
        import datetime as _pydt

        if isinstance(time, _pydt.time):
            ns = (
                time.hour * 3_600_000_000_000
                + time.minute * 60_000_000_000
                + time.second * 1_000_000_000
                + time.microsecond * 1_000
            )
            return self._fn("combine", time_ns=ns, time_unit=time_unit)
        from polars_tpu_torch.expr.expr import Expr as _Expr

        node = time._node if isinstance(time, _Expr) else E.EColumn(str(time))
        return self._fn("combine", node, time_unit=time_unit)

    def replace(
        self,
        *,
        year: int | None = None,
        month: int | None = None,
        day: int | None = None,
        hour: int | None = None,
        minute: int | None = None,
        second: int | None = None,
        microsecond: int | None = None,
        ambiguous: str = "raise",
    ) -> Expr:
        return self._fn(
            "replace",
            year=year, month=month, day=day,
            hour=hour, minute=minute, second=second, microsecond=microsecond,
            ambiguous=ambiguous,
        )

    def add_business_days(
        self,
        n: int,
        week_mask: Any = (True, True, True, True, True, False, False),
        holidays: Any = (),
        roll: str = "raise",
    ) -> Expr:
        return self._fn(
            "add_business_days",
            n=int(n),
            week_mask=tuple(bool(b) for b in week_mask),
            holidays=_holidays_to_days(holidays),
            roll=roll,
        )

    def is_business_day(
        self,
        week_mask: Any = (True, True, True, True, True, False, False),
        holidays: Any = (),
    ) -> Expr:
        return self._fn(
            "is_business_day",
            week_mask=tuple(bool(b) for b in week_mask),
            holidays=_holidays_to_days(holidays),
        )


def _holidays_to_days(holidays: Any) -> tuple[int, ...]:
    import datetime as _pydt

    epoch = _pydt.date(1970, 1, 1)
    return tuple(
        (h - epoch).days if isinstance(h, _pydt.date) else int(h) for h in holidays
    )

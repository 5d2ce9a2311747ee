"""String expression namespace (the port of ``polars_tpu/expr/string.py``,
trimmed to ``starts_with``, ``ends_with``, ``contains``, ``slice`` and the
parsers ``to_date``, ``to_datetime``, ``to_time`` and ``strptime``). Ops
run once per dictionary value on the host and map through the codes on the
device (see ``engine/fn_strings.py``)."""

from __future__ import annotations

from typing import TYPE_CHECKING, Any

from polars_tpu_torch import datatypes as dt
from polars_tpu_torch.errors import InvalidOperationError

if TYPE_CHECKING:
    from polars_tpu_torch.expr.expr import Expr


class ExprStringNamespace:
    __slots__ = ("_expr",)

    def __init__(self, expr: Expr) -> None:
        self._expr = expr

    def _fn(self, name: str, *inputs: Any, **options: Any) -> Expr:
        return self._expr._fn(f"str.{name}", *inputs, **options)

    def starts_with(self, prefix: Any) -> Expr:
        if not isinstance(prefix, str) and prefix is not None:
            return self._fn("starts_with", prefix)  # expression right-hand side
        return self._fn("starts_with", prefix=prefix)

    def ends_with(self, suffix: Any) -> Expr:
        if not isinstance(suffix, str) and suffix is not None:
            return self._fn("ends_with", suffix)
        return self._fn("ends_with", suffix=suffix)

    def contains(self, pattern: str, *, literal: bool = False, strict: bool = True) -> Expr:
        return self._fn("contains", pattern=pattern, literal=literal, strict=strict)

    def slice(self, offset: int, length: int | None = None) -> Expr:
        return self._fn("slice", offset=offset, length=length)

    def to_date(self, format: str | None = None, *, strict: bool = True, exact: bool = True,
                cache: bool = True) -> Expr:
        return self._fn("to_date", format=format, strict=strict, exact=exact)

    def to_datetime(self, format: str | None = None, *, time_unit: str | None = None, time_zone: str | None = None,
                    strict: bool = True, exact: bool = True, cache: bool = True, ambiguous: str = "raise") -> Expr:
        return self._fn("to_datetime", format=format, time_unit=time_unit or "us", time_zone=time_zone,
                        strict=strict, exact=exact, ambiguous=ambiguous)

    def to_time(self, format: str | None = None, *, strict: bool = True, cache: bool = True) -> Expr:
        return self._fn("to_time", format=format, strict=strict)

    def strptime(self, dtype: Any, format: str | None = None, *, strict: bool = True, exact: bool = True,
                 cache: bool = True, ambiguous: str = "raise") -> Expr:
        """``to_date``, ``to_datetime`` (in the dtype's unit and zone) or
        ``to_time``, by ``dtype``."""
        dtype = dt.parse_into_dtype(dtype)
        if isinstance(dtype, dt.Date):
            return self.to_date(format, strict=strict, exact=exact)
        if isinstance(dtype, dt.Datetime):
            return self.to_datetime(format, time_unit=dtype.time_unit, time_zone=dtype.time_zone, strict=strict,
                                    exact=exact, ambiguous=ambiguous)
        if isinstance(dtype, dt.Time):
            return self.to_time(format, strict=strict)
        raise InvalidOperationError(f"strptime target must be temporal, got {dtype!r}")

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        raise NotImplementedError(f"str.{name} is not ported yet (port queue: expression breadth)")

"""Civil-calendar math on epoch days (the port of
``polars_tpu/kernels/temporal.py``; polars-time analogue).

Howard Hinnant's public-domain civil_from_days / days_from_civil recipes,
branch-free, as torch integer ops over int64; floor division goes through
``kernels/fastmath.py``. Proleptic Gregorian calendar, as Polars uses.
"""

from __future__ import annotations

import torch

from polars_tpu_torch.kernels.fastmath import floordiv_any, mod_any


def civil_from_days(days: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Epoch days -> (year int32, month int8, day int8)."""
    z = days.to(torch.int64) + 719468
    era = floordiv_any(torch.where(z >= 0, z, z - 146096), 146097)
    doe = z - era * 146097  # [0, 146096]
    yoe = floordiv_any(doe - floordiv_any(doe, 1460) + floordiv_any(doe, 36524) - floordiv_any(doe, 146096), 365)
    doy = doe - (365 * yoe + floordiv_any(yoe, 4) - floordiv_any(yoe, 100))
    mp = floordiv_any(5 * doy + 2, 153)
    d = doy - floordiv_any(153 * mp + 2, 5) + 1
    m = mp + torch.where(mp < 10, 3, -9)
    y = yoe + era * 400 + (m <= 2).to(torch.int64)
    return y.to(torch.int32), m.to(torch.int8), d.to(torch.int8)


def days_from_civil(y: torch.Tensor, m: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """(year, month, day) -> epoch days (int32)."""
    m = m.to(torch.int64)
    y = y.to(torch.int64) - (m <= 2).to(torch.int64)
    era = floordiv_any(torch.where(y >= 0, y, y - 399), 400)
    yoe = y - era * 400
    mp = m + torch.where(m > 2, -3, 9)
    doy = floordiv_any(153 * mp + 2, 5) + d.to(torch.int64) - 1
    doe = yoe * 365 + floordiv_any(yoe, 4) - floordiv_any(yoe, 100) + doy
    return (era * 146097 + doe - 719468).to(torch.int32)


def weekday_from_days(days: torch.Tensor) -> torch.Tensor:
    """ISO weekday, Monday 1 to Sunday 7 (1970-01-01 was a Thursday)."""
    return (mod_any(days.to(torch.int64) + 3, 7) + 1).to(torch.int8)


def _jan1(y: torch.Tensor) -> torch.Tensor:
    one = torch.ones_like(y, dtype=torch.int64)
    return days_from_civil(y, one, one).to(torch.int64)


def ordinal_day(days: torch.Tensor) -> torch.Tensor:
    """Day of the year, 1 to 366 (int16)."""
    y, _, _ = civil_from_days(days)
    return (days.to(torch.int64) - _jan1(y) + 1).to(torch.int16)


def is_leap_year(y: torch.Tensor) -> torch.Tensor:
    y = y.to(torch.int64)
    return (mod_any(y, 4) == 0) & ((mod_any(y, 100) != 0) | (mod_any(y, 400) == 0))


def _iso_thursday(days: torch.Tensor) -> torch.Tensor:
    """The Thursday of each day's ISO week: its year is the ISO year."""
    return days.to(torch.int64) - weekday_from_days(days).to(torch.int64) + 4


def iso_week(days: torch.Tensor) -> torch.Tensor:
    """ISO-8601 week number, 1 to 53 (int8)."""
    thursday = _iso_thursday(days)
    y, _, _ = civil_from_days(thursday)
    return (floordiv_any(thursday - _jan1(y), 7) + 1).to(torch.int8)


def iso_year(days: torch.Tensor) -> torch.Tensor:
    return civil_from_days(_iso_thursday(days))[0]


def days_in_month(y: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Days of month ``m`` (1 to 12) of year ``y`` (int8): 28 + (m + m // 8) % 2
    + 2 % m + 2 * (1 // m) gives the month lengths of a common year with no
    table to copy to the device."""
    m = m.to(torch.int64)
    base = 28 + mod_any(m + floordiv_any(m, 8), 2) + mod_any(torch.full_like(m, 2), m) + 2 * (m == 1).to(torch.int64)
    return torch.where((m == 2) & is_leap_year(y), 29, base).to(torch.int8)

"""Calendar arithmetic over DATE lanes (int32 days since 1970-01-01) and
TIMESTAMP lanes (int64 microseconds since the epoch).

Counterpart of spark_rapids_tpu/ops/datetime.py: the date fields, date
arithmetic (add_months, last_day, trunc) and the day and time of day of
an instant, for plan/datetime.py.  The engine keeps Spark's internal
representation, so every calendar field is integer arithmetic on the
lane's own device: the era decomposition of the proleptic Gregorian
calendar (400-year eras of 146,097 days), exact over the whole int32
day range, with int64 intermediates and int32 results.

Integer division must floor, because days before the epoch are
negative: on tensors `//` and `%` floor, as numpy's and jnp's do; never
`torch.div` with its default or `rounding_mode="trunc"`.  The era is
therefore a plain floor division.  The reference writes it with the
C++ truncating idiom (`z >= 0 ? z : z - 146096`) on top of jnp's
floor, which counts one era too few for many days before 0000-03-01
(day -719,468); the port follows the calendar there (numpy's
datetime64 is the tests' yardstick) and equals the reference on every
later day (README "Deviations").
"""
from __future__ import annotations

import torch

from ..runtime.capture import host_constant

#: days from 0000-03-01 (the era origin) to 1970-01-01
EPOCH_SHIFT = 719468


def civil_from_days(days: torch.Tensor):
    """(year, month, day) as int32 lanes from days since the epoch."""
    z = days.to(torch.int64) + EPOCH_SHIFT
    era = z // 146097
    doe = z - era * 146097                                   # [0, 146096]
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)          # [0, 365]
    mp = (5 * doy + 2) // 153                                # [0, 11]
    d = doy - (153 * mp + 2) // 5 + 1                        # [1, 31]
    m = mp + torch.where(mp < 10, 3, -9)                     # [1, 12]
    y = y + (m <= 2).to(torch.int64)
    return y.to(torch.int32), m.to(torch.int32), d.to(torch.int32)


def _days_from_civil64(y: torch.Tensor, m: torch.Tensor,
                       d: torch.Tensor) -> torch.Tensor:
    y = y.to(torch.int64) - (m <= 2).to(torch.int64)
    era = y // 400
    yoe = y - era * 400                                      # [0, 399]
    mp = (m.to(torch.int64) + 9) % 12                        # [0, 11]
    doy = (153 * mp + 2) // 5 + d.to(torch.int64) - 1        # [0, 365]
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - EPOCH_SHIFT


def days_from_civil(y: torch.Tensor, m: torch.Tensor,
                    d: torch.Tensor) -> torch.Tensor:
    """Days since the epoch (int32) from (year, month, day); the inverse
    of civil_from_days."""
    return _days_from_civil64(y, m, d).to(torch.int32)


def is_leap(y: torch.Tensor) -> torch.Tensor:
    return ((y % 4 == 0) & (y % 100 != 0)) | (y % 400 == 0)


def days_in_month(y: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    base = host_constant([0, 31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31],
                         m.device, torch.int32)
    d = base[torch.clamp(m, 0, 12).long()]
    return torch.where((m == 2) & is_leap(y), 29, d).to(torch.int32)


def _jan1(days: torch.Tensor) -> torch.Tensor:
    """int64 day of January 1st of each day's year."""
    y, _, _ = civil_from_days(days)
    one = torch.ones_like(y)
    return _days_from_civil64(y, one, one)


def day_of_year(days: torch.Tensor) -> torch.Tensor:
    return (days.to(torch.int64) - _jan1(days) + 1).to(torch.int32)


def day_of_week_sunday1(days: torch.Tensor) -> torch.Tensor:
    """Spark dayofweek(): 1 = Sunday ... 7 = Saturday (1970-01-01 was a
    Thursday)."""
    return ((days.to(torch.int64) + 4) % 7 + 1).to(torch.int32)


def weekday_monday0(days: torch.Tensor) -> torch.Tensor:
    """Spark weekday(): 0 = Monday ... 6 = Sunday."""
    return ((days.to(torch.int64) + 3) % 7).to(torch.int32)


def iso_week(days: torch.Tensor) -> torch.Tensor:
    """ISO-8601 week number (Spark weekofyear): the week of the nearest
    Thursday, counted from its year's first day.  The Thursday is
    computed in int64, so the int32 ends do not wrap (the reference's
    int32 sum wraps within three days of them)."""
    thursday = days.to(torch.int64) + 3 - weekday_monday0(days)
    return ((thursday - _jan1(thursday)) // 7 + 1).to(torch.int32)


def add_months(days: torch.Tensor, months: torch.Tensor) -> torch.Tensor:
    """Spark add_months: the day clamped to the target month's last day
    (int64 month arithmetic, floor division)."""
    y, m, d = civil_from_days(days)
    total = y.to(torch.int64) * 12 + (m.to(torch.int64) - 1) + \
        months.to(torch.int64)
    ny = total // 12
    nm = total - ny * 12 + 1
    nd = torch.minimum(d.to(torch.int64),
                       days_in_month(ny, nm.to(torch.int32)).to(torch.int64))
    return _days_from_civil64(ny, nm, nd).to(torch.int32)


def last_day(days: torch.Tensor) -> torch.Tensor:
    y, m, _ = civil_from_days(days)
    return days_from_civil(y, m, days_in_month(y, m))


#: trunc units: year, quarter, month and week (Monday)
TRUNC_UNITS = {"year": "year", "yyyy": "year", "yy": "year",
               "quarter": "quarter", "month": "month", "mon": "month",
               "mm": "month", "week": "week"}


def trunc_date(days: torch.Tensor, unit: str) -> torch.Tensor:
    """trunc(date, unit): the first day of the year, quarter or month, or
    the week's Monday."""
    kind = TRUNC_UNITS[unit]
    if kind == "week":
        return (days.to(torch.int64) - weekday_monday0(days)).to(torch.int32)
    y, m, _ = civil_from_days(days)
    one = torch.ones_like(y)
    if kind == "year":
        return days_from_civil(y, one, one)
    if kind == "quarter":
        return days_from_civil(y, (m - 1) // 3 * 3 + 1, one)
    return days_from_civil(y, m, one)


US_PER_DAY = 86_400_000_000


def ts_to_days(us: torch.Tensor) -> torch.Tensor:
    """Microseconds since the epoch -> days since the epoch (floor: an
    instant before 1970 belongs to the day it falls in)."""
    return (us.to(torch.int64) // US_PER_DAY).to(torch.int32)


def ts_time_of_day_us(us: torch.Tensor) -> torch.Tensor:
    """Microseconds since the day's midnight, in [0, US_PER_DAY)."""
    return us.to(torch.int64) % US_PER_DAY

"""Datetime expressions over DATE lanes (int32 days since the epoch) and
TIMESTAMP lanes (int64 microseconds since the epoch, UTC).

Counterpart of spark_rapids_tpu/plan/datetime.py: the `DateField` family
(Year, Month, DayOfMonth, DayOfWeek (1 = Sunday), WeekDay (0 = Monday),
DayOfYear, Quarter, WeekOfYear (ISO week)) over a DATE or over a
TIMESTAMP's local day; the time fields Hour, Minute and Second; DateAdd,
DateSub, DateDiff, AddMonths, LastDay, TruncDate and ToUnixTimestamp.
Each is integer arithmetic on the lane's device (ops/datetime.py).

A TIMESTAMP's fields are those of its wall clock in the session
timezone (`spark.sql.session.timeZone`, default UTC): the instant moves
by its zone's offset, looked up in the zone's transition table
(ops/timezone.py), before the day and the time of day are taken; a DATE
becomes an instant at its local midnight (ToUnixTimestamp, the casts of
plan/expressions.py) through the wall-time table.

On the CPU engine (`_eval_cpu`) each class computes with numpy: the
calendar by `datetime64`, the zone through the same transition tables
with `np.searchsorted`.  The CPU engine reads the session zone that
`PhysicalQuery.collect` sets (`set_session_timezone`), the device path
its evaluation context's conf.
"""
from __future__ import annotations

import contextvars
from typing import Optional

import numpy as np
import torch

from .. import types as t
from ..ops import datetime as DK
from ..ops import host as H
from ..ops import timezone as TZ
from ..ops.kernels import merge_validity
from .expressions import DevVal, Expression, Literal

_SESSION_TZ = contextvars.ContextVar("spark_rapids_tpu_torch_session_tz",
                                     default="UTC")
_US_PER_DAY = DK.US_PER_DAY


def set_session_timezone(tz: Optional[str]) -> None:
    _SESSION_TZ.set(tz or "UTC")


def session_timezone() -> str:
    return _SESSION_TZ.get()


def conf_timezone(conf) -> str:
    """The session zone a conf names (UTC without one)."""
    from ..config import SESSION_TIMEZONE
    return "UTC" if conf is None else str(conf.get(SESSION_TIMEZONE))


def _utc(tz: str) -> bool:
    return tz.upper() == "UTC"


def local_us(us, tz: str, device=None):
    """UTC instants (a tensor, or numpy when `device` is None) as wall
    clock microseconds in `tz`."""
    if _utc(tz):
        return us
    if device is None:
        pts, offs = TZ.transition_table(tz)
    else:
        pts, offs = TZ.device_table(tz, device)
    return TZ.utc_to_local(us, pts, offs)


def utc_us_of_wall(wall, tz: str, device=None):
    """Wall clock microseconds in `tz` as UTC instants (Spark's rules
    for gaps and overlaps)."""
    if _utc(tz):
        return wall
    if device is None:
        pts, offs = TZ.wall_table(tz)
    else:
        pts, offs = TZ.device_table(tz, device, wall=True)
    return TZ.local_to_utc(wall, pts, offs)


def _civil_np(days: np.ndarray):
    """(year, month, day) int64 lanes of int64 days since the epoch."""
    d = days.astype("datetime64[D]")
    y = d.astype("datetime64[Y]")
    m = d.astype("datetime64[M]")
    return (y.astype(np.int64) + 1970, m.astype(np.int64) % 12 + 1,
            (d - m).astype(np.int64) + 1)


def _day_of_year_np(days: np.ndarray) -> np.ndarray:
    d = days.astype("datetime64[D]")
    return (d - d.astype("datetime64[Y]")).astype(np.int64) + 1


def _month_start_np(months: np.ndarray) -> np.ndarray:
    """Days since the epoch of the first day of months counted from
    1970-01."""
    return months.astype("datetime64[M]").astype("datetime64[D]").astype(
        np.int64)


def _days_np(k, dt: t.DataType, tz: str) -> np.ndarray:
    """int64 days of a DATE column, or a TIMESTAMP's local days."""
    if isinstance(dt, t.TimestampType):
        return local_us(k.data.astype(np.int64), tz) // _US_PER_DAY
    return k.data.astype(np.int64)


def _days_dev(ctx, kid: DevVal, dt: t.DataType) -> torch.Tensor:
    if isinstance(dt, t.TimestampType):
        return DK.ts_to_days(local_us(kid.data.to(torch.int64),
                                      conf_timezone(ctx.conf), ctx.device))
    return kid.data.to(torch.int32)


class DateField(Expression):
    """Base: an INT field of a DATE, or of a TIMESTAMP's local day."""

    def __init__(self, child):
        self.children = (child,)

    def _resolve(self):
        self.dtype = t.INT
        self.nullable = self.children[0].nullable

    def unsupported_reasons(self, conf):
        dt = self.children[0].dtype
        if not isinstance(dt, (t.DateType, t.TimestampType, t.NullType)):
            return [f"datetime field of {dt.simple_string}"]
        return []

    def _eval_dev(self, ctx, kids):
        days = _days_dev(ctx, kids[0], self.children[0].dtype)
        return DevVal(self._field_dev(days), kids[0].validity, t.INT)

    def _field_dev(self, days):
        raise NotImplementedError(type(self).__name__)

    def _eval_cpu(self, batch, kids):
        k = kids[0]
        days = _days_np(k, self.children[0].dtype, session_timezone())
        return H.column(self._field_np(days).astype(np.int32), k.validity,
                        t.INT)


class Year(DateField):
    def _field_dev(self, days):
        return DK.civil_from_days(days)[0]

    def _field_np(self, days):
        return _civil_np(days)[0]


class Month(DateField):
    def _field_dev(self, days):
        return DK.civil_from_days(days)[1]

    def _field_np(self, days):
        return _civil_np(days)[1]


class DayOfMonth(DateField):
    def _field_dev(self, days):
        return DK.civil_from_days(days)[2]

    def _field_np(self, days):
        return _civil_np(days)[2]


class DayOfWeek(DateField):
    """Spark: 1 = Sunday .. 7 = Saturday."""

    def _field_dev(self, days):
        return DK.day_of_week_sunday1(days)

    def _field_np(self, days):
        return (days + 4) % 7 + 1


class WeekDay(DateField):
    """Spark: 0 = Monday .. 6 = Sunday."""

    def _field_dev(self, days):
        return DK.weekday_monday0(days)

    def _field_np(self, days):
        return (days + 3) % 7


class DayOfYear(DateField):
    def _field_dev(self, days):
        return DK.day_of_year(days)

    def _field_np(self, days):
        return _day_of_year_np(days)


class Quarter(DateField):
    def _field_dev(self, days):
        return (DK.civil_from_days(days)[1] - 1) // 3 + 1

    def _field_np(self, days):
        return (_civil_np(days)[1] - 1) // 3 + 1


class WeekOfYear(DateField):
    """ISO-8601 week number."""

    def _field_dev(self, days):
        return DK.iso_week(days)

    def _field_np(self, days):
        thursday = days + 3 - (days + 3) % 7
        return (_day_of_year_np(thursday) - 1) // 7 + 1




class TimeField(Expression):
    """Base: an INT field of a TIMESTAMP's local time of day."""

    def __init__(self, child):
        self.children = (child,)

    def _resolve(self):
        self.dtype = t.INT
        self.nullable = self.children[0].nullable

    def unsupported_reasons(self, conf):
        dt = self.children[0].dtype
        if not isinstance(dt, (t.TimestampType, t.NullType)):
            return [f"time field of {dt.simple_string}"]
        return []

    def _eval_dev(self, ctx, kids):
        us = local_us(kids[0].data.to(torch.int64), conf_timezone(ctx.conf),
                      ctx.device)
        return DevVal(self._from_tod(DK.ts_time_of_day_us(us)).to(
            torch.int32), kids[0].validity, t.INT)

    def _eval_cpu(self, batch, kids):
        k = kids[0]
        us = local_us(k.data.astype(np.int64), session_timezone())
        return H.column(self._from_tod(us % _US_PER_DAY).astype(np.int32),
                        k.validity, t.INT)


class Hour(TimeField):
    def _from_tod(self, tod):
        return tod // 3_600_000_000


class Minute(TimeField):
    def _from_tod(self, tod):
        return tod // 60_000_000 % 60


class Second(TimeField):
    def _from_tod(self, tod):
        return tod // 1_000_000 % 60


def _lift(x) -> Expression:
    return x if isinstance(x, Expression) else Literal(x)


class DateAdd(Expression):
    """date_add(date, n) -> DATE; DateSub subtracts."""
    _sign = 1

    def __init__(self, date, n):
        self.children = (date, _lift(n))

    def _resolve(self):
        self.dtype = t.DATE
        self.nullable = True

    def unsupported_reasons(self, conf):
        if not isinstance(self.children[0].dtype, (t.DateType, t.NullType)):
            return ["date_add of non-date"]
        if not t.is_integral(self.children[1].dtype):
            return ["date_add offset must be integral"]
        return []

    def _eval_dev(self, ctx, kids):
        d = _days_dev(ctx, kids[0], self.children[0].dtype).to(torch.int64) \
            + self._sign * kids[1].data.to(torch.int64)
        return DevVal(d.to(torch.int32),
                      merge_validity(kids[0].validity, kids[1].validity),
                      t.DATE)

    def _eval_cpu(self, batch, kids):
        d = _days_np(kids[0], self.children[0].dtype, session_timezone()) \
            + self._sign * kids[1].data.astype(np.int64)
        return H.column(d.astype(np.int32),
                        H.and_valid(kids[0].validity, kids[1].validity),
                        t.DATE)


class DateSub(DateAdd):
    _sign = -1


class DateDiff(Expression):
    """datediff(end, start) -> INT days."""

    def __init__(self, end, start):
        self.children = (end, start)

    def _resolve(self):
        self.dtype = t.INT
        self.nullable = True

    def unsupported_reasons(self, conf):
        for c in self.children:
            if not isinstance(c.dtype, (t.DateType, t.NullType)):
                return ["datediff of non-date"]
        return []

    def _eval_dev(self, ctx, kids):
        e, s = (_days_dev(ctx, k, c.dtype).to(torch.int64)
                for k, c in zip(kids, self.children))
        return DevVal((e - s).to(torch.int32),
                      merge_validity(kids[0].validity, kids[1].validity),
                      t.INT)

    def _eval_cpu(self, batch, kids):
        tz = session_timezone()
        e, s = (_days_np(k, c.dtype, tz) for k, c in zip(kids,
                                                          self.children))
        return H.column((e - s).astype(np.int32),
                        H.and_valid(kids[0].validity, kids[1].validity),
                        t.INT)


def _add_months_np(days: np.ndarray, months: np.ndarray) -> np.ndarray:
    y, m, d = _civil_np(days)
    total = (y - 1970) * 12 + (m - 1) + months.astype(np.int64)
    start = _month_start_np(total)
    length = _month_start_np(total + 1) - start
    return start + np.minimum(d, length) - 1


class AddMonths(Expression):
    """add_months(date, n): the day clamped to the target month's last."""

    def __init__(self, date, months):
        self.children = (date, _lift(months))

    def _resolve(self):
        self.dtype = t.DATE
        self.nullable = True

    def unsupported_reasons(self, conf):
        if not isinstance(self.children[0].dtype, (t.DateType, t.NullType)):
            return ["add_months of non-date"]
        return []

    def _eval_dev(self, ctx, kids):
        days = _days_dev(ctx, kids[0], self.children[0].dtype)
        return DevVal(DK.add_months(days, kids[1].data),
                      merge_validity(kids[0].validity, kids[1].validity),
                      t.DATE)

    def _eval_cpu(self, batch, kids):
        days = _days_np(kids[0], self.children[0].dtype, session_timezone())
        return H.column(_add_months_np(days, kids[1].data).astype(np.int32),
                        H.and_valid(kids[0].validity, kids[1].validity),
                        t.DATE)


class LastDay(Expression):
    def __init__(self, date):
        self.children = (date,)

    def _resolve(self):
        self.dtype = t.DATE
        self.nullable = self.children[0].nullable

    def unsupported_reasons(self, conf):
        if not isinstance(self.children[0].dtype, (t.DateType, t.NullType)):
            return ["last_day of non-date"]
        return []

    def _eval_dev(self, ctx, kids):
        days = _days_dev(ctx, kids[0], self.children[0].dtype)
        return DevVal(DK.last_day(days), kids[0].validity, t.DATE)

    def _eval_cpu(self, batch, kids):
        days = _days_np(kids[0], self.children[0].dtype, session_timezone())
        month = days.astype("datetime64[D]").astype("datetime64[M]").astype(
            np.int64)
        return H.column((_month_start_np(month + 1) - 1).astype(np.int32),
                        kids[0].validity, t.DATE)


class TruncDate(Expression):
    """trunc(date, unit): year, quarter, month or week (its Monday)."""

    def __init__(self, date, unit: str):
        self.children = (date,)
        self.unit = str(unit).lower()

    def _resolve(self):
        self.dtype = t.DATE
        self.nullable = True

    def unsupported_reasons(self, conf):
        out = []
        if not isinstance(self.children[0].dtype, (t.DateType, t.NullType)):
            out.append("trunc of non-date")
        if self.unit not in DK.TRUNC_UNITS:
            out.append(f"trunc unit {self.unit!r}")
        return out

    def _eval_dev(self, ctx, kids):
        days = _days_dev(ctx, kids[0], self.children[0].dtype)
        return DevVal(DK.trunc_date(days, self.unit), kids[0].validity,
                      t.DATE)

    def _eval_cpu(self, batch, kids):
        days = _days_np(kids[0], self.children[0].dtype, session_timezone())
        kind = DK.TRUNC_UNITS[self.unit]
        d = days.astype("datetime64[D]")
        if kind == "week":
            out = days - (days + 3) % 7
        elif kind == "year":
            out = d.astype("datetime64[Y]").astype("datetime64[D]").astype(
                np.int64)
        else:
            month = d.astype("datetime64[M]").astype(np.int64)
            if kind == "quarter":
                month = month - month % 3
            out = _month_start_np(month)
        return H.column(out.astype(np.int32), kids[0].validity, t.DATE)

    def _fp_extra(self):
        return self.unit


class ToUnixTimestamp(Expression):
    """Seconds since the epoch (LONG) of a TIMESTAMP (floor), or of a
    DATE's local midnight in the session zone."""

    def __init__(self, child):
        self.children = (child,)

    def _resolve(self):
        self.dtype = t.LONG
        self.nullable = self.children[0].nullable

    def unsupported_reasons(self, conf):
        dt = self.children[0].dtype
        if not isinstance(dt, (t.TimestampType, t.DateType, t.NullType)):
            return ["to_unix_timestamp of non-datetime"]
        return []

    def _eval_dev(self, ctx, kids):
        x = kids[0].data.to(torch.int64)
        if isinstance(self.children[0].dtype, t.DateType):
            x = utc_us_of_wall(x * _US_PER_DAY, conf_timezone(ctx.conf),
                               ctx.device)
        return DevVal(x // 1_000_000, kids[0].validity, t.LONG)

    def _eval_cpu(self, batch, kids):
        x = kids[0].data.astype(np.int64)
        if isinstance(self.children[0].dtype, t.DateType):
            x = utc_us_of_wall(x * _US_PER_DAY, session_timezone())
        return H.column(x // 1_000_000, kids[0].validity, t.LONG)

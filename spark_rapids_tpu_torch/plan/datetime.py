"""Date field expressions over DATE lanes (int32 days since the epoch).

Counterpart of spark_rapids_tpu/plan/datetime.py's `DateField` family:
Year, Month, DayOfMonth, DayOfWeek (1 = Sunday), WeekDay (0 = Monday),
DayOfYear, Quarter and WeekOfYear (ISO week), each an INT computed by
the integer calendar of ops/datetime.py on the lane's device.

A TIMESTAMP input needs the session timezone's transition tables; it
refuses, as do DateAdd, DateDiff, AddMonths, LastDay, TruncDate and the
time fields, until ROADMAP Queue 1 item 1(e) ports them.

On the CPU engine (`_eval_cpu`) each field is numpy's proleptic
Gregorian calendar (`datetime64`), the device path's yardstick.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import types as t
from ..ops import datetime as DK
from ..ops import host as H
from .expressions import DevVal, Expression, Unported


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

class DateField(Expression):
    """Base: an INT field of a DATE."""

    def __init__(self, child):
        self.children = (child,)

    def _resolve(self):
        self.dtype = t.INT
        self.nullable = self.children[0].nullable

    def unsupported_reasons(self, conf):
        dt = self.children[0].dtype
        if isinstance(dt, t.TimestampType):
            return [Unported("datetime fields of a TIMESTAMP need the "
                             "session timezone, which ports with ROADMAP "
                             "Queue 1 item 1(e)")]
        if not isinstance(dt, (t.DateType, t.NullType)):
            return [f"datetime field of {dt.simple_string}"]
        return []

    def _eval_dev(self, ctx, kids):
        return DevVal(self._field_dev(kids[0].data.to(torch.int32)),
                      kids[0].validity, t.INT)

    def _field_dev(self, days):
        raise NotImplementedError(type(self).__name__)

    def _eval_cpu(self, batch, kids):
        if isinstance(self.children[0].dtype, t.TimestampType):
            raise NotImplementedError(
                "datetime fields of a TIMESTAMP need the session timezone, "
                "which ports with ROADMAP Queue 1 item 1(e)")
        k = kids[0]
        return H.column(self._field_np(k.data.astype(np.int64)), k.validity,
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


"""Date field expressions over DATE lanes (int32 days since the epoch).

Counterpart of spark_rapids_tpu/plan/datetime.py's `DateField` family:
Year, Month, DayOfMonth, DayOfWeek (1 = Sunday), WeekDay (0 = Monday),
DayOfYear, Quarter and WeekOfYear (ISO week), each an INT computed by
the integer calendar of ops/datetime.py on the lane's device.

A TIMESTAMP input needs the session timezone's transition tables; it
refuses, as do DateAdd, DateDiff, AddMonths, LastDay, TruncDate and the
time fields, until ROADMAP Queue 1 item 1(e) ports them.
"""
from __future__ import annotations

import torch

from .. import types as t
from ..ops import datetime as DK
from .expressions import DevVal, Expression

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
            return ["datetime fields of a TIMESTAMP need the session "
                    "timezone, which ports with ROADMAP Queue 1 item 1(e)"]
        if not isinstance(dt, (t.DateType, t.NullType)):
            return [f"datetime field of {dt.simple_string}"]
        return []

    def _eval_dev(self, ctx, kids):
        return DevVal(self._field_dev(kids[0].data.to(torch.int32)),
                      kids[0].validity, t.INT)

    def _field_dev(self, days):
        raise NotImplementedError(type(self).__name__)


class Year(DateField):
    def _field_dev(self, days):
        return DK.civil_from_days(days)[0]


class Month(DateField):
    def _field_dev(self, days):
        return DK.civil_from_days(days)[1]


class DayOfMonth(DateField):
    def _field_dev(self, days):
        return DK.civil_from_days(days)[2]


class DayOfWeek(DateField):
    """Spark: 1 = Sunday .. 7 = Saturday."""

    def _field_dev(self, days):
        return DK.day_of_week_sunday1(days)


class WeekDay(DateField):
    """Spark: 0 = Monday .. 6 = Sunday."""

    def _field_dev(self, days):
        return DK.weekday_monday0(days)


class DayOfYear(DateField):
    def _field_dev(self, days):
        return DK.day_of_year(days)


class Quarter(DateField):
    def _field_dev(self, days):
        return (DK.civil_from_days(days)[1] - 1) // 3 + 1


class WeekOfYear(DateField):
    """ISO-8601 week number."""

    def _field_dev(self, days):
        return DK.iso_week(days)

"""Date parts (counterpart of the JAX package's
``sql/exprs/datetimeexprs.py``: ``civil_from_days``, ``days_from_civil``,
``days_from_micros``, ``time_of_day_micros`` and the ``ExtractDatePart``
family: year, month, dayofmonth, dayofweek, hour, minute, second,
quarter, dayofyear and weekofyear; date arithmetic and unix timestamps
wait for ROADMAP A.6). UTC only, as the JAX package's.

Calendar math is Howard Hinnant's civil-from-days algorithm in integer
arithmetic, one formula for numpy on the host and torch on the device
(``//`` floors on both).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import pandas as pd
import torch

from spark_rapids_tpu_torch.columnar import dtypes
from spark_rapids_tpu_torch.columnar.batch import Schema, _pandas_col_dtype
from spark_rapids_tpu_torch.columnar.dtype import DType
from spark_rapids_tpu_torch.sql.exprs.core import (
    DevCol, DevValue, EvalContext, Expression,
)
from spark_rapids_tpu_torch.sql.exprs.hostutil import (
    host_unary_values, rebuild_series,
)

MICROS_PER_SEC = 1_000_000
MICROS_PER_DAY = 86_400 * MICROS_PER_SEC


def _int64(z):
    return z.to(torch.int64) if isinstance(z, torch.Tensor) \
        else np.asarray(z).astype(np.int64)


def _where(cond, a, b):
    if isinstance(cond, torch.Tensor):
        return torch.where(cond, a, b)
    return np.where(cond, a, b)


def civil_from_days(z):
    """days since the epoch -> (year, month [1-12], day [1-31]), numpy or
    torch. Hinnant's algorithm, valid over the whole int32 day range."""
    z = _int64(z) + 719468
    era = _where(z >= 0, z, z - 146096) // 146097
    doe = z - era * 146097                                   # [0, 146096]
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)          # [0, 365]
    mp = (5 * doy + 2) // 153                                # [0, 11]
    d = doy - (153 * mp + 2) // 5 + 1                        # [1, 31]
    m = _where(mp < 10, mp + 3, mp - 9)                      # [1, 12]
    y = y + (m <= 2)
    return y, m, d


def days_from_civil(y, m, d):
    """Inverse of civil_from_days (Hinnant's days_from_civil)."""
    y = _int64(y) - _int64(m <= 2)
    era = _where(y >= 0, y, y - 399) // 400
    yoe = y - era * 400
    mp = _where(m > 2, m - 3, m + 9)
    doy = (153 * mp + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - 719468


def days_from_micros(micros):
    return _int64(micros) // MICROS_PER_DAY


def time_of_day_micros(micros):
    """Microseconds since midnight, in [0, MICROS_PER_DAY) also before
    1970 (floor division)."""
    m = _int64(micros)
    return m - (m // MICROS_PER_DAY) * MICROS_PER_DAY


class ExtractDatePart(Expression):
    """Base of the date parts: an INT32 from a DATE or TIMESTAMP input,
    computed from the days since the epoch and the microseconds since
    midnight (zero for a date)."""
    fname = "?"

    def __init__(self, child: Expression):
        super().__init__([child])

    def dtype(self, schema: Schema) -> DType:
        return dtypes.INT32

    def __repr__(self) -> str:
        return f"{self.fname}({self.children[0]!r})"

    def device_supported(self, schema: Schema) -> Optional[str]:
        t = self.children[0].dtype(schema)
        if not t.is_datetime:
            return f"{self.fname} requires a date or timestamp input, got {t}"
        return None

    def compute_from_parts(self, days, tod):
        raise NotImplementedError

    @staticmethod
    def _split(data, src: DType):
        """(days since the epoch, microseconds since midnight)."""
        if src == dtypes.DATE32:
            days = _int64(data)
            return days, days * 0
        return days_from_micros(data), time_of_day_micros(data)

    def eval_device(self, ctx: EvalContext) -> DevValue:
        v = ctx.broadcast(self.children[0].eval_device(ctx))
        out = self.compute_from_parts(*self._split(v.data, v.dtype))
        return DevCol(dtypes.INT32, out.to(torch.int32), v.validity)

    def eval_host(self, df: pd.DataFrame) -> pd.Series:
        s = self.children[0].eval_host(df)
        values, validity, index = host_unary_values(s)
        out = self.compute_from_parts(*self._split(values,
                                                   _pandas_col_dtype(s)))
        return rebuild_series(np.asarray(out).astype(np.int32), validity,
                              dtypes.INT32, index)


class Year(ExtractDatePart):
    fname = "year"

    def compute_from_parts(self, days, tod):
        return civil_from_days(days)[0]


class Month(ExtractDatePart):
    fname = "month"

    def compute_from_parts(self, days, tod):
        return civil_from_days(days)[1]


class DayOfMonth(ExtractDatePart):
    fname = "dayofmonth"

    def compute_from_parts(self, days, tod):
        return civil_from_days(days)[2]


class DayOfWeek(ExtractDatePart):
    """Spark: 1 = Sunday ... 7 = Saturday. Epoch day 0 was a Thursday."""
    fname = "dayofweek"

    def compute_from_parts(self, days, tod):
        return (days + 4) % 7 + 1


class Hour(ExtractDatePart):
    fname = "hour"

    def compute_from_parts(self, days, tod):
        return tod // (3600 * MICROS_PER_SEC)


class Minute(ExtractDatePart):
    fname = "minute"

    def compute_from_parts(self, days, tod):
        return (tod // (60 * MICROS_PER_SEC)) % 60


class Second(ExtractDatePart):
    fname = "second"

    def compute_from_parts(self, days, tod):
        return (tod // MICROS_PER_SEC) % 60


class Quarter(ExtractDatePart):
    fname = "quarter"

    def compute_from_parts(self, days, tod):
        return (civil_from_days(days)[1] - 1) // 3 + 1


def _jan1(y):
    return days_from_civil(y, y * 0 + 1, y * 0 + 1)


class DayOfYear(ExtractDatePart):
    fname = "dayofyear"

    def compute_from_parts(self, days, tod):
        return days - _jan1(civil_from_days(days)[0]) + 1


class WeekOfYear(ExtractDatePart):
    """ISO-8601 week number (Spark's weekofyear): the Thursday of the
    row's week decides the year."""
    fname = "weekofyear"

    def compute_from_parts(self, days, tod):
        dow = (days + 3) % 7            # 0 = Monday ... 6 = Sunday
        thursday = days + (3 - dow)
        return (thursday - _jan1(civil_from_days(thursday)[0])) // 7 + 1

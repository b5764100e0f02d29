"""Date parts (counterpart of the JAX package's
``sql/exprs/datetimeexprs.py``: ``civil_from_days``, ``days_from_civil``,
``days_from_micros``, ``time_of_day_micros`` and the ``ExtractDatePart``
family: year, month, dayofmonth, dayofweek, hour, minute, second,
quarter, dayofyear and weekofyear; date arithmetic: date_add, date_sub,
datediff, add_months, months_between, last_day, trunc and next_day; unix
time: unix_timestamp of a timestamp, a date or a string in one of two
fixed formats, and from_unixtime). UTC only, as the JAX package's.

On the host a date rides as a timestamp at midnight (pandas datetime64),
so the host paths take days from microseconds, as the JAX package's do,
and hand dates back as DATE32.

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
from spark_rapids_tpu_torch.sql.exprs import cast as _cast
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


def _days(data, dt: DType):
    """Days since the epoch of a device DATE32 or TIMESTAMP_US value."""
    return _int64(data) if dt == dtypes.DATE32 else days_from_micros(data)


def _host_days(s: pd.Series):
    """(int64 days, validity, index) of a host date or timestamp
    column."""
    values, validity, index = host_unary_values(s)
    return days_from_micros(values), validity, index


def _host_date(days, validity, index) -> pd.Series:
    return rebuild_series(np.asarray(days).astype(np.int32), validity,
                          dtypes.DATE32, index)


class _DateExpr(Expression):
    """A function of dates; ``fname`` names it in its repr and tags."""
    fname = "?"

    def __repr__(self) -> str:
        return f"{self.fname}({', '.join(map(repr, self.children))})"


class UnixTimestampFromTs(_DateExpr):
    """to_unix_timestamp of a timestamp: whole seconds, floored."""
    fname = "unix_timestamp"

    def __init__(self, child: Expression):
        super().__init__([child])

    def dtype(self, schema: Schema) -> DType:
        return dtypes.INT64

    def eval_device(self, ctx: EvalContext) -> DevValue:
        v = ctx.broadcast(self.children[0].eval_device(ctx))
        return DevCol(dtypes.INT64, _int64(v.data) // MICROS_PER_SEC,
                      v.validity)

    def eval_host(self, df: pd.DataFrame) -> pd.Series:
        values, validity, index = host_unary_values(
            self.children[0].eval_host(df))
        return rebuild_series(_int64(values) // MICROS_PER_SEC, validity,
                              dtypes.INT64, index)


class DateAdd(_DateExpr):
    """date_add(date, n days)."""
    fname = "date_add"
    sign = 1

    def __init__(self, left: Expression, right: Expression):
        super().__init__([left, right])

    def dtype(self, schema: Schema) -> DType:
        return dtypes.DATE32

    def device_supported(self, schema: Schema) -> Optional[str]:
        if self.children[0].dtype(schema) != dtypes.DATE32:
            # date_sub's reason too, word for word the JAX package's
            return "date_add requires a date input"
        return None

    def eval_device(self, ctx: EvalContext) -> DevValue:
        lv = ctx.broadcast(self.children[0].eval_device(ctx))
        rv = ctx.broadcast(self.children[1].eval_device(ctx))
        data = lv.data.to(torch.int32) + self.sign * rv.data.to(torch.int32)
        return DevCol(dtypes.DATE32, data, lv.validity & rv.validity)

    def eval_host(self, df: pd.DataFrame) -> pd.Series:
        days, av, index = _host_days(self.children[0].eval_host(df))
        b, bv, _ = host_unary_values(self.children[1].eval_host(df))
        return _host_date(days + self.sign * _int64(b), av & bv, index)


class DateSub(DateAdd):
    """date_sub(date, n days)."""
    fname = "date_sub"
    sign = -1


class LastDay(_DateExpr):
    """last_day(date): the last day of its month."""
    fname = "last_day"

    def __init__(self, child: Expression):
        super().__init__([child])

    def dtype(self, schema: Schema) -> DType:
        return dtypes.DATE32

    def device_supported(self, schema: Schema) -> Optional[str]:
        if not self.children[0].dtype(schema).is_datetime:
            return "last_day requires a date input"
        return None

    @staticmethod
    def _compute(days):
        y, m, _d = civil_from_days(days)
        first_next = days_from_civil(_where(m == 12, y + 1, y),
                                     _where(m == 12, m * 0 + 1, m + 1),
                                     m * 0 + 1)
        return first_next - 1

    def eval_device(self, ctx: EvalContext) -> DevValue:
        v = ctx.broadcast(self.children[0].eval_device(ctx))
        return DevCol(dtypes.DATE32, self._compute(
            _days(v.data, v.dtype)).to(torch.int32), v.validity)

    def eval_host(self, df: pd.DataFrame) -> pd.Series:
        days, validity, index = _host_days(self.children[0].eval_host(df))
        return _host_date(self._compute(days), validity, index)


class DateDiff(_DateExpr):
    """datediff(end, start) in whole days."""
    fname = "datediff"

    def __init__(self, end: Expression, start: Expression):
        super().__init__([end, start])

    def dtype(self, schema: Schema) -> DType:
        return dtypes.INT32

    def device_supported(self, schema: Schema) -> Optional[str]:
        for c in self.children:
            if not c.dtype(schema).is_datetime:
                return "datediff requires date/timestamp inputs"
        return None

    def eval_device(self, ctx: EvalContext) -> DevValue:
        lv = ctx.broadcast(self.children[0].eval_device(ctx))
        rv = ctx.broadcast(self.children[1].eval_device(ctx))
        out = _days(lv.data, lv.dtype) - _days(rv.data, rv.dtype)
        return DevCol(dtypes.INT32, out.to(torch.int32),
                      lv.validity & rv.validity)

    def eval_host(self, df: pd.DataFrame) -> pd.Series:
        a, av, index = _host_days(self.children[0].eval_host(df))
        b, bv, _ = _host_days(self.children[1].eval_host(df))
        return rebuild_series((a - b).astype(np.int32), av & bv,
                              dtypes.INT32, index)


class FromUnixTime(_DateExpr):
    """from_unixtime(seconds) -> timestamp (no format string, as in the
    JAX package)."""
    fname = "from_unixtime"

    def __init__(self, child: Expression):
        super().__init__([child])

    def dtype(self, schema: Schema) -> DType:
        return dtypes.TIMESTAMP_US

    def eval_device(self, ctx: EvalContext) -> DevValue:
        v = ctx.broadcast(self.children[0].eval_device(ctx))
        return DevCol(dtypes.TIMESTAMP_US, _int64(v.data) * MICROS_PER_SEC,
                      v.validity)

    def eval_host(self, df: pd.DataFrame) -> pd.Series:
        values, validity, index = host_unary_values(
            self.children[0].eval_host(df))
        return rebuild_series(_int64(values) * MICROS_PER_SEC, validity,
                              dtypes.TIMESTAMP_US, index)


class UnixTimestampFromString(_DateExpr):
    """unix_timestamp(string, fmt) -> epoch seconds (UTC), NULL where the
    string does not parse. The device parses the two fixed formats
    (``ops/strings.string_to_unix_ts``); other formats stay on the host
    (strptime). A date or timestamp input ignores ``fmt``."""
    fname = "unix_timestamp"

    _DEVICE_FMTS = ("yyyy-MM-dd", "yyyy-MM-dd HH:mm:ss")
    _JAVA_TO_PY = (("yyyy", "%Y"), ("MM", "%m"), ("dd", "%d"),
                   ("HH", "%H"), ("mm", "%M"), ("ss", "%S"))

    def __init__(self, child: Expression, fmt: str):
        super().__init__([child])
        self.fmt = fmt
        # a token neither side implements would parse nothing (all NULL):
        # refused at construction
        import re
        residual = fmt
        for j, _ in self._JAVA_TO_PY:
            residual = residual.replace(j, "")
        if re.search(r"[A-Za-z]", residual):
            raise ValueError(
                f"unsupported unix_timestamp format token in {fmt!r} "
                f"(supported tokens: yyyy MM dd HH mm ss)")

    def dtype(self, schema: Schema) -> DType:
        return dtypes.INT64

    def __repr__(self) -> str:
        return f"unix_timestamp({self.children[0]!r}, {self.fmt!r})"

    def device_supported(self, schema: Schema) -> Optional[str]:
        t = self.children[0].dtype(schema)
        if t.is_datetime:
            return None
        if not t.is_string:
            return (f"unix_timestamp requires a string or date/timestamp "
                    f"input, got {t}")
        if self.fmt not in self._DEVICE_FMTS:
            return (f"unix_timestamp format {self.fmt!r} is not supported "
                    f"on TPU (supported: {', '.join(self._DEVICE_FMTS)})")
        return None

    def eval_device(self, ctx: EvalContext) -> DevValue:
        from spark_rapids_tpu_torch.ops import strings as string_ops
        v = ctx.broadcast(self.children[0].eval_device(ctx))
        if v.dtype.is_datetime:
            secs = (_int64(v.data) * 86400 if v.dtype == dtypes.DATE32
                    else _int64(v.data) // MICROS_PER_SEC)
            return DevCol(dtypes.INT64, secs, v.validity)
        secs, ok = string_ops.string_to_unix_ts(ctx, v,
                                                with_time=" " in self.fmt)
        return DevCol(dtypes.INT64, torch.where(ok, secs,
                                                torch.zeros_like(secs)),
                      v.validity & ok)

    def eval_host(self, df: pd.DataFrame) -> pd.Series:
        import calendar
        import datetime as _dt
        import re
        values, validity, index = host_unary_values(
            self.children[0].eval_host(df))
        if values.dtype != object:  # a date or timestamp: fmt ignored
            return rebuild_series(_int64(values) // MICROS_PER_SEC, validity,
                                  dtypes.INT64, index)
        pyfmt = self.fmt
        for j, p in self._JAVA_TO_PY:
            pyfmt = pyfmt.replace(j, p)
        # strptime takes '1:02:03' for %H:%M:%S leniently; the device
        # wants the pattern's digit widths
        strict = re.escape(pyfmt).replace(re.escape("%Y"), r"\d{4}")
        for tok in ("%m", "%d", "%H", "%M", "%S"):
            strict = strict.replace(re.escape(tok), r"\d{2}")
        strict_re = re.compile("^" + strict + "$", re.ASCII)
        out = np.zeros(len(values), np.int64)
        ok = validity.copy()
        for i, v in enumerate(values):
            if not validity[i]:
                continue
            try:
                t = str(v).strip(" \t\n\r\v\f")
                if not strict_re.match(t):
                    raise ValueError(t)
                tm = _dt.datetime.strptime(t, pyfmt)
                out[i] = calendar.timegm(tm.timetuple())
            except ValueError:
                ok[i] = False
        return rebuild_series(out, ok, dtypes.INT64, index)


_MONTH_DAYS = np.array([31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31],
                       dtype=np.int64)


def _civil_add_months(days, months):
    """days -> days, ``months`` calendar months later, the day clamped to
    the target month's length (Spark's add_months); numpy or torch."""
    y, m, d = civil_from_days(days)
    total = (y * 12 + (m - 1)) + _int64(months)
    ny = total // 12
    nm = total % 12 + 1
    leap = ((ny % 4 == 0) & (ny % 100 != 0)) | (ny % 400 == 0)
    if isinstance(nm, torch.Tensor):
        from spark_rapids_tpu_torch.columnar.column import host_to_device
        table = host_to_device(_MONTH_DAYS, nm.device)
        mdays = table[nm - 1]
        nd = torch.minimum(d, torch.where((nm == 2) & leap, mdays * 0 + 29,
                                          mdays))
    else:
        mdays = _MONTH_DAYS[nm - 1]
        nd = np.minimum(d, np.where((nm == 2) & leap, 29, mdays))
    return days_from_civil(ny, nm, nd)


class AddMonths(_DateExpr):
    """add_months(date, n)."""
    fname = "add_months"

    def __init__(self, left: Expression, right: Expression):
        super().__init__([left, right])

    def dtype(self, schema: Schema) -> DType:
        return dtypes.DATE32

    def device_supported(self, schema: Schema) -> Optional[str]:
        if not self.children[0].dtype(schema).is_datetime:
            return "add_months requires a date input"
        return None

    def eval_device(self, ctx: EvalContext) -> DevValue:
        lv = ctx.broadcast(self.children[0].eval_device(ctx))
        rv = ctx.broadcast(self.children[1].eval_device(ctx))
        out = _civil_add_months(_days(lv.data, lv.dtype), rv.data)
        return DevCol(dtypes.DATE32, out.to(torch.int32),
                      lv.validity & rv.validity)

    def eval_host(self, df: pd.DataFrame) -> pd.Series:
        days, av, index = _host_days(self.children[0].eval_host(df))
        b, bv, _ = host_unary_values(self.children[1].eval_host(df))
        return _host_date(_civil_add_months(days, b), av & bv, index)


class MonthsBetween(_DateExpr):
    """months_between(end, start): the whole months between them plus the
    day difference over 31; a pair on the same day of the month, or on
    the last days of both months, counts whole months only."""
    fname = "months_between"

    def __init__(self, left: Expression, right: Expression):
        super().__init__([left, right])

    def dtype(self, schema: Schema) -> DType:
        return dtypes.FLOAT64

    def device_supported(self, schema: Schema) -> Optional[str]:
        for c in self.children:
            if not c.dtype(schema).is_datetime:
                return "months_between requires date inputs"
        return None

    @staticmethod
    def _compute(d_end, d_start):
        y1, m1, day1 = civil_from_days(d_end)
        y2, m2, day2 = civil_from_days(d_start)
        last1 = civil_from_days(d_end + 1)[2] == 1
        last2 = civil_from_days(d_start + 1)[2] == 1
        months = (y1 - y2) * 12 + (m1 - m2)
        whole = (day1 == day2) | (last1 & last2)
        if isinstance(months, torch.Tensor):
            months = months.to(torch.float64)
            # a tensor divisor: PyTorch on CUDA multiplies by the
            # reciprocal of a scalar one, which rounds differently
            diff = (day1 - day2).to(torch.float64)
            frac = diff / torch.full_like(diff, 31.0)
        else:
            months = months.astype(np.float64)
            frac = (day1 - day2) / 31.0
        return _where(whole, months, months + frac)

    def eval_device(self, ctx: EvalContext) -> DevValue:
        lv = ctx.broadcast(self.children[0].eval_device(ctx))
        rv = ctx.broadcast(self.children[1].eval_device(ctx))
        out = self._compute(_days(lv.data, lv.dtype), _days(rv.data,
                                                            rv.dtype))
        return DevCol(dtypes.FLOAT64, out, lv.validity & rv.validity)

    def eval_host(self, df: pd.DataFrame) -> pd.Series:
        a, av, index = _host_days(self.children[0].eval_host(df))
        b, bv, _ = _host_days(self.children[1].eval_host(df))
        return rebuild_series(self._compute(a, b), av & bv, dtypes.FLOAT64,
                              index)


class _DateUnit(_DateExpr):
    """A date function with a unit argument; an unknown unit stays on the
    CPU, where it gives NULL, as in Spark."""
    UNITS: dict = {}

    def __init__(self, child: Expression, unit: str):
        super().__init__([child])
        self.unit = str(unit).lower()

    def dtype(self, schema: Schema) -> DType:
        return dtypes.DATE32

    def __repr__(self) -> str:
        return f"{self.fname}({self.children[0]!r}, {self.unit!r})"

    def device_supported(self, schema: Schema) -> Optional[str]:
        if self.unit not in self.UNITS:
            return f"{self.fname} {self.what} {self.unit!r} is not supported"
        if not self.children[0].dtype(schema).is_datetime:
            return f"{self.fname} requires a date input"
        return None

    def _compute(self, days):
        raise NotImplementedError

    def eval_device(self, ctx: EvalContext) -> DevValue:
        v = ctx.broadcast(self.children[0].eval_device(ctx))
        return DevCol(dtypes.DATE32, self._compute(
            _days(v.data, v.dtype)).to(torch.int32), v.validity)

    def eval_host(self, df: pd.DataFrame) -> pd.Series:
        days, validity, index = _host_days(self.children[0].eval_host(df))
        if self.unit not in self.UNITS:
            return _host_date(np.zeros(len(days), np.int64),
                              np.zeros_like(validity), index)
        return _host_date(self._compute(days), validity, index)


class TruncDate(_DateUnit):
    """trunc(date, 'year'|'month'|'quarter'|'week'): the first day of the
    period (a week starts on Monday)."""
    fname = "trunc"
    what = "format"
    UNITS = {"year": "year", "yyyy": "year", "yy": "year",
             "month": "month", "mon": "month", "mm": "month",
             "week": "week", "quarter": "quarter"}

    def _compute(self, days):
        kind = self.UNITS[self.unit]
        y, m, _d = civil_from_days(days)
        one = m * 0 + 1
        if kind == "year":
            return days_from_civil(y, one, one)
        if kind == "month":
            return days_from_civil(y, m, one)
        if kind == "quarter":
            return days_from_civil(y, ((m - 1) // 3) * 3 + 1, one)
        return days - (days + 3) % 7    # 1970-01-01 was a Thursday


class NextDay(_DateUnit):
    """next_day(date, 'mon'..'sun'): the first later date on that day of
    the week."""
    fname = "next_day"
    what = "day"
    UNITS = {"mon": 0, "monday": 0, "tue": 1, "tuesday": 1, "wed": 2,
             "wednesday": 2, "thu": 3, "thursday": 3, "fri": 4, "friday": 4,
             "sat": 5, "saturday": 5, "sun": 6, "sunday": 6}

    def _compute(self, days):
        ahead = (self.UNITS[self.unit] - (days + 3) % 7) % 7
        return days + _where(ahead == 0, ahead * 0 + 7, ahead)


# to_date lives beside the casts it shares its string parse with
# (sql/exprs/cast.py); the JAX package's name here
ToDate = _cast.ToDate

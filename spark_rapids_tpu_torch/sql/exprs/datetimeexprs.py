"""Date parts (counterpart of the JAX package's
``sql/exprs/datetimeexprs.py``: ``civil_from_days``, ``days_from_micros``,
``ExtractDatePart`` and ``Year``; the other date parts, date arithmetic and
unix timestamps wait for ROADMAP A.6). UTC only, as the JAX package's.

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


def days_from_micros(micros):
    return _int64(micros) // MICROS_PER_DAY


class ExtractDatePart(Expression):
    """Base of the date parts: an INT32 from a DATE or TIMESTAMP input."""
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

    def compute_from_days(self, days):
        raise NotImplementedError

    @staticmethod
    def _days(data, src: DType):
        return _int64(data) if src == dtypes.DATE32 \
            else days_from_micros(data)

    def eval_device(self, ctx: EvalContext) -> DevValue:
        v = ctx.broadcast(self.children[0].eval_device(ctx))
        out = self.compute_from_days(self._days(v.data, v.dtype))
        return DevCol(dtypes.INT32, out.to(torch.int32), v.validity)

    def eval_host(self, df: pd.DataFrame) -> pd.Series:
        s = self.children[0].eval_host(df)
        values, validity, index = host_unary_values(s)
        out = self.compute_from_days(self._days(values,
                                                _pandas_col_dtype(s)))
        return rebuild_series(np.asarray(out).astype(np.int32), validity,
                              dtypes.INT32, index)


class Year(ExtractDatePart):
    fname = "year"

    def compute_from_days(self, days):
        return civil_from_days(days)[0]

"""Casts (counterpart of the JAX package's ``sql/exprs/cast.py``: the
fixed-width conversion matrix ``cast_data``, which comparisons also use to
promote operands, and the ``Cast`` expression between the numeric types,
bool, date and timestamp; casts to and from strings wait for the string
slice, ROADMAP A.5, and stay on the CPU with that reason).

Non-ANSI Spark semantics, Java-style conversions: int -> narrower int
wraps; float -> int maps NaN to 0, clamps out-of-range values and
truncates toward zero; timestamp <-> long is *seconds*; date <-> timestamp
scales by a day of microseconds.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import pandas as pd
import torch

from spark_rapids_tpu_torch.columnar import dtypes
from spark_rapids_tpu_torch.columnar.batch import Schema
from spark_rapids_tpu_torch.columnar.dtype import DType, torch_dtype
from spark_rapids_tpu_torch.sql.exprs.core import (
    DevCol, DevScalar, DevValue, EvalContext, Expression,
)

_INT_RANGE = {
    "int8": (-128, 127),
    "int16": (-(1 << 15), (1 << 15) - 1),
    "int32": (-(1 << 31), (1 << 31) - 1),
    "int64": (-(1 << 63), (1 << 63) - 1),
}

MICROS_PER_SEC = 1_000_000
MICROS_PER_DAY = 86_400 * MICROS_PER_SEC


def cast_data(data: torch.Tensor, src: DType, dst: DType):
    """Cast raw (already null-canonicalized) data. Returns (data,
    extra_null) where extra_null marks rows that become NULL."""
    if src == dst:
        return data, None
    tdt = torch_dtype(dst.np_dtype)
    if src == dtypes.BOOL:
        return data.to(tdt), None
    if dst == dtypes.BOOL:
        return data != 0, None
    if src.is_integral and (dst.is_integral or dst.is_floating):
        return data.to(tdt), None
    if src.is_floating and dst.is_integral:
        lo, hi = _INT_RANGE[dst.name]
        d64 = data.to(torch.float64)
        out = torch.where(torch.isnan(d64), torch.zeros_like(d64), d64)
        return out.trunc().clamp(float(lo), float(hi)).to(tdt), None
    if src.is_floating and dst.is_floating:
        return data.to(tdt), None
    if src == dtypes.TIMESTAMP_US and dst.is_integral:
        return torch.div(data, MICROS_PER_SEC,
                         rounding_mode="floor").to(tdt), None
    if src.is_integral and dst == dtypes.TIMESTAMP_US:
        return data.to(torch.int64) * MICROS_PER_SEC, None
    if src == dtypes.TIMESTAMP_US and dst == dtypes.DATE32:
        return torch.div(data, MICROS_PER_DAY,
                         rounding_mode="floor").to(torch.int32), None
    if src == dtypes.DATE32 and dst == dtypes.TIMESTAMP_US:
        return data.to(torch.int64) * MICROS_PER_DAY, None
    if src == dtypes.TIMESTAMP_US and dst.is_floating:
        return (data.to(torch.float64) / MICROS_PER_SEC).to(tdt), None
    raise NotImplementedError(f"cast {src} -> {dst}")


def _castable(src: DType, dst: DType) -> bool:
    if src.is_string or dst.is_string:
        return False
    try:
        cast_data(torch.zeros(1, dtype=torch_dtype(src.np_dtype)), src, dst)
        return True
    except NotImplementedError:
        return False


_STRING_CAST = ("casts to and from strings need the string slice, not "
                "ported yet (ROADMAP A.5)")


class Cast(Expression):
    """CAST(x AS to) over the fixed-width matrix of ``cast_data``."""

    def __init__(self, child: Expression, to: DType):
        super().__init__([child])
        self.to = to

    def dtype(self, schema: Schema) -> DType:
        return self.to

    def __repr__(self) -> str:
        return f"CAST({self.children[0]!r} AS {self.to.name})"

    def device_supported(self, schema: Schema) -> Optional[str]:
        src = self.children[0].dtype(schema)
        if src == self.to:
            return None
        if src.is_string or self.to.is_string:
            return _STRING_CAST
        if not _castable(src, self.to):
            return f"cast {src} -> {self.to} is not supported"
        return None

    def eval_device(self, ctx: EvalContext) -> DevValue:
        v = self.children[0].eval_device(ctx)
        if v.dtype == self.to:
            return v
        if isinstance(v, DevScalar):
            data, _extra = cast_data(v.value, v.dtype, self.to)
            return DevScalar(self.to, data, v.valid)
        data, extra = cast_data(v.data, v.dtype, self.to)
        validity = v.validity if extra is None else v.validity & ~extra
        return DevCol(self.to, data, validity)

    def eval_host(self, df: pd.DataFrame) -> pd.Series:
        from spark_rapids_tpu_torch.columnar.batch import _pandas_col_dtype
        from spark_rapids_tpu_torch.sql.exprs.hostutil import (
            host_unary_values, rebuild_series,
        )
        s = self.children[0].eval_host(df)
        values, validity, index = host_unary_values(s)
        src = _pandas_col_dtype(s)
        if s.attrs.get("srt_logical_dtype") == "date32":
            src = dtypes.DATE32
            values = (values.astype(np.int64) // 86_400_000_000).astype(
                np.int32)
        if src == self.to:
            return s
        if src.is_string or self.to.is_string:
            raise NotImplementedError(f"CAST {src} -> {self.to}: "
                                      + _STRING_CAST)
        data, extra = cast_data(torch.from_numpy(np.require(
            values, requirements=["C", "W"])), src, self.to)
        if extra is not None:
            validity = validity & ~extra.numpy()
        return rebuild_series(data.numpy(), validity, self.to, index)

"""Casts (counterpart of the JAX package's ``sql/exprs/cast.py``; the
fixed-width conversion matrix ``cast_data`` is ported, which comparisons
use to promote operands; the ``Cast`` expression and string casts wait
for a later slice).

Non-ANSI Spark semantics, Java-style conversions: int -> narrower int
wraps; float -> int maps NaN to 0, clamps out-of-range values and
truncates toward zero; timestamp <-> long is *seconds*; date <-> timestamp
scales by a day of microseconds.
"""

from __future__ import annotations

import torch

from spark_rapids_tpu_torch.columnar import dtypes
from spark_rapids_tpu_torch.columnar.dtype import DType, torch_dtype

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

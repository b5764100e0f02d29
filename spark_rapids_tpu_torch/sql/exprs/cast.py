"""Casts (counterpart of the JAX package's ``sql/exprs/cast.py``: the
fixed-width conversion matrix ``cast_data``, which comparisons also use to
promote operands, and the ``Cast`` expression between the numeric types,
bool, date, timestamp and strings).

String arms, as in the JAX package: integers, booleans and dates render to
strings on the device (``ops/strings.py``); floats and timestamps render on
the CPU. Strings parse to integers and dates on the device only under
``spark.rapids.sql.castStringToInteger.enabled`` and
``castStringToDate.enabled`` (off by default); every other string parse
stays on the CPU. The host path (``cast_strings_host``) is the JAX
package's: an unparseable string becomes NULL. ``ToDate`` is ``to_date``: a
cast to date whose string arm has the JAX package's own tag.

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


def float_to_int_java(x: torch.Tensor, int_name: str) -> torch.Tensor:
    """Java's (long)/(int) of an integral-valued float: NaN -> 0, values
    past the type's range saturate at its bounds. float(2^63 - 1) rounds
    up to 2^63, which no int64 holds, so the top is saturated
    explicitly."""
    lo, hi = _INT_RANGE[int_name]
    d64 = x.to(torch.float64)
    d64 = torch.where(torch.isnan(d64), torch.zeros_like(d64), d64)
    out = d64.clamp(float(lo), float(hi)).to(torch_dtype(
        np.dtype(int_name)))
    return torch.where(d64 >= float(hi), torch.full_like(out, hi), out)


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
        return float_to_int_java(data.trunc(), dst.name), None
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


def cast_strings_host(values, validity, src: DType, dst: DType):
    """String-involved casts on the host path (the JAX package's
    ``_cast_strings_host``, non-ANSI Spark semantics: unparseable strings
    become NULL)."""
    import re
    n = len(values)
    if dst.is_string:
        out = np.empty(n, dtype=object)
        for i in range(n):
            if not validity[i]:
                out[i] = None
                continue
            v = values[i]
            if src == dtypes.BOOL:
                out[i] = "true" if v else "false"
            elif src == dtypes.DATE32:
                out[i] = str(np.datetime64(int(v), "D"))
            elif src == dtypes.TIMESTAMP_US:
                out[i] = str(np.datetime64(int(v), "us")).replace("T", " ")
            elif src.is_floating:
                fv = float(v)
                if np.isnan(fv):
                    out[i] = "NaN"
                elif np.isinf(fv):
                    out[i] = "Infinity" if fv > 0 else "-Infinity"
                else:
                    out[i] = repr(fv)
            elif src.is_string:
                out[i] = v
            else:
                out[i] = str(int(v))
        return out, validity.copy()
    out_validity = validity.copy()
    out = np.full(n, dtypes.null_fill_value(dst), dtype=dst.np_dtype)
    for i in range(n):
        if not validity[i]:
            continue
        # the ASCII whitespace set the device parsers strip too
        text = str(values[i]).strip(" \t\n\r\v\f")
        try:
            if dst == dtypes.BOOL:
                low = text.lower()
                if low in ("true", "t", "yes", "y", "1"):
                    out[i] = True
                elif low in ("false", "f", "no", "n", "0"):
                    out[i] = False
                else:
                    raise ValueError(text)
            elif dst.is_integral:
                if not re.match(r"^[+-]?\d+(\.\d*)?$", text, re.ASCII):
                    raise ValueError(text)
                v = int(text.split(".")[0])
                lo, hi = _INT_RANGE[dst.name]
                if not lo <= v <= hi:
                    raise ValueError(text)
                out[i] = v
            elif dst.is_floating:
                out[i] = float(text)
            elif dst == dtypes.DATE32:
                if not re.match(r"^\d{4}-\d{2}-\d{2}", text, re.ASCII):
                    raise ValueError(text)
                out[i] = (np.datetime64(text[:10], "D")
                          - np.datetime64(0, "D")).astype(np.int32)
            elif dst == dtypes.TIMESTAMP_US:
                if not re.match(r"^\d{4}-\d{2}-\d{2}", text, re.ASCII):
                    raise ValueError(text)
                out[i] = np.datetime64(text.replace(" ", "T"),
                                       "us").astype(np.int64)
            else:
                raise ValueError(f"cast string -> {dst}")
        except (ValueError, OverflowError):
            out_validity[i] = False
    return out, out_validity


def _conf_on(conf, key: str) -> bool:
    return conf is not None and conf.get_bool(key, False)


class Cast(Expression):
    """CAST(x AS to) over the fixed-width matrix of ``cast_data`` and the
    string arms of ``ops/strings.py``."""

    def __init__(self, child: Expression, to: DType):
        super().__init__([child])
        self.to = to

    def dtype(self, schema: Schema) -> DType:
        return self.to

    def __repr__(self) -> str:
        return f"CAST({self.children[0]!r} AS {self.to.name})"

    def device_supported(self, schema: Schema) -> Optional[str]:
        return self.device_supported_in(schema, None)

    def device_supported_in(self, schema: Schema, conf) -> Optional[str]:
        """The JAX package's tags; the session's ``conf`` opens the string
        parses."""
        src = self.children[0].dtype(schema)
        if src == self.to:
            return None
        if self.to.is_string:
            if src.is_integral or src == dtypes.BOOL or src == dtypes.DATE32:
                return None
            return (f"cast {src} -> string formatting is not supported "
                    "on TPU")
        if src.is_string:
            if self.to.is_integral and _conf_on(
                    conf, "spark.rapids.sql.castStringToInteger.enabled"):
                return None
            if self.to == dtypes.DATE32 and _conf_on(
                    conf, "spark.rapids.sql.castStringToDate.enabled"):
                return None
            return (f"cast {src} -> {self.to} involves string parsing and "
                    "is gated off by default "
                    "(see spark.rapids.sql.castStringTo*)")
        if not _castable(src, self.to):
            return f"cast {src} -> {self.to} is not supported"
        return None

    def eval_device(self, ctx: EvalContext) -> DevValue:
        v = self.children[0].eval_device(ctx)
        if v.dtype == self.to:
            return v
        if self.to.is_string or v.dtype.is_string:
            return self._eval_device_string(ctx, v)
        if isinstance(v, DevScalar):
            data, _extra = cast_data(v.value, v.dtype, self.to)
            return DevScalar(self.to, data, v.valid)
        data, extra = cast_data(v.data, v.dtype, self.to)
        validity = v.validity if extra is None else v.validity & ~extra
        return DevCol(self.to, data, validity)

    def _eval_device_string(self, ctx: EvalContext, v) -> DevValue:
        from spark_rapids_tpu_torch.ops import strings as string_ops
        if isinstance(v, DevScalar) and v.dtype.is_string:
            # a string literal parses on the host into a typed scalar
            if not v.valid or v.value is None:
                return DevScalar(self.to, None if self.to.is_string else 0,
                                 False)
            host, ok = cast_strings_host(np.array([v.value], dtype=object),
                                         np.array([True]), v.dtype, self.to)
            return DevScalar(self.to, host[0], bool(ok[0]))
        v = ctx.broadcast(v)
        if self.to.is_string:
            if v.dtype == dtypes.BOOL:
                return string_ops.strings_from_choices(
                    ctx, v.data.to(torch.int32), ["false", "true"],
                    v.validity)
            if v.dtype == dtypes.DATE32:
                return string_ops.date_to_string(ctx, v.data, v.validity)
            return string_ops.integral_to_string(ctx, v.data, v.validity)
        if self.to == dtypes.DATE32:
            days, ok = string_ops.string_to_date(ctx, v)
            return DevCol(self.to, days, v.validity & ok)
        data, ok = string_ops.string_to_integral(ctx, v, self.to)
        data = torch.where(ok, data, torch.zeros_like(data))
        return DevCol(self.to, data.to(torch_dtype(self.to.np_dtype)),
                      v.validity & ok)

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
            data, validity = cast_strings_host(values, validity, src,
                                               self.to)
            return rebuild_series(data, validity, self.to, index)
        data, extra = cast_data(torch.from_numpy(np.require(
            values, requirements=["C", "W"])), src, self.to)
        if extra is not None:
            validity = validity & ~extra.numpy()
        return rebuild_series(data.numpy(), validity, self.to, index)


class ToDate(Cast):
    """to_date(x): a cast to date; over strings it parses (gated as the
    cast is, with the JAX package's own reason)."""

    def __init__(self, child: Expression):
        super().__init__(child, dtypes.DATE32)

    def __repr__(self) -> str:
        return f"to_date({self.children[0]!r})"

    def device_supported_in(self, schema: Schema, conf) -> Optional[str]:
        t = self.children[0].dtype(schema)
        if t.is_string:
            if _conf_on(conf, "spark.rapids.sql.castStringToDate.enabled"):
                return None
            return ("to_date over strings parses dates and is gated off "
                    "by default (spark.rapids.sql.castStringToDate.enabled)")
        return super().device_supported_in(schema, conf)

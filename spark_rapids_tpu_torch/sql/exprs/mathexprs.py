"""Math expressions (counterpart of the JAX package's
``sql/exprs/mathexprs.py``): the unary double functions (sqrt, exp,
expm1, ln, log2, log10, log1p, the trigonometric and hyperbolic ones,
cbrt, rint, signum, degrees, radians), ``pow``, ``atan2``, ``hypot``,
``round`` (HALF_UP), ``bround`` (HALF_EVEN), ``floor`` and ``ceil``.

Spark semantics: inputs coerce to double, domain errors give NaN (not
NULL), as java.lang.Math does. One torch formula serves the device and the
host path (there over CPU tensors).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import pandas as pd
import torch

from spark_rapids_tpu_torch.columnar import dtypes
from spark_rapids_tpu_torch.columnar.batch import Schema, _pandas_col_dtype
from spark_rapids_tpu_torch.columnar.dtype import DType, torch_dtype
from spark_rapids_tpu_torch.sql.exprs.core import (
    DevCol, DevValue, EvalContext, Expression,
)
from spark_rapids_tpu_torch.sql.exprs.hostutil import (
    host_unary_values, rebuild_series,
)


def _host_tensor(values: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.require(values, requirements=["C", "W"]))


class UnaryMath(Expression):
    """A double function of one operand (the input coerced to double);
    domain errors give NaN or an infinity, not NULL, as java.lang.Math
    does."""
    fname = "?"

    def __init__(self, child: Expression):
        super().__init__([child])

    def dtype(self, schema: Schema) -> DType:
        return dtypes.FLOAT64

    def __repr__(self) -> str:
        return f"{self.fname}({self.children[0]!r})"

    def device_supported(self, schema: Schema) -> Optional[str]:
        if self.children[0].dtype(schema).is_string:
            return "string input"
        return None

    def compute(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def eval_device(self, ctx: EvalContext) -> DevValue:
        v = ctx.broadcast(self.children[0].eval_device(ctx))
        return DevCol(dtypes.FLOAT64, self.compute(v.data.to(torch.float64)),
                      v.validity)

    def eval_host(self, df: pd.DataFrame) -> pd.Series:
        values, validity, index = host_unary_values(
            self.children[0].eval_host(df))
        data = self.compute(_host_tensor(values).to(torch.float64)).numpy()
        return rebuild_series(data, validity, dtypes.FLOAT64, index)


def cbrt(x: torch.Tensor) -> torch.Tensor:
    """The real cube root (torch has none): sign(x) * |x|^(1/3), then one
    Newton step, y - (y^3 - |x|) / (3 y^2), which lands perfect cubes on
    their integer root. |x| past 2^+-900 is scaled by 2^-+300 first (the
    root by 2^-+100 after), so y^3 neither underflows into subnormals nor
    overflows. Zeros, infinities and NaN pass through."""
    a = x.abs()
    tiny, huge = a < 2.0 ** -900, a > 2.0 ** 900
    s = torch.where(tiny, a * 2.0 ** 300,
                    torch.where(huge, a * 2.0 ** -300, a))
    y = torch.pow(s, 1.0 / 3.0)
    safe = torch.where(y > 0, y, torch.ones_like(y))
    y = torch.where(torch.isfinite(s) & (s > 0),
                    y - (y * y * y - s) / (3.0 * safe * safe), y)
    y = torch.where(tiny, y * 2.0 ** -100,
                    torch.where(huge, y * 2.0 ** 100, y))
    return torch.where(x < 0, -y, torch.where(x == 0, x, y))


def signum(x: torch.Tensor) -> torch.Tensor:
    """sign(x) with NaN for NaN (``torch.sign`` gives 0) and +0.0 for
    either zero, as ``np.sign`` gives them."""
    return torch.where(torch.isnan(x), x, torch.sign(x) + 0.0)


def _big_cosh(x: torch.Tensor) -> torch.Tensor:
    """cosh(|x|) for |x| > 700, as (exp(|x|/2) / 2) * exp(|x|/2): the
    factors stay finite up to cosh's own overflow past 710.47, where
    torch's cosh and sinh already give inf from 710."""
    h = torch.exp(x.abs() * 0.5)
    return (h * 0.5) * h


def sinh(x: torch.Tensor) -> torch.Tensor:
    big = x.abs() > 700
    return torch.where(big, torch.copysign(_big_cosh(x), x), torch.sinh(x))


def cosh(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x.abs() > 700, _big_cosh(x), torch.cosh(x))


def log1p(x: torch.Tensor) -> torch.Tensor:
    """log1p, exact (x itself) for |x| < 2^-60, where torch on the CPU
    flushes subnormals to zero."""
    return torch.where(x.abs() < 2.0 ** -60, x, torch.log1p(x))


def _unary(name: str, cls_name: str, fn) -> type:
    return type(cls_name, (UnaryMath,), {
        "fname": name, "compute": lambda self, x, _fn=fn: _fn(x),
        "__doc__": f"{name}(x) over doubles."})


Sqrt = _unary("sqrt", "Sqrt", torch.sqrt)
Exp = _unary("exp", "Exp", torch.exp)
Expm1 = _unary("expm1", "Expm1", torch.expm1)
Log = _unary("ln", "Log", torch.log)
Log2 = _unary("log2", "Log2", torch.log2)
Log10 = _unary("log10", "Log10", torch.log10)
Log1p = _unary("log1p", "Log1p", log1p)
Sin = _unary("sin", "Sin", torch.sin)
Cos = _unary("cos", "Cos", torch.cos)
Tan = _unary("tan", "Tan", torch.tan)
Asin = _unary("asin", "Asin", torch.asin)
Acos = _unary("acos", "Acos", torch.acos)
Atan = _unary("atan", "Atan", torch.atan)
Sinh = _unary("sinh", "Sinh", sinh)
Cosh = _unary("cosh", "Cosh", cosh)
Tanh = _unary("tanh", "Tanh", torch.tanh)
Cbrt = _unary("cbrt", "Cbrt", cbrt)
Rint = _unary("rint", "Rint", torch.round)   # half to even, as np.rint
Signum = _unary("signum", "Signum", signum)
# numpy's constants: degrees(x) = x * (180 / pi), radians(x) = x * (pi / 180)
ToDegrees = _unary("degrees", "ToDegrees", lambda x: x * (180.0 / math.pi))
ToRadians = _unary("radians", "ToRadians", lambda x: x * (math.pi / 180.0))


class _BinaryMath(Expression):
    """A double function of two operands (both coerced to double); NULL
    where either is."""
    fname = "?"

    def __init__(self, left: Expression, right: Expression):
        super().__init__([left, right])

    def dtype(self, schema: Schema) -> DType:
        return dtypes.FLOAT64

    def __repr__(self) -> str:
        return (f"{self.fname}({self.children[0]!r}, "
                f"{self.children[1]!r})")

    def compute(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def eval_device(self, ctx: EvalContext) -> DevValue:
        lv = ctx.broadcast(self.children[0].eval_device(ctx))
        rv = ctx.broadcast(self.children[1].eval_device(ctx))
        data = self.compute(lv.data.to(torch.float64),
                            rv.data.to(torch.float64))
        return DevCol(dtypes.FLOAT64, data, lv.validity & rv.validity)

    def eval_host(self, df: pd.DataFrame) -> pd.Series:
        a, av, index = host_unary_values(self.children[0].eval_host(df))
        b, bv, _ = host_unary_values(self.children[1].eval_host(df))
        data = self.compute(_host_tensor(a).to(torch.float64),
                            _host_tensor(b).to(torch.float64)).numpy()
        return rebuild_series(data, av & bv, dtypes.FLOAT64, index)


class Pow(_BinaryMath):
    fname = "pow"

    def compute(self, a, b):
        return torch.pow(a, b)


class Atan2(_BinaryMath):
    fname = "atan2"

    def compute(self, a, b):
        return torch.atan2(a, b)


class Hypot(_BinaryMath):
    fname = "hypot"

    def compute(self, a, b):
        return torch.hypot(a, b)


class Round(Expression):
    """round(x, scale), Spark's HALF_UP: sign(x) * floor(|x| * 10^s + 0.5)
    / 10^s (``torch.round`` is HALF_EVEN). An integral input with a scale
    >= 0 is its own result."""

    def __init__(self, child: Expression, scale: int = 0):
        super().__init__([child])
        self.scale = int(scale)

    def dtype(self, schema: Schema) -> DType:
        t = self.children[0].dtype(schema)
        if t.is_integral and self.scale >= 0:
            return t
        return dtypes.FLOAT64

    def __repr__(self) -> str:
        return f"{self.fname}({self.children[0]!r}, {self.scale})"

    fname = "round"

    def device_supported(self, schema: Schema) -> Optional[str]:
        if self.children[0].dtype(schema).is_string:
            return "string input"
        return None

    def _compute(self, x: torch.Tensor) -> torch.Tensor:
        p = float(10.0 ** self.scale)
        x = x.to(torch.float64)
        y = torch.floor(x.abs() * p + 0.5) / p
        return torch.where(x < 0, -y, y)

    def _apply(self, data: torch.Tensor, dt: DType):
        if dt.is_integral and self.scale >= 0:
            return data, dt
        out = self._compute(data)
        return out.to(torch_dtype(dtypes.FLOAT64.np_dtype)), dtypes.FLOAT64

    def eval_device(self, ctx: EvalContext) -> DevValue:
        v = ctx.broadcast(self.children[0].eval_device(ctx))
        data, dt = self._apply(v.data, v.dtype)
        return DevCol(dt, data, v.validity)

    def eval_host(self, df: pd.DataFrame) -> pd.Series:
        s = self.children[0].eval_host(df)
        values, validity, index = host_unary_values(s)
        data, dt = self._apply(_host_tensor(values), _pandas_col_dtype(s))
        return rebuild_series(data.numpy(), validity, dt, index)


class BRound(Round):
    """bround(x, scale): HALF_EVEN (banker's) rounding, rint(x * 10^s) /
    10^s."""

    fname = "bround"

    def _compute(self, x: torch.Tensor) -> torch.Tensor:
        p = float(10.0 ** self.scale)
        return torch.round(x.to(torch.float64) * p) / p


class Floor(Expression):
    """floor(x) -> INT64 (Spark's LongType): Java's (long) of the floored
    double, so NaN gives 0 and values past the range saturate.

    ``floor(a / b)`` over INTEGER ``a`` and ``b`` is an exact int64 floor
    division instead of a float divide and a floor (the JAX package's
    rewrite, exact over all of int64 where the double rounds above
    2^53; NULL where ``b`` is 0, as the divide is). Mortgage's josh_mody
    columns are this shape. One formula serves the device and the host."""
    fname = "floor"

    def __init__(self, child: Expression):
        super().__init__([child])

    def dtype(self, schema: Schema) -> DType:
        return dtypes.INT64

    def __repr__(self) -> str:
        return f"{self.fname}({self.children[0]!r})"

    def device_supported(self, schema: Schema) -> Optional[str]:
        if self.children[0].dtype(schema).is_string:
            return "string input"
        return None

    def _int_div_expr(self):
        """The Divide under this node when both its operands are
        integers (decided from their types, without evaluating them; the
        operands are bound, so no schema is needed), else None."""
        from spark_rapids_tpu_torch.sql.exprs.arithmetic import Divide
        ch = self.children[0]
        if not isinstance(ch, Divide):
            return None
        try:
            ldt = ch.children[0].dtype(None)
            rdt = ch.children[1].dtype(None)
        except Exception:  # noqa: BLE001 — unresolvable statically
            return None
        if ldt.is_integral and rdt.is_integral:
            return ch
        return None

    def _int_div(self, a: torch.Tensor, b: torch.Tensor):
        a, b = a.to(torch.int64), b.to(torch.int64)
        zero = b == 0
        safe = torch.where(zero, torch.ones_like(b), b)
        q = (torch.div(a, safe, rounding_mode="floor") if self.fname ==
             "floor" else -torch.div(-a, safe, rounding_mode="floor"))
        return q, ~zero

    def _compute(self, x: torch.Tensor) -> torch.Tensor:
        from spark_rapids_tpu_torch.sql.exprs.cast import float_to_int_java
        x = x.to(torch.float64)
        fx = torch.floor(x) if self.fname == "floor" else torch.ceil(x)
        return float_to_int_java(fx, "int64")

    def eval_device(self, ctx: EvalContext) -> DevValue:
        intdiv = self._int_div_expr()
        if intdiv is not None:
            lv = ctx.broadcast(intdiv.children[0].eval_device(ctx))
            rv = ctx.broadcast(intdiv.children[1].eval_device(ctx))
            q, nz = self._int_div(lv.data, rv.data)
            return DevCol(dtypes.INT64, q, lv.validity & rv.validity & nz)
        v = ctx.broadcast(self.children[0].eval_device(ctx))
        return DevCol(dtypes.INT64, self._compute(v.data), v.validity)

    def eval_host(self, df: pd.DataFrame) -> pd.Series:
        intdiv = self._int_div_expr()
        if intdiv is not None:
            a, avalid, index = host_unary_values(
                intdiv.children[0].eval_host(df))
            b, bvalid, _ = host_unary_values(intdiv.children[1].eval_host(df))
            q, nz = self._int_div(_host_tensor(a), _host_tensor(b))
            return rebuild_series(q.numpy(), avalid & bvalid & nz.numpy(),
                                  dtypes.INT64, index)
        values, validity, index = host_unary_values(
            self.children[0].eval_host(df))
        data = self._compute(_host_tensor(values)).numpy()
        return rebuild_series(data, validity, dtypes.INT64, index)


class Ceil(Floor):
    fname = "ceil"

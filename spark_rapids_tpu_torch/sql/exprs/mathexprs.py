"""Math expressions (counterpart of the JAX package's
``sql/exprs/mathexprs.py``; ``sqrt``, ``round`` (HALF_UP), ``bround``
(HALF_EVEN), ``floor`` and ``ceil`` are ported, what TPCxBB, Mortgage and
the central-moment aggregates reach; the other unary functions wait for
ROADMAP A.6).

Spark semantics: inputs coerce to double, domain errors give NaN (not
NULL), as java.lang.Math does. One torch formula serves the device and the
host path (there over CPU tensors).
"""

from __future__ import annotations

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


class Sqrt(Expression):
    def __init__(self, child: Expression):
        super().__init__([child])

    def dtype(self, schema: Schema) -> DType:
        return dtypes.FLOAT64

    def __repr__(self) -> str:
        return f"sqrt({self.children[0]!r})"

    def device_supported(self, schema: Schema) -> Optional[str]:
        if self.children[0].dtype(schema).is_string:
            return "string input"
        return None

    def eval_device(self, ctx: EvalContext) -> DevValue:
        v = ctx.broadcast(self.children[0].eval_device(ctx))
        return DevCol(dtypes.FLOAT64, torch.sqrt(v.data.to(torch.float64)),
                      v.validity)

    def eval_host(self, df: pd.DataFrame) -> pd.Series:
        values, validity, index = host_unary_values(
            self.children[0].eval_host(df))
        data = torch.sqrt(_host_tensor(values).to(torch.float64)).numpy()
        return rebuild_series(data, validity, dtypes.FLOAT64, index)


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

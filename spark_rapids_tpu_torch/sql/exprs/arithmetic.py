"""Arithmetic expressions (counterpart of the JAX package's
``sql/exprs/arithmetic.py``: + - * /, ``div``, % and pmod, unary minus
and ``abs``).

Spark SQL non-ANSI semantics: integer overflow wraps, as Java's does (so
``-INT64_MIN`` and ``abs(INT64_MIN)`` stay INT64_MIN); ``/`` always
produces double and divide-by-zero yields NULL.
"""

from __future__ import annotations

import numpy as np
import pandas as pd
import torch

from spark_rapids_tpu_torch.columnar import dtypes
from spark_rapids_tpu_torch.columnar.batch import Schema
from spark_rapids_tpu_torch.columnar.dtype import DType, common_type, torch_dtype
from spark_rapids_tpu_torch.sql.exprs.core import (
    DevCol, DevScalar, DevValue, EvalContext, Expression, data_of, valid_and,
)
from spark_rapids_tpu_torch.sql.exprs.hostutil import (
    host_binary_values, host_unary_values, rebuild_series,
)


class BinaryArithmetic(Expression):
    symbol = "?"

    def __init__(self, left: Expression, right: Expression):
        super().__init__([left, right])

    def dtype(self, schema: Schema) -> DType:
        return self.dtype_from_children(self.children[0].dtype(schema),
                                        self.children[1].dtype(schema))

    def dtype_from_children(self, lt: DType, rt: DType) -> DType:
        return common_type(lt, rt)

    def compute(self, a, b):
        """(data, extra_null_mask or None)."""
        raise NotImplementedError

    def eval_device(self, ctx: EvalContext) -> DevValue:
        lv = self.children[0].eval_device(ctx)
        rv = self.children[1].eval_device(ctx)
        out_dt = self.dtype_from_children(lv.dtype, rv.dtype)
        tdt = torch_dtype(out_dt.np_dtype)
        a = data_of(ctx, lv).to(tdt)
        b = data_of(ctx, rv).to(tdt)
        data, extra_null = self.compute(a, b)
        data = data.expand(ctx.capacity)
        validity = valid_and(ctx, lv, rv)
        if extra_null is not None:
            extra_null = extra_null.expand(ctx.capacity)
            validity = validity & ~extra_null
            data = torch.where(extra_null, dtypes.null_fill_value(out_dt),
                               data)
        return DevCol(out_dt, data, validity)

    def eval_host(self, df: pd.DataFrame) -> pd.Series:
        # the device formula, on CPU tensors over the host values
        ls = self.children[0].eval_host(df)
        rs = self.children[1].eval_host(df)
        (a, b), validity, index = host_binary_values(ls, rs)
        out_dt = self.dtype_from_children(dtypes.from_numpy(a.dtype),
                                          dtypes.from_numpy(b.dtype))
        tdt = torch_dtype(out_dt.np_dtype)
        data, extra_null = self.compute(
            torch.from_numpy(np.require(a, requirements=["C", "W"])).to(tdt),
            torch.from_numpy(np.require(b, requirements=["C", "W"])).to(tdt))
        if extra_null is not None:
            validity = validity & ~extra_null.numpy()
        return rebuild_series(data.numpy(), validity, out_dt, index)


class Add(BinaryArithmetic):
    symbol = "+"

    def compute(self, a, b):
        return a + b, None


class Subtract(BinaryArithmetic):
    symbol = "-"

    def compute(self, a, b):
        return a - b, None


class Multiply(BinaryArithmetic):
    symbol = "*"

    def compute(self, a, b):
        return a * b, None


class Divide(BinaryArithmetic):
    """Spark Divide: inputs coerced to double; x/0 -> NULL."""
    symbol = "/"

    def dtype_from_children(self, lt: DType, rt: DType) -> DType:
        return dtypes.FLOAT64

    def compute(self, a, b):
        zero = b == 0.0
        safe = torch.where(zero, torch.ones_like(b), b)
        return a / safe, zero


class IntegralDivide(BinaryArithmetic):
    """Spark's ``div``: long division truncating toward zero; x div 0 is
    NULL. The JAX package's formula, sign(a) * sign(b) * (|a| // |b|),
    wrapping as it does at INT64_MIN."""
    symbol = "div"

    def dtype_from_children(self, lt: DType, rt: DType) -> DType:
        return dtypes.INT64

    def compute(self, a, b):
        zero = b == 0
        safe = torch.where(zero, torch.ones_like(b), b)
        q = torch.sign(a) * torch.sign(safe) * torch.div(
            torch.abs(a), torch.abs(safe), rounding_mode="floor")
        return q, zero


class Remainder(BinaryArithmetic):
    """Java-style ``%``: the sign of the dividend; x % 0 -> NULL."""
    symbol = "%"

    def compute(self, a, b):
        zero = b == 0
        safe = torch.where(zero, torch.ones_like(b), b)
        return torch.fmod(a, safe), zero


class Pmod(BinaryArithmetic):
    """pmod(a, b): ((a % b) + b) % b, the sign of the divisor; b = 0 ->
    NULL."""
    symbol = "pmod"

    def __repr__(self) -> str:
        return f"pmod({self.children[0]!r}, {self.children[1]!r})"

    def compute(self, a, b):
        zero = b == 0
        safe = torch.where(zero, torch.ones_like(b), b)
        return torch.fmod(torch.fmod(a, safe) + safe, safe), zero


class _UnaryArithmetic(Expression):
    """A same-typed function of one operand; a literal folds."""
    fname = "?"

    def __init__(self, child: Expression):
        super().__init__([child])

    def dtype(self, schema: Schema) -> DType:
        return self.children[0].dtype(schema)

    def __repr__(self) -> str:
        return f"{self.fname}({self.children[0]!r})"

    def compute(self, x):
        raise NotImplementedError

    def eval_device(self, ctx: EvalContext) -> DevValue:
        v = self.children[0].eval_device(ctx)
        if isinstance(v, DevScalar):
            return DevScalar(v.dtype, self.compute(v.value), v.valid)
        return DevCol(v.dtype, self.compute(v.data), v.validity)

    def eval_host(self, df: pd.DataFrame) -> pd.Series:
        values, validity, index = host_unary_values(
            self.children[0].eval_host(df))
        data = self.compute(torch.from_numpy(
            np.require(values, requirements=["C", "W"]))).numpy()
        return rebuild_series(data, validity,
                              dtypes.from_numpy(values.dtype), index)


class UnaryMinus(_UnaryArithmetic):
    fname = "-"

    def compute(self, x):
        return torch.neg(x)


class Abs(_UnaryArithmetic):
    fname = "abs"

    def compute(self, x):
        return torch.abs(x)

"""Arithmetic expressions (counterpart of the JAX package's
``sql/exprs/arithmetic.py``; + - * /, % and pmod are ported).

Spark SQL non-ANSI semantics: integer overflow wraps; ``/`` always
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
    DevCol, DevValue, EvalContext, Expression, data_of, valid_and,
)
from spark_rapids_tpu_torch.sql.exprs.hostutil import (
    host_binary_values, rebuild_series,
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

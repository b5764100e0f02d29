"""Null-aware n-ary expressions (counterpart of the JAX package's
``sql/exprs/nullexprs.py``; ``greatest`` over numbers is ported, which the
central-moment aggregates use to clamp a variance at zero; ``least``,
string operands and the rest of the module wait for ROADMAP A.6).
"""

from __future__ import annotations

import functools
from typing import List, Optional

import numpy as np
import pandas as pd
import torch

from spark_rapids_tpu_torch.columnar.batch import Schema
from spark_rapids_tpu_torch.columnar.dtype import DType, common_type
from spark_rapids_tpu_torch.sql.exprs.core import (
    DevCol, DevValue, EvalContext, Expression,
)


class Greatest(Expression):
    """greatest(): the null-skipping n-ary maximum (NULL only where every
    operand is). NaN is greater than any other double, as in Spark."""

    def __init__(self, children: List[Expression]):
        assert len(children) >= 2, "greatest needs at least 2 args"
        super().__init__(children)

    def dtype(self, schema: Schema) -> DType:
        return functools.reduce(common_type,
                                [c.dtype(schema) for c in self.children])

    def __repr__(self) -> str:
        return f"greatest({', '.join(map(repr, self.children))})"

    def device_supported(self, schema: Schema) -> Optional[str]:
        if self.dtype(schema).is_string:
            return ("string operands need the row-select string kernel, "
                    "not ported yet (ROADMAP A.5)")
        return None

    def _fold(self, pairs, dt: DType):
        """(data, validity) of the maximum over (data, validity) pairs of
        one dtype; ``pairs`` are torch tensors."""
        out, ov = pairs[0]
        for d, v in pairs[1:]:
            if dt.is_floating:
                # NaN is the greatest value
                win = torch.where(torch.isnan(d), ~torch.isnan(out),
                                  ~torch.isnan(out) & (d > out))
            else:
                win = d > out
            better = torch.where(ov & v, win, v & ~ov)
            out = torch.where(better, d, out)
            ov = ov | v
        return out, ov

    def eval_device(self, ctx: EvalContext) -> DevValue:
        from spark_rapids_tpu_torch.sql.exprs.cast import cast_data
        cols = [ctx.broadcast(c.eval_device(ctx)) for c in self.children]
        dt = functools.reduce(common_type, [c.dtype for c in cols])
        pairs = [(cast_data(c.data, c.dtype, dt)[0], c.validity)
                 for c in cols]
        data, validity = self._fold(pairs, dt)
        return DevCol(dt, data, validity)

    def eval_host(self, df: pd.DataFrame) -> pd.Series:
        from spark_rapids_tpu_torch.columnar.batch import _pandas_col_dtype
        from spark_rapids_tpu_torch.sql.exprs.cast import cast_data
        from spark_rapids_tpu_torch.sql.exprs.hostutil import (
            host_unary_values, rebuild_series,
        )
        series = [c.eval_host(df) for c in self.children]
        dts = [_pandas_col_dtype(s) for s in series]
        dt = functools.reduce(common_type, dts)
        pairs = []
        for s, t in zip(series, dts):
            values, validity, _ = host_unary_values(s)
            data, _x = cast_data(torch.from_numpy(np.require(
                values, requirements=["C", "W"])), t, dt)
            pairs.append((data, torch.from_numpy(validity)))
        data, validity = self._fold(pairs, dt)
        return rebuild_series(data.numpy(), validity.numpy(), dt, df.index)


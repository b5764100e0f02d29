"""Null-aware n-ary expressions (counterpart of the JAX package's
``sql/exprs/nullexprs.py``): ``greatest`` and ``least`` over numbers and
strings (the central-moment aggregates use ``greatest`` to clamp a
variance at zero). The rest of the module waits for ROADMAP A.6.
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


class _GreatestLeast(Expression):
    """greatest()/least(): the null-skipping n-ary maximum/minimum (NULL
    only where every operand is). NaN is greater than any other double, as
    in Spark. Strings compare in byte order and the winner's value moves
    with ``ops/strings.select_strings`` (any string form)."""
    is_greatest = True

    def __init__(self, children: List[Expression]):
        assert len(children) >= 2, "greatest/least need at least 2 args"
        super().__init__(children)

    def dtype(self, schema: Schema) -> DType:
        return functools.reduce(common_type,
                                [c.dtype(schema) for c in self.children])

    def __repr__(self) -> str:
        fn = "greatest" if self.is_greatest else "least"
        return f"{fn}({', '.join(map(repr, self.children))})"

    def _wins(self, d, out, dt: DType):
        """bool: ``d`` beats ``out`` (both valid)."""
        if dt.is_floating:
            if self.is_greatest:  # NaN is the greatest value
                return torch.where(torch.isnan(d), ~torch.isnan(out),
                                   ~torch.isnan(out) & (d > out))
            return ~torch.isnan(d) & (torch.isnan(out) | (d < out))
        return d > out if self.is_greatest else d < out

    def _fold(self, pairs, dt: DType):
        """(data, validity) of the winner over (data, validity) pairs of
        one dtype; ``pairs`` are torch tensors."""
        out, ov = pairs[0]
        for d, v in pairs[1:]:
            better = torch.where(ov & v, self._wins(d, out, dt), v & ~ov)
            out = torch.where(better, d, out)
            ov = ov | v
        return out, ov

    def eval_device(self, ctx: EvalContext) -> DevValue:
        from spark_rapids_tpu_torch.sql.exprs.cast import cast_data
        cols = [ctx.broadcast(c.eval_device(ctx)) for c in self.children]
        dt = functools.reduce(common_type, [c.dtype for c in cols])
        if dt.is_string:
            from spark_rapids_tpu_torch.ops import strings as string_ops
            out = cols[0]
            for nxt in cols[1:]:
                cmp = string_ops.string_compare_columns(nxt, out)
                win = cmp > 0 if self.is_greatest else cmp < 0
                better = torch.where(out.validity & nxt.validity, win,
                                     nxt.validity & ~out.validity)
                out = string_ops.select_strings(
                    better, nxt, out, out.validity | nxt.validity)
            return out
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
        if dt.is_string:
            out_data = out_valid = None
            for s in series:
                vals, valid, _ = host_unary_values(s)
                # null slots compare as "" and never win (validity gates)
                data = np.where(valid, np.asarray(vals, dtype=object), "")
                if out_data is None:
                    out_data, out_valid = data.copy(), valid.copy()
                    continue
                win = np.array([(x > y) if self.is_greatest else (x < y)
                                for x, y in zip(data, out_data)], dtype=bool)
                better = np.where(out_valid & valid, win, valid & ~out_valid)
                out_data = np.where(better, data, out_data)
                out_valid = out_valid | valid
            return rebuild_series(np.where(out_valid, out_data, None),
                                  out_valid, dt, df.index)
        pairs = []
        for s, t in zip(series, dts):
            values, validity, _ = host_unary_values(s)
            data, _x = cast_data(torch.from_numpy(np.require(
                values, requirements=["C", "W"])), t, dt)
            pairs.append((data, torch.from_numpy(validity)))
        data, validity = self._fold(pairs, dt)
        return rebuild_series(data.numpy(), validity.numpy(), dt, df.index)


class Greatest(_GreatestLeast):
    is_greatest = True


class Least(_GreatestLeast):
    is_greatest = False

"""Null-aware n-ary expressions (counterpart of the JAX package's
``sql/exprs/nullexprs.py``): ``greatest`` and ``least`` over numbers and
strings (the central-moment aggregates use ``greatest`` to clamp a
variance at zero), ``AtLeastNNonNulls`` (``df.na.drop(thresh=n)``) and
``NormalizeNaNAndZero`` (one NaN, +0.0 for -0.0, before hashing or
grouping floats).
"""

from __future__ import annotations

import functools
import math
from typing import List

import numpy as np
import pandas as pd
import torch

from spark_rapids_tpu_torch.columnar import dtypes
from spark_rapids_tpu_torch.columnar.batch import Schema
from spark_rapids_tpu_torch.columnar.dtype import DType, common_type
from spark_rapids_tpu_torch.sql.exprs.core import (
    DevCol, DevValue, EvalContext, Expression,
)
from spark_rapids_tpu_torch.sql.exprs.hostutil import (
    host_unary_values, rebuild_series,
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
        """bool: ``d`` beats ``out`` (both valid); NaN is the greatest
        value."""
        return (_nan_aware_gt(d, out) if self.is_greatest
                else _nan_aware_lt(d, out))

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


def _nan_aware_gt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a > b, NaN greater than every other double (Spark's order)."""
    if a.is_floating_point():
        return (a > b) | (torch.isnan(a) & ~torch.isnan(b))
    return a > b


def _nan_aware_lt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.is_floating_point():
        return (a < b) | (torch.isnan(b) & ~torch.isnan(a))
    return a < b


class AtLeastNNonNulls(Expression):
    """Spark's predicate behind ``df.na.drop(thresh=n)``: at least ``n``
    of the children are non-NULL (and, for floats, not NaN)."""

    def __init__(self, n: int, children: List[Expression]):
        super().__init__(children)
        self.n = int(n)

    def dtype(self, schema: Schema) -> DType:
        return dtypes.BOOL

    def __repr__(self) -> str:
        args = ", ".join(map(repr, self.children))
        return f"atleastnnonnulls({self.n}, {args})"

    def eval_device(self, ctx: EvalContext) -> DevValue:
        count = torch.zeros((ctx.capacity,), dtype=torch.int32,
                            device=ctx.device)
        for c in self.children:
            v = ctx.broadcast(c.eval_device(ctx))
            ok = v.validity
            if v.data is not None and v.data.is_floating_point():
                ok = ok & ~torch.isnan(v.data)
            count = count + ok.to(torch.int32)
        out = count >= self.n
        return DevCol(dtypes.BOOL, out, torch.ones_like(out))

    def eval_host(self, df: pd.DataFrame) -> pd.Series:
        count = np.zeros(len(df), dtype=np.int32)
        index = df.index
        for c in self.children:
            vals, valid, index = host_unary_values(c.eval_host(df))
            ok = valid.copy()
            if vals.dtype.kind == "f":
                ok &= ~np.isnan(vals)
            count += ok.astype(np.int32)
        return pd.Series(count >= self.n, index=index)


class NormalizeNaNAndZero(Expression):
    """Floats made canonical before hashing or grouping: every NaN the
    same bits, -0.0 as +0.0 (reference: NormalizeFloatingNumbers.scala).
    The identity for other types."""

    def __init__(self, child: Expression):
        super().__init__([child])

    def dtype(self, schema: Schema) -> DType:
        return self.children[0].dtype(schema)

    def __repr__(self) -> str:
        return repr(self.children[0])

    @staticmethod
    def _normalize(x: torch.Tensor) -> torch.Tensor:
        x = x + 0.0                       # -0.0 + 0.0 == +0.0
        return torch.where(torch.isnan(x), torch.full_like(x, math.nan), x)

    def eval_device(self, ctx: EvalContext) -> DevValue:
        v = ctx.broadcast(self.children[0].eval_device(ctx))
        if v.data is None or not v.data.is_floating_point():
            return v
        return DevCol(v.dtype, self._normalize(v.data), v.validity)

    def eval_host(self, df: pd.DataFrame) -> pd.Series:
        from spark_rapids_tpu_torch.columnar.batch import _pandas_col_dtype
        s = self.children[0].eval_host(df)
        vals, valid, index = host_unary_values(s)
        if vals.dtype.kind != "f":
            return s
        data = self._normalize(torch.from_numpy(
            np.require(vals, requirements=["C", "W"]))).numpy()
        return rebuild_series(data, valid, _pandas_col_dtype(s), index)

"""Predicates and boolean logic (counterpart of the JAX package's
``sql/exprs/predicates.py``): comparisons, the null-safe ``<=>``, Kleene
AND and OR, NOT, IN, IS NULL, IS NOT NULL and ``isnan``.
String comparisons go to ``ops/strings`` (``string_equal`` for ``=`` and
``!=``, ``string_compare`` for the order comparisons), over dictionary
codes and char slabs, against a literal or another column.

SQL three-valued logic is computed explicitly on (data, validity) pairs.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import pandas as pd
import torch

from spark_rapids_tpu_torch.columnar import dtypes
from spark_rapids_tpu_torch.columnar.batch import Schema
from spark_rapids_tpu_torch.columnar.dtype import DType, common_type
from spark_rapids_tpu_torch.sql.exprs.core import (
    DevCol, DevScalar, DevValue, EvalContext, Expression, data_of,
    valid_and,
)
from spark_rapids_tpu_torch.sql.exprs.hostutil import (
    host_binary_values, host_unary_values, rebuild_series,
)


class BinaryComparison(Expression):
    symbol = "?"

    def __init__(self, left: Expression, right: Expression):
        super().__init__([left, right])

    def dtype(self, schema: Schema) -> DType:
        return dtypes.BOOL

    def compute(self, a, b):
        raise NotImplementedError

    def eval_device(self, ctx: EvalContext) -> DevValue:
        lv = self.children[0].eval_device(ctx)
        rv = self.children[1].eval_device(ctx)
        if lv.dtype.is_string or rv.dtype.is_string:
            return self._eval_device_string(ctx, lv, rv)
        ct = common_type(lv.dtype, rv.dtype) if lv.dtype != rv.dtype \
            else lv.dtype
        data = self.compute(_promote(ctx, lv, ct), _promote(ctx, rv, ct))
        return DevCol(dtypes.BOOL, data.expand(ctx.capacity),
                      valid_and(ctx, lv, rv))

    def eval_host(self, df: pd.DataFrame) -> pd.Series:
        ls = self.children[0].eval_host(df)
        rs = self.children[1].eval_host(df)
        (a, b), validity, index = host_binary_values(ls, rs)
        if a.dtype == object or b.dtype == object:  # strings
            a = np.where(validity, np.asarray(a, dtype=object), "")
            b = np.where(validity, np.asarray(b, dtype=object), "")
            ops = {Eq: lambda x, y: x == y, Neq: lambda x, y: x != y,
                   Lt: lambda x, y: x < y, Le: lambda x, y: x <= y,
                   Gt: lambda x, y: x > y, Ge: lambda x, y: x >= y}
            op = ops[type(self)]
            data = np.array([op(x, y) for x, y in zip(a, b)],
                            dtype=np.bool_)
        else:
            ct = common_type(dtypes.from_numpy(a.dtype),
                             dtypes.from_numpy(b.dtype))
            data = self.compute(torch.from_numpy(a.astype(ct.np_dtype)),
                                torch.from_numpy(b.astype(ct.np_dtype))
                                ).numpy()
        return rebuild_series(data, validity, dtypes.BOOL, index)

    def _eval_device_string(self, ctx: EvalContext, lv: DevValue,
                            rv: DevValue) -> DevValue:
        from spark_rapids_tpu_torch.ops import strings as string_ops
        if isinstance(self, (Eq, Neq)):
            eq, validity = string_ops.string_equal(ctx, lv, rv)
            return DevCol(dtypes.BOOL, eq if isinstance(self, Eq) else ~eq,
                          validity)
        cmp, validity = string_ops.string_compare(ctx, lv, rv)
        return DevCol(dtypes.BOOL, self.compute(cmp, 0), validity)


class Eq(BinaryComparison):
    symbol = "="

    def compute(self, a, b):
        return a == b


class Neq(BinaryComparison):
    symbol = "!="

    def compute(self, a, b):
        return a != b


class Lt(BinaryComparison):
    symbol = "<"

    def compute(self, a, b):
        return a < b


class Le(BinaryComparison):
    symbol = "<="

    def compute(self, a, b):
        return a <= b


class Gt(BinaryComparison):
    symbol = ">"

    def compute(self, a, b):
        return a > b


class Ge(BinaryComparison):
    symbol = ">="

    def compute(self, a, b):
        return a >= b


class EqNullSafe(BinaryComparison):
    """``<=>``: never NULL; NULL <=> NULL is TRUE, NULL <=> x FALSE."""
    symbol = "<=>"

    def compute(self, a, b):
        return a == b

    def eval_device(self, ctx: EvalContext) -> DevValue:
        lv = self.children[0].eval_device(ctx)
        rv = self.children[1].eval_device(ctx)
        if lv.dtype.is_string or rv.dtype.is_string:
            from spark_rapids_tpu_torch.ops import strings as string_ops
            eq, _ = string_ops.string_equal(ctx, lv, rv)
        else:
            ct = common_type(lv.dtype, rv.dtype) if lv.dtype != rv.dtype \
                else lv.dtype
            eq = self.compute(_promote(ctx, lv, ct),
                              _promote(ctx, rv, ct)).expand(ctx.capacity)
        lval, rval = _validity_vec(ctx, lv), _validity_vec(ctx, rv)
        data = (lval & rval & eq) | (~lval & ~rval)
        return DevCol(dtypes.BOOL, data, torch.ones_like(data))

    def eval_host(self, df: pd.DataFrame) -> pd.Series:
        av, amask, index = host_unary_values(self.children[0].eval_host(df))
        bv, bmask, _ = host_unary_values(self.children[1].eval_host(df))
        if av.dtype == object or bv.dtype == object:
            eq = np.array([x == y for x, y in zip(av, bv)], dtype=np.bool_)
        else:
            ct = common_type(dtypes.from_numpy(av.dtype),
                             dtypes.from_numpy(bv.dtype))
            eq = av.astype(ct.np_dtype) == bv.astype(ct.np_dtype)
        data = (amask & bmask & eq) | (~amask & ~bmask)
        return rebuild_series(data, np.ones(len(data), np.bool_), dtypes.BOOL,
                              index)


def _promote(ctx: EvalContext, v: DevValue, ct: DType):
    """Raw data promoted to the common type, scaling date->timestamp
    properly via the cast matrix."""
    from spark_rapids_tpu_torch.sql.exprs.cast import cast_data
    data = data_of(ctx, v)
    if v.dtype == ct:
        return data
    out, _ = cast_data(data, v.dtype, ct)
    return out


class And(Expression):
    """Kleene AND: FALSE AND NULL = FALSE."""

    def __init__(self, left: Expression, right: Expression):
        super().__init__([left, right])

    def dtype(self, schema: Schema) -> DType:
        return dtypes.BOOL

    def eval_device(self, ctx: EvalContext) -> DevValue:
        lv = ctx.broadcast(self.children[0].eval_device(ctx))
        rv = ctx.broadcast(self.children[1].eval_device(ctx))
        # invalid slots are canonicalized to False so a & b is right
        # wherever the result is valid
        a, av = lv.data & lv.validity, lv.validity
        b, bv = rv.data & rv.validity, rv.validity
        validity = (av & bv) | (av & ~a) | (bv & ~b)
        return DevCol(dtypes.BOOL, a & b, validity)

    def eval_host(self, df: pd.DataFrame) -> pd.Series:
        a, av, index = host_unary_values(self.children[0].eval_host(df))
        b, bv, _ = host_unary_values(self.children[1].eval_host(df))
        a = a.astype(np.bool_) & av  # canonicalize null slots to False
        b = b.astype(np.bool_) & bv
        validity = (av & bv) | (av & ~a) | (bv & ~b)
        return rebuild_series(a & b, validity, dtypes.BOOL, index)


class Or(Expression):
    """Kleene OR: TRUE OR NULL = TRUE."""

    def __init__(self, left: Expression, right: Expression):
        super().__init__([left, right])

    def dtype(self, schema: Schema) -> DType:
        return dtypes.BOOL

    def eval_device(self, ctx: EvalContext) -> DevValue:
        lv = ctx.broadcast(self.children[0].eval_device(ctx))
        rv = ctx.broadcast(self.children[1].eval_device(ctx))
        a, av = lv.data & lv.validity, lv.validity
        b, bv = rv.data & rv.validity, rv.validity
        validity = (av & bv) | (av & a) | (bv & b)
        return DevCol(dtypes.BOOL, a | b, validity)

    def eval_host(self, df: pd.DataFrame) -> pd.Series:
        a, av, index = host_unary_values(self.children[0].eval_host(df))
        b, bv, _ = host_unary_values(self.children[1].eval_host(df))
        a = a.astype(np.bool_) & av
        b = b.astype(np.bool_) & bv
        validity = (av & bv) | (av & a) | (bv & b)
        return rebuild_series(a | b, validity, dtypes.BOOL, index)


class Not(Expression):
    """NOT: NULL stays NULL."""

    def __init__(self, child: Expression):
        super().__init__([child])

    def dtype(self, schema: Schema) -> DType:
        return dtypes.BOOL

    def eval_device(self, ctx: EvalContext) -> DevValue:
        v = ctx.broadcast(self.children[0].eval_device(ctx))
        return DevCol(dtypes.BOOL, ~v.data & v.validity, v.validity)

    def eval_host(self, df: pd.DataFrame) -> pd.Series:
        a, av, index = host_unary_values(self.children[0].eval_host(df))
        return rebuild_series(~a.astype(np.bool_) & av, av, dtypes.BOOL,
                              index)


class In(Expression):
    """value IN (<literals>). A NULL value gives NULL; a NULL in the list
    turns non-matches into NULL (SQL semantics). Over a dictionary column
    one host-built table gathered by code, over a char slab an OR of its
    literal equalities (``ops/strings.string_in``), over numbers an OR of
    compares."""

    def __init__(self, child: Expression, values: Sequence):
        super().__init__([child])
        self.values: List = list(values)

    def dtype(self, schema: Schema) -> DType:
        return dtypes.BOOL

    def __repr__(self) -> str:
        return f"({self.children[0]!r} IN {tuple(self.values)})"

    def eval_device(self, ctx: EvalContext) -> DevValue:
        v = self.children[0].eval_device(ctx)
        has_null = any(x is None for x in self.values)
        vals = [x for x in self.values if x is not None]
        if isinstance(v, DevScalar) and v.dtype.is_string:
            # a string literal: decided on the host
            hit = v.valid and str(v.value) in {str(x) for x in vals}
            match = torch.full((ctx.capacity,), hit, dtype=torch.bool,
                               device=ctx.device)
            valid = torch.full((ctx.capacity,), bool(v.valid),
                               dtype=torch.bool, device=ctx.device)
        elif v.dtype.is_string:
            from spark_rapids_tpu_torch.ops import strings as string_ops
            match = string_ops.string_in(ctx, v, [str(x) for x in vals])
            valid = v.validity
        else:
            v = ctx.broadcast(v)
            match = torch.zeros_like(v.validity)
            for x in vals:
                match |= v.data == np.asarray(
                    x, dtype=v.dtype.np_dtype).item()
            valid = v.validity
        validity = valid & match if has_null else valid
        return DevCol(dtypes.BOOL, match & valid, validity)

    def eval_host(self, df: pd.DataFrame) -> pd.Series:
        a, av, index = host_unary_values(self.children[0].eval_host(df))
        has_null = any(x is None for x in self.values)
        vals = [x for x in self.values if x is not None]
        if a.dtype == object:
            match = np.array([x in vals for x in a], dtype=np.bool_)
        else:
            match = np.isin(a, np.asarray(vals, dtype=a.dtype))
        validity = av & match if has_null else av
        return rebuild_series(match & av, validity, dtypes.BOOL, index)


def _validity_vec(ctx: EvalContext, v: DevValue) -> torch.Tensor:
    if isinstance(v, DevScalar):
        return torch.full((ctx.capacity,), bool(v.valid), dtype=torch.bool,
                          device=ctx.device)
    return v.validity


class IsNull(Expression):
    """``x IS NULL``: never NULL itself."""

    def __init__(self, child: Expression):
        super().__init__([child])

    def dtype(self, schema: Schema) -> DType:
        return dtypes.BOOL

    def __repr__(self) -> str:
        return f"({self.children[0]!r} IS NULL)"

    def eval_device(self, ctx: EvalContext) -> DevValue:
        validity = _validity_vec(ctx, self.children[0].eval_device(ctx))
        return DevCol(dtypes.BOOL, ~validity, torch.ones_like(validity))

    def eval_host(self, df: pd.DataFrame) -> pd.Series:
        _, validity, index = host_unary_values(self.children[0].eval_host(df))
        return pd.Series(~validity, index=index)


class IsNotNull(Expression):
    """``x IS NOT NULL``: never NULL itself."""

    def __init__(self, child: Expression):
        super().__init__([child])

    def dtype(self, schema: Schema) -> DType:
        return dtypes.BOOL

    def __repr__(self) -> str:
        return f"({self.children[0]!r} IS NOT NULL)"

    def eval_device(self, ctx: EvalContext) -> DevValue:
        validity = _validity_vec(ctx, self.children[0].eval_device(ctx))
        return DevCol(dtypes.BOOL, validity.clone(),
                      torch.ones_like(validity))

    def eval_host(self, df: pd.DataFrame) -> pd.Series:
        _, validity, index = host_unary_values(self.children[0].eval_host(df))
        return pd.Series(validity.copy(), index=index)


class IsNan(Expression):
    """``isnan(x)``: never NULL, isnan(NULL) is FALSE."""

    def __init__(self, child: Expression):
        super().__init__([child])

    def dtype(self, schema: Schema) -> DType:
        return dtypes.BOOL

    def __repr__(self) -> str:
        return f"isnan({self.children[0]!r})"

    def eval_device(self, ctx: EvalContext) -> DevValue:
        v = ctx.broadcast(self.children[0].eval_device(ctx))
        data = torch.isnan(v.data) & v.validity
        return DevCol(dtypes.BOOL, data, torch.ones_like(data))

    def eval_host(self, df: pd.DataFrame) -> pd.Series:
        a, av, index = host_unary_values(self.children[0].eval_host(df))
        return pd.Series(np.isnan(a.astype(np.float64)) & av, index=index)

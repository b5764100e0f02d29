"""Predicates and boolean logic (counterpart of the JAX package's
``sql/exprs/predicates.py``; comparisons and Kleene AND are ported).
String ``=`` and ``!=`` go to ``ops/strings.string_equal`` (dictionary
columns against a literal); the other string comparisons raise.

SQL three-valued logic is computed explicitly on (data, validity) pairs.
"""

from __future__ import annotations

from spark_rapids_tpu_torch.columnar import dtypes
from spark_rapids_tpu_torch.columnar.batch import Schema
from spark_rapids_tpu_torch.columnar.dtype import DType, common_type
from spark_rapids_tpu_torch.sql.exprs.core import (
    DevCol, DevValue, EvalContext, Expression, data_of, valid_and,
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

    def _eval_device_string(self, ctx: EvalContext, lv: DevValue,
                            rv: DevValue) -> DevValue:
        if not isinstance(self, (Eq, Neq)):
            raise NotImplementedError(
                f"string comparison {self.symbol} is not ported yet")
        from spark_rapids_tpu_torch.ops import strings as string_ops
        eq, validity = string_ops.string_equal(ctx, lv, rv)
        return DevCol(dtypes.BOOL, eq if isinstance(self, Eq) else ~eq,
                      validity)


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

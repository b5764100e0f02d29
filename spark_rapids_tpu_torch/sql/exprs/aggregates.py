"""Aggregate functions (counterpart of the JAX package's
``sql/exprs/aggregates.py``; sum, count, avg, min, max, first, last, the
central moments (var/stddev, sample and population), corr and count
distinct are ported).

Each aggregate declares *update* reductions over input expressions, *merge*
reductions over intermediate columns and a *finalize* expression — the
reference's CudfAggregate update/merge design that makes two-phase
aggregation work. SQL null semantics: aggregates skip NULLs; sum/min/max/avg
of an all-NULL (or empty) group is NULL; count is 0.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from spark_rapids_tpu_torch.columnar import dtypes
from spark_rapids_tpu_torch.columnar.batch import Schema
from spark_rapids_tpu_torch.columnar.dtype import DType
from spark_rapids_tpu_torch.sql.exprs.core import Expression


class AggregateFunction(Expression):
    """Children are the input value expressions."""

    is_aggregate = True

    def update_ops(self) -> List[Tuple[str, int]]:
        """[(reduction_kind, child_index)] producing intermediate columns."""
        raise NotImplementedError

    def merge_ops(self) -> List[str]:
        """Reduction kinds merging intermediates across batches."""
        raise NotImplementedError

    def intermediate_dtypes(self, schema: Schema) -> List[DType]:
        raise NotImplementedError

    def finalize(self, refs: List[Expression], schema: Schema) -> Expression:
        """Expression over intermediate refs computing the final value."""
        return refs[0]


def _sum_result_dtype(t: DType) -> DType:
    if t.is_integral or t == dtypes.BOOL:
        return dtypes.INT64
    return dtypes.FLOAT64


class Sum(AggregateFunction):
    def __init__(self, child: Expression):
        super().__init__([child])

    def dtype(self, schema: Schema) -> DType:
        return _sum_result_dtype(self.children[0].dtype(schema))

    def update_ops(self):
        return [("sum", 0)]

    def merge_ops(self):
        return ["sum"]

    def intermediate_dtypes(self, schema):
        return [self.dtype(schema)]


class Count(AggregateFunction):
    """count(expr): counts non-NULL rows. count(lit(1)) == count(*)."""

    def __init__(self, child: Expression):
        super().__init__([child])

    def dtype(self, schema: Schema) -> DType:
        return dtypes.INT64

    def update_ops(self):
        return [("count_valid", 0)]

    def merge_ops(self):
        return ["sum"]

    def intermediate_dtypes(self, schema):
        return [dtypes.INT64]


class _SelectAgg(AggregateFunction):
    """min/max/first/last: the value type is the intermediate and result."""

    kind = "?"

    def __init__(self, child: Expression):
        super().__init__([child])

    def dtype(self, schema: Schema) -> DType:
        return self.children[0].dtype(schema)

    def update_ops(self):
        return [(self.kind, 0)]

    def merge_ops(self):
        return [self.kind]

    def intermediate_dtypes(self, schema):
        return [self.dtype(schema)]


class Min(_SelectAgg):
    kind = "min"


class Max(_SelectAgg):
    kind = "max"


class First(_SelectAgg):
    kind = "first"

    def __init__(self, child: Expression, ignore_nulls: bool = False):
        super().__init__(child)
        if ignore_nulls:
            self.kind = "first_valid"


class Last(_SelectAgg):
    kind = "last"

    def __init__(self, child: Expression, ignore_nulls: bool = False):
        super().__init__(child)
        if ignore_nulls:
            self.kind = "last_valid"


class Average(AggregateFunction):
    def __init__(self, child: Expression):
        super().__init__([child])

    def dtype(self, schema: Schema) -> DType:
        return dtypes.FLOAT64

    def update_ops(self):
        return [("sum", 0), ("count_valid", 0)]

    def merge_ops(self):
        return ["sum", "sum"]

    def intermediate_dtypes(self, schema):
        return [dtypes.FLOAT64, dtypes.INT64]

    def finalize(self, refs, schema):
        from spark_rapids_tpu_torch.sql.exprs.arithmetic import Divide
        # Divide yields NULL on a zero count: avg(empty) = NULL
        return Divide(refs[0], refs[1])


def _float(e: Expression) -> Expression:
    from spark_rapids_tpu_torch.sql.exprs.cast import Cast
    return Cast(e, dtypes.FLOAT64)


def _null_if_other_null(value: Expression, other: Expression) -> Expression:
    """``value`` where ``other`` is non-NULL, else NULL: the pairwise
    deletion of the bivariate moments (SQL corr skips a row where either
    input is NULL)."""
    from spark_rapids_tpu_torch.sql.exprs.conditional import If
    from spark_rapids_tpu_torch.sql.exprs.core import Literal
    from spark_rapids_tpu_torch.sql.exprs.predicates import IsNotNull
    return If(IsNotNull(other), value, Literal(None, dtypes.FLOAT64))


class _CentralMoment(AggregateFunction):
    """var/stddev from the sufficient statistics (n, sum x, sum x^2): three
    plain sums that merge by +, across batches and partitions."""

    sample = True  # n - 1 denominator
    fname = "?"

    def __init__(self, child: Expression):
        from spark_rapids_tpu_torch.sql.exprs.arithmetic import Multiply
        x = _float(child)
        super().__init__([x, Multiply(x, x)])

    def dtype(self, schema: Schema) -> DType:
        return dtypes.FLOAT64

    def __repr__(self) -> str:
        return f"{self.fname}({self.children[0]!r})"

    def update_ops(self):
        return [("count_valid", 0), ("sum", 0), ("sum", 1)]

    def merge_ops(self):
        return ["sum", "sum", "sum"]

    def intermediate_dtypes(self, schema):
        return [dtypes.INT64, dtypes.FLOAT64, dtypes.FLOAT64]

    def _variance(self, refs):
        from spark_rapids_tpu_torch.sql.exprs.arithmetic import (
            Divide, Multiply, Subtract,
        )
        from spark_rapids_tpu_torch.sql.exprs.cast import Cast
        from spark_rapids_tpu_torch.sql.exprs.core import Literal
        from spark_rapids_tpu_torch.sql.exprs.nullexprs import Greatest
        n, sx, sxx = refs
        nf = Cast(n, dtypes.FLOAT64)
        # sum (x - mean)^2 = sum x^2 - (sum x)^2 / n, clamped at 0 against
        # the rounding residue
        ss = Greatest([Subtract(sxx, Divide(Multiply(sx, sx), nf)),
                       Literal(0.0)])
        denom = Subtract(nf, Literal(1.0)) if self.sample else nf
        # a zero denominator gives NULL: var_samp of 1 row, var_pop of 0
        return Divide(ss, denom)

    def finalize(self, refs, schema):
        return self._variance(refs)


class VarSamp(_CentralMoment):
    sample = True
    fname = "var_samp"


class VarPop(_CentralMoment):
    sample = False
    fname = "var_pop"


class StddevSamp(_CentralMoment):
    sample = True
    fname = "stddev_samp"

    def finalize(self, refs, schema):
        from spark_rapids_tpu_torch.sql.exprs.mathexprs import Sqrt
        return Sqrt(self._variance(refs))


class StddevPop(_CentralMoment):
    sample = False
    fname = "stddev_pop"

    def finalize(self, refs, schema):
        from spark_rapids_tpu_torch.sql.exprs.mathexprs import Sqrt
        return Sqrt(self._variance(refs))


class Corr(AggregateFunction):
    """Pearson correlation from the pair count and five pairwise-masked
    sums, all merged by +."""

    def __init__(self, left: Expression, right: Expression):
        from spark_rapids_tpu_torch.sql.exprs.arithmetic import Multiply
        x, y = _float(left), _float(right)
        xm = _null_if_other_null(x, y)
        ym = _null_if_other_null(y, x)
        super().__init__([xm, ym, Multiply(x, y),
                          Multiply(xm, xm), Multiply(ym, ym)])

    def dtype(self, schema: Schema) -> DType:
        return dtypes.FLOAT64

    def __repr__(self) -> str:
        return "corr(...)"

    def update_ops(self):
        return [("count_valid", 2), ("sum", 0), ("sum", 1),
                ("sum", 2), ("sum", 3), ("sum", 4)]

    def merge_ops(self):
        return ["sum"] * 6

    def intermediate_dtypes(self, schema):
        return [dtypes.INT64] + [dtypes.FLOAT64] * 5

    def finalize(self, refs, schema):
        from spark_rapids_tpu_torch.sql.exprs.arithmetic import (
            Divide, Multiply, Subtract,
        )
        from spark_rapids_tpu_torch.sql.exprs.cast import Cast
        from spark_rapids_tpu_torch.sql.exprs.core import Literal
        from spark_rapids_tpu_torch.sql.exprs.mathexprs import Sqrt
        from spark_rapids_tpu_torch.sql.exprs.nullexprs import Greatest
        n, sx, sy, sxy, sxx, syy = refs
        nf = Cast(n, dtypes.FLOAT64)
        cov = Subtract(sxy, Divide(Multiply(sx, sy), nf))
        vx = Greatest([Subtract(sxx, Divide(Multiply(sx, sx), nf)),
                       Literal(0.0)])
        vy = Greatest([Subtract(syy, Divide(Multiply(sy, sy), nf)),
                       Literal(0.0)])
        # a zero variance gives sqrt 0, and Divide gives NULL
        return Divide(cov, Sqrt(Multiply(vx, vy)))


class CountDistinct(AggregateFunction):
    """count(DISTINCT expr). Never executed itself: the DataFrame layer
    (``GroupedData._agg_with_distinct``) rewrites an aggregation holding
    it into two levels, a group-by over keys + expr, then a group-by over
    the keys counting the now-unique expr values."""

    is_distinct = True

    def __init__(self, child: Expression):
        super().__init__([child])

    def dtype(self, schema: Schema) -> DType:
        return dtypes.INT64

    def __repr__(self) -> str:
        return f"count(DISTINCT {self.children[0]!r})"

    def _not_executable(self):
        raise RuntimeError(
            "CountDistinct must be rewritten by the grouped-aggregation "
            "planner before execution")

    def update_ops(self):
        self._not_executable()

    def merge_ops(self):
        self._not_executable()

    def intermediate_dtypes(self, schema):
        self._not_executable()

    def device_supported(self, schema: Schema) -> Optional[str]:
        return None


def find_aggregates(expr: Expression) -> List[AggregateFunction]:
    if isinstance(expr, AggregateFunction):
        return [expr]
    out = []
    for c in expr.children:
        out.extend(find_aggregates(c))
    return out

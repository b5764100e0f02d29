"""Aggregate functions (counterpart of the JAX package's
``sql/exprs/aggregates.py``; sum, count, avg, min, max, first and last are
ported).

Each aggregate declares *update* reductions over input expressions, *merge*
reductions over intermediate columns and a *finalize* expression — the
reference's CudfAggregate update/merge design that makes two-phase
aggregation work. SQL null semantics: aggregates skip NULLs; sum/min/max/avg
of an all-NULL (or empty) group is NULL; count is 0.
"""

from __future__ import annotations

from typing import List, Tuple

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


def find_aggregates(expr: Expression) -> List[AggregateFunction]:
    if isinstance(expr, AggregateFunction):
        return [expr]
    out = []
    for c in expr.children:
        out.extend(find_aggregates(c))
    return out

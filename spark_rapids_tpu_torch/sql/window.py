"""Window specifications and window expressions (copy of the JAX
package's ``sql/window.py``, which is free of JAX).

reference: GpuWindowExec.scala (202) + GpuWindowExpression.scala (723) —
the reference supports Count/Sum/Min/Max/RowNumber over row frames and
time-range frames (GpuWindowExpression.scala:47-56,139,198). The JAX
package adds rank/dense_rank/lead/lag and general cumulative range frames.
Bounded ROW frames run sum/count/avg via prefix-sum differencing and
min/max via unrolled shifts (narrow) or a sparse-table variable-window
reduction (wide). Bounded RANGE frames (the reference's time-range
frames) run on device over a single ascending nulls-first non-float
order column via per-row binary search; descending / nulls-last /
float order columns fall back to the CPU oracle with a reason.

API mirrors pyspark.sql.Window:

  w = Window.partition_by("k").order_by("ts")
  df.with_column("rn", F.row_number().over(w))
  df.with_column("cum", F.sum("v").over(w))
  w2 = w.rows_between(-3, Window.CURRENT_ROW)
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

from spark_rapids_tpu_torch.columnar import dtypes
from spark_rapids_tpu_torch.sql.exprs.core import Expression

UNBOUNDED_PRECEDING = -(1 << 62)
UNBOUNDED_FOLLOWING = 1 << 62
CURRENT_ROW = 0


def is_bounded_range(frame_kind: str, lo: int, hi: int) -> bool:
    """True for RANGE frames with numeric offsets (vs the cumulative /
    whole-partition forms) — shared by the capability tagger and both
    executors so frame classification cannot drift."""
    return frame_kind == "range" and (
        lo > UNBOUNDED_PRECEDING
        or (hi != CURRENT_ROW and hi < UNBOUNDED_FOLLOWING))


class WindowSpec:
    def __init__(self, partition_cols: Sequence[Expression] = (),
                 orders: Sequence = (),
                 frame: Optional[Tuple[str, int, int]] = None):
        self.partition_cols = list(partition_cols)
        self.orders = list(orders)
        self.frame = frame  # (kind 'rows'|'range', lo, hi) or None

    def partition_by(self, *cols) -> "WindowSpec":
        from spark_rapids_tpu_torch.sql.functions import _c
        return WindowSpec([_c(c) for c in cols], self.orders, self.frame)

    def order_by(self, *cols) -> "WindowSpec":
        from spark_rapids_tpu_torch.sql.functions import SortOrder, _c
        orders = []
        for c in cols:
            if isinstance(c, SortOrder):
                orders.append(c)
            else:
                orders.append(SortOrder(_c(c)))
        return WindowSpec(self.partition_cols, orders, self.frame)

    def rows_between(self, lo: int, hi: int) -> "WindowSpec":
        return WindowSpec(self.partition_cols, self.orders, ("rows", lo, hi))

    def range_between(self, lo: int, hi: int) -> "WindowSpec":
        return WindowSpec(self.partition_cols, self.orders, ("range", lo, hi))

    def resolved_frame(self, is_ranking: bool) -> Tuple[str, int, int]:
        """Spark's frame defaulting: ranking fns use their own semantics;
        aggregates default to RANGE UNBOUNDED PRECEDING..CURRENT ROW when
        ordered, else the whole partition."""
        if self.frame is not None:
            return self.frame
        if is_ranking or self.orders:
            return ("range", UNBOUNDED_PRECEDING, CURRENT_ROW)
        return ("rows", UNBOUNDED_PRECEDING, UNBOUNDED_FOLLOWING)


class Window:
    """pyspark.sql.Window-compatible entry points."""

    unboundedPreceding = UNBOUNDED_PRECEDING
    unboundedFollowing = UNBOUNDED_FOLLOWING
    currentRow = CURRENT_ROW

    @staticmethod
    def partition_by(*cols) -> WindowSpec:
        return WindowSpec().partition_by(*cols)

    partitionBy = partition_by

    @staticmethod
    def order_by(*cols) -> WindowSpec:
        return WindowSpec().order_by(*cols)

    orderBy = order_by


class RankingFunction(Expression):
    """Base for row_number/rank/dense_rank (no value child)."""

    def __init__(self):
        super().__init__([])

    def dtype(self, schema) -> dtypes.DType:
        return dtypes.INT32

    def __repr__(self):
        return type(self).__name__


class RowNumber(RankingFunction):
    pass


class Rank(RankingFunction):
    pass


class DenseRank(RankingFunction):
    pass


class LeadLag(Expression):
    """lead/lag: value of ``child`` offset rows ahead/behind within the
    partition (Spark: offset positive = lead direction)."""

    def __init__(self, child: Expression, offset: int, default=None,
                 is_lead: bool = True):
        super().__init__([child])
        self.offset = offset
        self.default = default
        self.is_lead = is_lead

    def dtype(self, schema) -> dtypes.DType:
        return self.children[0].dtype(schema)

    def __repr__(self):
        kind = "lead" if self.is_lead else "lag"
        return f"{kind}({self.children[0]!r}, {self.offset})"


class WindowExpression(Expression):
    """One windowed computation: function + spec (reference:
    GpuWindowExpression wrapping WindowFunction + WindowSpecDefinition)."""

    def __init__(self, fn: Expression, spec: WindowSpec):
        super().__init__([fn])
        self.fn = fn
        self.spec = spec

    def dtype(self, schema) -> dtypes.DType:
        return self.fn.dtype(schema)

    def __repr__(self):
        return (f"{self.fn!r} OVER ({self.spec.partition_cols}, "
                f"{self.spec.orders})")

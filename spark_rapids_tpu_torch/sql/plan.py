"""Logical plan nodes (counterpart of the JAX package's ``sql/plan.py``,
holding the nodes the port plans: Scan, Range, Project, Filter, Aggregate,
Sort, Limit, Repartition, Coalesce, Union, Expand and the join: equi,
cross or on a condition; windows, generators and writes wait for later
slices).

The tag/convert rewrite works on the physical plan (``sql/overrides.py``);
these nodes only carry what the planner needs.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from spark_rapids_tpu_torch.columnar import dtype as dtypes
from spark_rapids_tpu_torch.columnar.batch import Schema
from spark_rapids_tpu_torch.sql.exprs.core import Col, Expression
from spark_rapids_tpu_torch.sql.functions import SortOrder


class LogicalPlan:
    def __init__(self, children: Sequence["LogicalPlan"] = ()):
        self.children: List[LogicalPlan] = list(children)

    def schema(self) -> Schema:
        raise NotImplementedError

    @property
    def name(self) -> str:
        return type(self).__name__

    def estimated_size_bytes(self) -> Optional[int]:
        """Broadcast-join size hint: a one-child operator passes its
        child's estimate through, anything else is unknown (None)."""
        if len(self.children) == 1:
            return self.children[0].estimated_size_bytes()
        return None

    def walk(self):
        yield self
        for c in self.children:
            yield from c.walk()


class LogicalScan(LogicalPlan):
    def __init__(self, source):
        super().__init__()
        self.source = source

    def schema(self) -> Schema:
        return self.source.schema

    def estimated_size_bytes(self) -> Optional[int]:
        return self.source.estimated_size_bytes()


class LogicalRange(LogicalPlan):
    def __init__(self, start: int, end: int, step: int, num_partitions: int):
        super().__init__()
        self.start, self.end, self.step = start, end, step
        self.num_partitions = num_partitions

    def schema(self) -> Schema:
        return Schema(["id"], [dtypes.INT64])


class LogicalProject(LogicalPlan):
    def __init__(self, child: LogicalPlan,
                 exprs: Sequence[Tuple[str, Expression]]):
        super().__init__([child])
        self.exprs = list(exprs)

    def schema(self) -> Schema:
        cs = self.children[0].schema()
        return Schema([n for n, _ in self.exprs],
                      [e.dtype(cs) for _, e in self.exprs])


class LogicalFilter(LogicalPlan):
    def __init__(self, child: LogicalPlan, condition: Expression):
        super().__init__([child])
        self.condition = condition

    def schema(self) -> Schema:
        return self.children[0].schema()


class LogicalAggregate(LogicalPlan):
    def __init__(self, child: LogicalPlan,
                 grouping: Sequence[Tuple[str, Expression]],
                 results: Sequence[Tuple[str, Expression]]):
        super().__init__([child])
        self.grouping = list(grouping)
        self.results = list(results)

    def schema(self) -> Schema:
        cs = self.children[0].schema()
        # a key result is a Col(output name): its dtype is the grouping
        # expression's, not that of a child column the name may shadow
        gdt = {n: e.dtype(cs) for n, e in self.grouping}
        dts = [gdt[e.name] if isinstance(e, Col) and e.name in gdt
               else e.dtype(cs) for _, e in self.results]
        return Schema([n for n, _ in self.results], dts)


class LogicalSort(LogicalPlan):
    def __init__(self, child: LogicalPlan, orders: Sequence[SortOrder],
                 is_global: bool = True):
        super().__init__([child])
        self.orders = list(orders)
        self.is_global = is_global

    def schema(self) -> Schema:
        return self.children[0].schema()


class LogicalLimit(LogicalPlan):
    def __init__(self, child: LogicalPlan, limit: int):
        super().__init__([child])
        self.limit = limit

    def schema(self) -> Schema:
        return self.children[0].schema()


class LogicalRepartition(LogicalPlan):
    """repartition(n): round-robin row redistribution."""

    def __init__(self, child: LogicalPlan, n: int):
        super().__init__([child])
        self.n = max(1, int(n))

    def schema(self) -> Schema:
        return self.children[0].schema()


class LogicalCoalesce(LogicalPlan):
    """coalesce(n): merge adjacent partitions, no shuffle."""

    def __init__(self, child: LogicalPlan, n: int):
        super().__init__([child])
        self.n = max(1, int(n))

    def schema(self) -> Schema:
        return self.children[0].schema()


class LogicalUnion(LogicalPlan):
    def schema(self) -> Schema:
        return self.children[0].schema()


class LogicalExpand(LogicalPlan):
    """Each input row emits one output row per projection set."""

    def __init__(self, child: LogicalPlan, projections):
        super().__init__([child])
        self.projections = [list(p) for p in projections]

    def schema(self) -> Schema:
        cs = self.children[0].schema()
        first = self.projections[0]
        return Schema([n for n, _ in first],
                      [e.dtype(cs) for _, e in first])


class LogicalJoin(LogicalPlan):
    """Join of two plans: on paired key expressions (an equi-join), on
    none (``join_type`` "cross"), or on a boolean ``condition`` over the
    combined columns (inner/cross, no keys). Semi and anti joins output
    the left side only."""

    def __init__(self, left: LogicalPlan, right: LogicalPlan, join_type: str,
                 left_keys: Sequence[Expression],
                 right_keys: Sequence[Expression],
                 condition: Optional[Expression] = None):
        super().__init__([left, right])
        self.join_type = join_type
        self.left_keys = list(left_keys)
        self.right_keys = list(right_keys)
        self.condition = condition

    def schema(self) -> Schema:
        ls = self.children[0].schema()
        rs = self.children[1].schema()
        if self.join_type in ("leftsemi", "leftanti"):
            return ls
        return Schema(list(ls.names) + list(rs.names),
                      list(ls.dtypes) + list(rs.dtypes))

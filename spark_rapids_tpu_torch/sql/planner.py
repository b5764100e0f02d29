"""Logical -> CPU physical planning (counterpart of the JAX package's
``sql/planner.py``).

Produces the plan shape Spark hands the reference's ColumnarRule:
aggregates split into partial + exchange + final, global sorts into an
exchange + sort, limits into local limit + single exchange + global limit.
The device rewrite (``sql/overrides.py``) then tags and converts this CPU
plan node by node. Joins, windows, generators and writes wait for later
slices, as does the JAX package's small-query fast path (the port's
exchange collapse makes no sync for it to save).
"""

from __future__ import annotations

from spark_rapids_tpu_torch.exec import cpu
from spark_rapids_tpu_torch.exec.aggutil import AggPlan, bind_non_agg
from spark_rapids_tpu_torch.exec.base import PhysicalPlan
from spark_rapids_tpu_torch.sql import plan as lp
from spark_rapids_tpu_torch.sql.exprs.core import BoundRef, bind_references
from spark_rapids_tpu_torch.sql.functions import SortOrder


class Planner:
    def __init__(self, conf):
        self.conf = conf

    def plan(self, node: lp.LogicalPlan) -> PhysicalPlan:
        fn = getattr(self, f"_plan_{type(node).__name__}", None)
        if fn is None:
            raise NotImplementedError(f"no physical plan for {node.name}")
        return fn(node)

    def _plan_LogicalScan(self, node: lp.LogicalScan) -> PhysicalPlan:
        source = node.source
        pruned = getattr(node, "_pruned_columns", None)
        if pruned is not None:
            source = source.with_columns(pruned)
        return cpu.CpuScanExec(source, source.schema)

    def _plan_LogicalFilter(self, node: lp.LogicalFilter) -> PhysicalPlan:
        child = self.plan(node.children[0])
        return cpu.CpuFilterExec(
            child, bind_references(node.condition, child.output_schema()))

    def _plan_LogicalRange(self, node: lp.LogicalRange) -> PhysicalPlan:
        return cpu.CpuRangeExec(node.start, node.end, node.step,
                                node.num_partitions)

    def _plan_LogicalProject(self, node: lp.LogicalProject) -> PhysicalPlan:
        child = self.plan(node.children[0])
        cs = child.output_schema()
        return cpu.CpuProjectExec(
            child, [(n, bind_references(e, cs)) for n, e in node.exprs])

    def _plan_LogicalAggregate(self, node: lp.LogicalAggregate
                               ) -> PhysicalPlan:
        child = self.plan(node.children[0])
        cs = child.output_schema()
        grouping = [(n, bind_references(e, cs)) for n, e in node.grouping]
        results = [(n, bind_non_agg(e, cs)) for n, e in node.results]
        plan = AggPlan(cs, grouping, results)
        partial = cpu.CpuHashAggregateExec(child, plan, "partial")
        if plan.num_keys == 0:
            exchange = cpu.CpuShuffleExchangeExec(partial, ("single",))
        else:
            exchange = cpu.CpuShuffleExchangeExec(
                partial, ("hash", list(range(plan.num_keys)),
                          self.conf.shuffle_partitions))
        return cpu.CpuHashAggregateExec(exchange, plan, "final")

    def _plan_LogicalSort(self, node: lp.LogicalSort) -> PhysicalPlan:
        child = self.plan(node.children[0])
        cs = child.output_schema()
        orders = [SortOrder(bind_references(o.expr, cs), o.ascending,
                            o.nulls_first) for o in node.orders]
        if node.is_global:
            # range partitioning when the keys are plain columns, one
            # partition otherwise
            n = self.conf.shuffle_partitions
            if all(isinstance(o.expr, BoundRef) for o in orders) and n > 1:
                child = cpu.CpuShuffleExchangeExec(
                    child, ("range", [o.expr.index for o in orders],
                            [o.ascending for o in orders],
                            [o.nulls_first for o in orders], n))
            else:
                child = cpu.CpuShuffleExchangeExec(child, ("single",))
        return cpu.CpuSortExec(child, orders)

    def _plan_LogicalLimit(self, node: lp.LogicalLimit) -> PhysicalPlan:
        child = self.plan(node.children[0])
        local = cpu.CpuLocalLimitExec(child, node.limit)
        single = cpu.CpuShuffleExchangeExec(local, ("single",))
        return cpu.CpuGlobalLimitExec(single, node.limit)

    def plan_collect_limit(self, node: lp.LogicalLimit) -> PhysicalPlan:
        """A limit at the root: one CollectLimit operator in place of local
        limit + exchange + global limit."""
        return cpu.CpuCollectLimitExec(self.plan(node.children[0]),
                                       node.limit)

    def _plan_LogicalRepartition(self, node) -> PhysicalPlan:
        return cpu.CpuShuffleExchangeExec(self.plan(node.children[0]),
                                          ("roundrobin", node.n))

    def _plan_LogicalCoalesce(self, node) -> PhysicalPlan:
        return cpu.CpuCoalescePartitionsExec(self.plan(node.children[0]),
                                             node.n)

    def _plan_LogicalUnion(self, node: lp.LogicalUnion) -> PhysicalPlan:
        return cpu.CpuUnionExec([self.plan(c) for c in node.children])

    def _plan_LogicalExpand(self, node: lp.LogicalExpand) -> PhysicalPlan:
        child = self.plan(node.children[0])
        cs = child.output_schema()
        return cpu.CpuExpandExec(child, [
            [(n, bind_references(e, cs)) for n, e in proj]
            for proj in node.projections])

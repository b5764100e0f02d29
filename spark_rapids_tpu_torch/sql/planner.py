"""Logical -> CPU physical planning (counterpart of the JAX package's
``sql/planner.py``).

Produces the plan shape Spark hands the reference's ColumnarRule:
aggregates split into partial + exchange + final, global sorts into an
exchange + sort, limits into local limit + single exchange + global limit,
equi-joins into a broadcast hash join (the build side under
``autoBroadcastJoinThreshold``) or hash exchanges on both sides and a
shuffled join; a cross join into a single-partition exchange on both
sides and a cartesian product; a condition join into a broadcast
nested-loop join (the right side broadcast); a window into an exchange on
its partition keys (hash where they are plain columns, else single) and a
window operator; a write into ``CpuWriteExec`` (``exec/write.py``). A
filter right above a file scan hangs the conjuncts footer statistics can
answer on the scan (``pushed_filters``, ``sql/pushdown``), which prunes
its splits by them; the filter still runs. The device rewrite
(``sql/overrides.py``) then tags and converts this CPU plan node by node.
A generator over a computed source projects the source first and drops it
after. A build side whose size estimate raises or is not an integer
reads as unknown and plans the shuffled join (``_estimated_size``).

The JAX package's small-query fast path (``note_input_size``,
``spark.rapids.sql.smallQuery.*``) is not ported: the port's exchanges
keep their capacity shrink (one counted ``exchange.shrink`` sync where a
padded producer feeds a collapse) on every query, where the JAX package
skips it for one resident batch under its threshold (ROADMAP).
"""

from __future__ import annotations

from spark_rapids_tpu_torch.exec import cpu
from spark_rapids_tpu_torch.exec.aggutil import AggPlan, bind_non_agg
from spark_rapids_tpu_torch.columnar.batch import Schema
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
        # predicate pushdown: the conjuncts statistics can answer reach
        # the file source for row-group, stripe and partition pruning;
        # the filter in the plan still applies them exactly
        # (ParquetFilters, GpuParquetScan.scala:204-246;
        # sql/rapids/OrcFilters.scala)
        if isinstance(child, cpu.CpuScanExec) and hasattr(
                child.source, "prune_splits"):
            from spark_rapids_tpu_torch.sql.pushdown import (
                extract_pushable_filters,
            )
            pushed = extract_pushable_filters(node.condition)
            if pushed:
                child.pushed_filters = pushed
        return cpu.CpuFilterExec(
            child, bind_references(node.condition, child.output_schema()))

    def _plan_LogicalWrite(self, node: lp.LogicalWrite) -> PhysicalPlan:
        from spark_rapids_tpu_torch.exec.write import CpuWriteExec
        return CpuWriteExec(self.plan(node.children[0]), node.path,
                            node.fmt, node.mode, node.partition_cols)

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

    def _plan_LogicalJoin(self, node: lp.LogicalJoin) -> PhysicalPlan:
        left = self.plan(node.children[0])
        right = self.plan(node.children[1])
        ls, rs = left.output_schema(), right.output_schema()
        jt = node.join_type
        if node.condition is not None:
            # a non-equi condition: broadcast nested loop, inner/cross
            if jt not in ("inner", "cross"):
                raise NotImplementedError(
                    f"condition joins take inner/cross, not {jt!r}")
            combined = Schema(list(ls.names) + list(rs.names),
                              list(ls.dtypes) + list(rs.dtypes))
            return cpu.CpuBroadcastNestedLoopJoinExec(
                left, cpu.CpuBroadcastExchangeExec(right), "inner",
                bind_references(node.condition, combined))
        if jt == "cross":
            return cpu.CpuCartesianProductExec(
                cpu.CpuShuffleExchangeExec(left, ("single",)),
                cpu.CpuShuffleExchangeExec(right, ("single",)))
        lidx, left = _key_indices(
            left, [bind_references(e, ls) for e in node.left_keys], ls)
        ridx, right = _key_indices(
            right, [bind_references(e, rs) for e in node.right_keys], rs)
        # broadcast the build side when its estimate fits under the
        # threshold: the right side, the left for a right join (its
        # preserved side streams); a full outer join never broadcasts.
        # -1 disables; an unknown estimate plans the shuffled join.
        threshold = self.conf.broadcast_threshold
        build_node = node.children[0] if jt == "right" else node.children[1]
        est = _estimated_size(build_node)
        if (jt != "full" and threshold >= 0 and est is not None
                and est <= threshold):
            if jt == "right":
                left = cpu.CpuBroadcastExchangeExec(left)
            else:
                right = cpu.CpuBroadcastExchangeExec(right)
            return cpu.CpuBroadcastHashJoinExec(left, right, jt, lidx, ridx)
        n = self.conf.shuffle_partitions
        left = cpu.CpuShuffleExchangeExec(left, ("hash", lidx, n))
        right = cpu.CpuShuffleExchangeExec(right, ("hash", ridx, n))
        return cpu.CpuJoinExec(left, right, jt, lidx, ridx)

    def _plan_LogicalWindow(self, node: lp.LogicalWindow) -> PhysicalPlan:
        from spark_rapids_tpu_torch.exec.windowexec import CpuWindowExec
        from spark_rapids_tpu_torch.sql.window import (
            WindowExpression, WindowSpec,
        )
        child = self.plan(node.children[0])
        cs = child.output_schema()
        bound = []
        for name, w in node.window_exprs:
            spec = WindowSpec(
                [bind_references(e, cs) for e in w.spec.partition_cols],
                [SortOrder(bind_references(o.expr, cs), o.ascending,
                           o.nulls_first) for o in w.spec.orders],
                w.spec.frame)
            fn = w.fn.map_children(lambda c: bind_references(c, cs))
            bound.append((name, WindowExpression(fn, spec)))
        # whole partition groups go to one task: a hash exchange on the
        # partition keys where they are plain columns, else single
        spec0 = bound[0][1].spec
        pidx = [e.index for e in spec0.partition_cols
                if isinstance(e, BoundRef)]
        if spec0.partition_cols and len(pidx) == len(spec0.partition_cols):
            child = cpu.CpuShuffleExchangeExec(
                child, ("hash", pidx, self.conf.shuffle_partitions))
        else:
            child = cpu.CpuShuffleExchangeExec(child, ("single",))
        return CpuWindowExec(child, bound)

    def _plan_LogicalUnion(self, node: lp.LogicalUnion) -> PhysicalPlan:
        return cpu.CpuUnionExec([self.plan(c) for c in node.children])

    def _plan_LogicalExpand(self, node: lp.LogicalExpand) -> PhysicalPlan:
        child = self.plan(node.children[0])
        cs = child.output_schema()
        return cpu.CpuExpandExec(child, [
            [(n, bind_references(e, cs)) for n, e in proj]
            for proj in node.projections])

    def _plan_LogicalGenerate(self, node: lp.LogicalGenerate
                              ) -> PhysicalPlan:
        from spark_rapids_tpu_torch.exec.generate import CpuGenerateExec
        child = self.plan(node.children[0])
        cs = child.output_schema()
        src = bind_references(node.source, cs)
        if isinstance(src, BoundRef):
            return CpuGenerateExec(child, src.index, node.delim,
                                   node.out_name, node.with_pos,
                                   node.pos_name)
        # a computed source: project it, generate, then drop the helper
        # column to keep the logical schema
        exprs = [(n, BoundRef(i, dt, n)) for i, (n, dt)
                 in enumerate(zip(cs.names, cs.dtypes))]
        exprs.append(("_gen_src", src))
        gen = CpuGenerateExec(cpu.CpuProjectExec(child, exprs),
                              len(exprs) - 1, node.delim, node.out_name,
                              node.with_pos, node.pos_name)
        gs = gen.output_schema()
        return cpu.CpuProjectExec(gen, [
            (n, BoundRef(gs.index_of(n), gs.dtype_of(n), n))
            for n in node.schema().names])


def _key_indices(child: PhysicalPlan, keys, schema):
    """Join keys as column indices: (indices, child), the child under a
    Project that appends the computed keys where a key is not a plain
    column."""
    if all(isinstance(k, BoundRef) for k in keys):
        return [k.index for k in keys], child
    exprs = [(n, BoundRef(i, dt, n)) for i, (n, dt)
             in enumerate(zip(schema.names, schema.dtypes))]
    key_cols = []
    for j, k in enumerate(keys):
        exprs.append((f"_jk{j}", k))
        key_cols.append(len(exprs) - 1)
    return key_cols, cpu.CpuProjectExec(child, exprs)


def _estimated_size(node: lp.LogicalPlan):
    """Broadcast size hint, hardened: a raising or non-integer estimate
    reads as unknown (None), so planning falls back to the shuffled join
    instead of failing the query."""
    try:
        est = node.estimated_size_bytes()
    except Exception:  # noqa: BLE001 - estimates are advisory
        return None
    if est is None:
        return None
    try:
        return int(est)
    except (TypeError, ValueError):
        return None

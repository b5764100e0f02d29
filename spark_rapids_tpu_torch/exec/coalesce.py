"""Batch coalescing (counterpart of the JAX package's ``exec/coalesce.py``;
reference: GpuCoalesceBatches + CoalesceGoal, inserted by
GpuTransitionOverrides).

Fragmenting producers (scans, filters, joins, expands) emit batches below
the target size; every downstream operator then pays its launches per
fragment. ``TpuCoalesceBatchesExec`` accumulates child batches to the
``spark.rapids.sql.batchSizeRows`` target and concatenates them in one
device concat; a lone batch passes through without a copy. A Parquet
scan's row groups, packed into partitions of that many rows, become one
batch a partition here. The reference's ``RequireSingleBatch`` goal is
not ported: the JAX package's joins do not use it, and its sort and
aggregate concatenate their input themselves.
"""

from __future__ import annotations

from typing import Iterator, List

from spark_rapids_tpu_torch.columnar.batch import DeviceBatch, Schema
from spark_rapids_tpu_torch.exec.base import (
    ExecContext, Partition, PhysicalPlan,
)


class CoalesceGoal:
    """Target for coalescing (reference: CoalesceGoal/TargetSize/
    RequireSingleBatch, GpuCoalesceBatches.scala)."""


class TargetSize(CoalesceGoal):
    """Coalesce to batches of at least ``rows`` rows."""

    def __init__(self, rows: int):
        self.rows = rows

    def __repr__(self) -> str:
        return f"TargetSize({self.rows})"


class RequireSingleBatch(CoalesceGoal):
    """Coalesce a partition's whole stream into one batch."""

    def __repr__(self) -> str:
        return "RequireSingleBatch"


def coalesce_iter(batches, goal: CoalesceGoal, schema: Schema,
                  growth: float, device, dm=None,
                  coarse: bool = False) -> Iterator[DeviceBatch]:
    """Accumulate a batch stream to ``goal`` and concatenate: the one
    coalescing loop, shared by TpuCoalesceBatchesExec and the fused
    stage's input re-batching (``exec/stagecompiler/fusedexec.py``). The
    counting is by row-count hints (the capacity where the count is on
    the device), so it needs no host sync; it over-counts by at most the
    padding. A concat's output is metered on ``dm`` where given.
    ``coarse``: a concat's capacity pads up the shape-bucket ladder
    (``utils/kernelcache.bucket_dim``; the identity while
    ``spark.rapids.tpu.compile.shapeBuckets`` is off)."""
    from spark_rapids_tpu_torch.exec.tpu import concat_device
    single = isinstance(goal, RequireSingleBatch)
    pending: List[DeviceBatch] = []
    pending_rows = 0

    def flush():
        return concat_device(pending, schema, growth, device, dm=dm,
                             coarse=coarse)
    for batch in batches:
        rows = batch.num_rows_hint()
        if rows == 0 and pending:
            continue  # a known-empty fragment
        pending.append(batch)
        pending_rows += rows
        if not single and pending_rows >= goal.rows:
            yield flush()
            pending, pending_rows = [], 0
    if pending:
        yield flush()


class TpuCoalesceBatchesExec(PhysicalPlan):
    columnar_output = True

    def __init__(self, child: PhysicalPlan, goal: CoalesceGoal):
        super().__init__([child])
        self.goal = goal

    def output_schema(self) -> Schema:
        return self.children[0].output_schema()

    def describe(self) -> str:
        return f"TpuCoalesceBatchesExec({self.goal!r})"

    def partitions(self, ctx: ExecContext) -> List[Partition]:
        from spark_rapids_tpu_torch.exec.tpu import device_manager_of
        schema = self.output_schema()

        def make(part: Partition) -> Partition:
            def run() -> Iterator[DeviceBatch]:
                yield from coalesce_iter(part(), self.goal, schema,
                                         ctx.conf.capacity_growth,
                                         ctx.device, device_manager_of(ctx))
            return run
        return [make(p) for p in self.children[0].executed_partitions(ctx)]


def is_fragmenting(plan: PhysicalPlan) -> bool:
    """Producers whose batches can be far below the target size."""
    from spark_rapids_tpu_torch.exec import tpu, tpujoin
    return isinstance(plan, (tpu.TpuScanExec, tpu.TpuFilterExec,
                             tpujoin.TpuShuffledHashJoinExec,
                             tpu.TpuExpandExec))


def _reads_input_file(plan: PhysicalPlan) -> bool:
    """Does this operator evaluate input_file_name()? A coalesce would
    drain the scan past a file's end before it evaluates."""
    from spark_rapids_tpu_torch.sql.exprs.nondet import reads_input_file
    exprs = [e for _, e in getattr(plan, "exprs", ())]
    if getattr(plan, "condition", None) is not None:
        exprs.append(plan.condition)
    return any(reads_input_file(e) for e in exprs)


def insert_coalesce(plan: PhysicalPlan, conf) -> PhysicalPlan:
    """TpuCoalesceBatchesExec above every fragmenting producer that feeds a
    device consumer; none in a query that evaluates input_file_name(),
    whose batches must reach it one file at a time (the JAX package's
    rule; reference: GpuTransitionOverrides.scala)."""
    if any(_reads_input_file(node) for node in plan.walk()):
        return plan
    return _insert(plan, conf)


def _insert(plan: PhysicalPlan, conf) -> PhysicalPlan:
    new_children = []
    for c in plan.children:
        c2 = _insert(c, conf)
        if (plan.columnar_output
                and not isinstance(plan, TpuCoalesceBatchesExec)
                and is_fragmenting(c2)):
            c2 = TpuCoalesceBatchesExec(c2, TargetSize(conf.batch_size_rows))
        new_children.append(c2)
    out = plan.map_children(lambda x: x)
    out.children = new_children
    return out

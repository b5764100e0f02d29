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


class TargetSize:
    """Coalesce to batches of at least ``rows`` rows."""

    def __init__(self, rows: int):
        self.rows = rows

    def __repr__(self) -> str:
        return f"TargetSize({self.rows})"


def coalesce_iter(batches, goal: TargetSize, schema: Schema,
                  growth: float, device) -> Iterator[DeviceBatch]:
    """Accumulate a batch stream to ``goal`` and concatenate. The counting
    is by row-count hints (the capacity where the count is on the device),
    so it needs no host sync; it over-counts by at most the padding."""
    from spark_rapids_tpu_torch.exec.tpu import concat_device
    pending: List[DeviceBatch] = []
    pending_rows = 0
    for batch in batches:
        rows = batch.num_rows_hint()
        if rows == 0 and pending:
            continue  # a known-empty fragment
        pending.append(batch)
        pending_rows += rows
        if pending_rows >= goal.rows:
            yield concat_device(pending, schema, growth, device)
            pending, pending_rows = [], 0
    if pending:
        yield concat_device(pending, schema, growth, device)


class TpuCoalesceBatchesExec(PhysicalPlan):
    columnar_output = True

    def __init__(self, child: PhysicalPlan, goal: TargetSize):
        super().__init__([child])
        self.goal = goal

    def output_schema(self) -> Schema:
        return self.children[0].output_schema()

    def describe(self) -> str:
        return f"TpuCoalesceBatchesExec({self.goal!r})"

    def partitions(self, ctx: ExecContext) -> List[Partition]:
        schema = self.output_schema()

        def make(part: Partition) -> Partition:
            def run() -> Iterator[DeviceBatch]:
                yield from coalesce_iter(part(), self.goal, schema,
                                         ctx.conf.capacity_growth,
                                         ctx.device)
            return run
        return [make(p) for p in self.children[0].executed_partitions(ctx)]


def is_fragmenting(plan: PhysicalPlan) -> bool:
    """Producers whose batches can be far below the target size."""
    from spark_rapids_tpu_torch.exec import tpu, tpujoin
    return isinstance(plan, (tpu.TpuScanExec, tpu.TpuFilterExec,
                             tpujoin.TpuShuffledHashJoinExec,
                             tpu.TpuExpandExec))


def insert_coalesce(plan: PhysicalPlan, conf) -> PhysicalPlan:
    """TpuCoalesceBatchesExec above every fragmenting producer that feeds a
    device consumer."""
    new_children = []
    for c in plan.children:
        c2 = insert_coalesce(c, conf)
        if (plan.columnar_output
                and not isinstance(plan, TpuCoalesceBatchesExec)
                and is_fragmenting(c2)):
            c2 = TpuCoalesceBatchesExec(c2, TargetSize(conf.batch_size_rows))
        new_children.append(c2)
    out = plan.map_children(lambda x: x)
    out.children = new_children
    return out

"""Physical plan base classes (counterpart of the JAX package's
``exec/base.py``).

Execution model: a physical operator produces a list of *partitions*, each
a zero-argument callable returning an iterator of batches (the Spark
``RDD.mapPartitions`` shape). Two payloads flow through a mixed plan:

  * CPU operators: pandas DataFrames (the fallback path);
  * device operators: columnar DeviceBatches (the accelerated path).

Transition operators convert between them (``exec/transitions.py``).

Operators implement ``partitions``; consumers call
``executed_partitions``, which wraps each partition with the JAX
package's per-batch bookkeeping (reference: GpuMetricNames,
GpuExec.scala:24-41, and NvtxWithMetrics.scala:17-44): a tracer span per
pulled batch, the operator scope the host-sync ledger and the transfer
sites attribute to (``obs/compileledger``), the per-operator metrics
``totalTime``, ``numOutputBatches`` and ``numOutputRows`` with the
per-node stats of the profile report (``ExecContext.record_op``), the
live-progress heartbeat, and under ``spark.rapids.sql.profile.syncEachOp``
a wait for the device after each batch. With metrics
(``spark.rapids.sql.metrics.enabled``, on by default), tracing, progress
and syncEachOp all off, the partitions pass through untouched.

A batch's row count is recorded only where the host knows it without a
sync (``DeviceBatch.host_rows``, a pandas frame's length) or under
syncEachOp, whose wait reads it: the wrapper never adds a host sync of
its own otherwise. A query running under a cancel scope (the serving
scheduler's, ``serving/cancellation.py``, taken by ``ExecContext``) checks
it before every batch pull, so a cancelled or late query raises
``QueryCancelled``/``QueryTimeout`` there and never inside a kernel; a
live scope keeps the wrapper on even with metrics, tracing and progress
off. The JAX package's small-query lite bookkeeping is not ported (the
port has no small-query planner). An operator adds what it counts itself
to its
query's metrics (``ExecContext.metric_add``: a scan's pruned row groups, a
write's files and rows), which the session keeps as
``last_query_metrics``.
"""

from __future__ import annotations

import hashlib
import threading
import time
from typing import Callable, Iterator, List, Optional, Sequence

import torch

from spark_rapids_tpu_torch.columnar.batch import DeviceBatch, Schema
from spark_rapids_tpu_torch.obs import compileledger
from spark_rapids_tpu_torch.obs.syncledger import sync_scope
from spark_rapids_tpu_torch.obs.trace import TRACER

Partition = Callable[[], Iterator]  # yields pd.DataFrame or DeviceBatch


def group_contiguous(parts: Sequence[Partition],
                     n: int) -> List[List[Partition]]:
    """Contiguous partition grouping for CoalesceExec (Spark's
    DefaultPartitionCoalescer), shared by the CPU and device operators."""
    n = min(max(1, int(n)), max(len(parts), 1))
    per = -(-len(parts) // n) if parts else 0
    groups: List[List[Partition]] = [[] for _ in range(n)]
    for i, p in enumerate(parts):
        groups[min(i // max(per, 1), n - 1)].append(p)
    return groups


class PhysicalPlan:
    """Base physical operator."""

    # True if this operator's output is device columnar
    columnar_output = False

    def __init__(self, children: Sequence["PhysicalPlan"] = ()):
        self.children: List[PhysicalPlan] = list(children)

    @property
    def name(self) -> str:
        return type(self).__name__

    def output_schema(self) -> Schema:
        raise NotImplementedError

    def partitions(self, ctx: "ExecContext") -> List[Partition]:
        raise NotImplementedError

    def executed_partitions(self, ctx: "ExecContext") -> List[Partition]:
        """``partitions`` with the per-batch bookkeeping (see the module
        docstring). What consumers call; operators implement
        ``partitions``."""
        parts = self.partitions(ctx)
        prog = ctx.progress
        sync_each = ctx.profile_sync
        record = ctx.metrics_enabled
        cancel = ctx.cancel
        if not record and not TRACER.enabled and prog is None \
                and not sync_each and cancel is None:
            return parts
        op = self.describe()
        node_id = id(self)
        name = self.name

        def wrap(part: Partition, pidx: int) -> Partition:
            def run():
                it = part()
                while True:
                    if cancel is not None:
                        # the batch-pull boundary: a cancelled or late
                        # query stops here, and the session's failure
                        # path releases its buffers and shuffles
                        cancel.check()
                    t0 = time.perf_counter()
                    with TRACER.span(name, op=op, partition=pidx) as sp:
                        # the operator scope: a sync or a transfer inside
                        # this pull attributes to THIS operator
                        prev_op = compileledger.push_op(op, node_id, ctx)
                        try:
                            batch = next(it)
                        except StopIteration:
                            return
                        finally:
                            compileledger.pop_op(prev_op)
                        rows = _host_rows(batch)
                        if sp is not None:
                            sp.set(batch_rows=rows)
                    if sync_each:
                        t1 = time.perf_counter()
                        synced = _sync_rows(batch)
                        if rows is None:
                            rows = synced
                        t2 = time.perf_counter()
                        # the pull is host dispatch (with the children and
                        # the transfers), the wait is the device draining
                        # THIS operator's queued work (the children waited
                        # before yielding)
                        compileledger.note_breakdown(
                            ctx, node_id, pull_s=t1 - t0, sync_s=t2 - t1)
                        with ctx._stats_lock:
                            ctx.node_times[node_id] = ctx.node_times.get(
                                node_id, 0.0) + (time.perf_counter() - t0)
                    seconds = time.perf_counter() - t0
                    if record:
                        ctx.record_op(op, node_id, seconds, rows)
                    if prog is not None:
                        prog.op_batch(node_id, op, rows, seconds)
                    yield batch
            return run
        return [wrap(p, i) for i, p in enumerate(parts)]

    def map_children(self, fn) -> "PhysicalPlan":
        import copy
        new = copy.copy(self)
        new.children = [fn(c) for c in self.children]
        return new

    def tree_string(self, indent: int = 0) -> str:
        lines = ["  " * indent + self.describe()]
        for c in self.children:
            lines.append(c.tree_string(indent + 1))
        return "\n".join(lines)

    def describe(self) -> str:
        return self.name

    def fingerprint_extra(self) -> str:
        """Identity beyond ``describe()`` for ``plan_fingerprint``."""
        return ""

    def walk(self):
        yield self
        for c in self.children:
            yield from c.walk()


def _host_rows(batch) -> Optional[int]:
    """The batch's row count where the host knows it without a sync."""
    if isinstance(batch, DeviceBatch):
        return batch.host_rows
    try:
        return len(batch)
    except TypeError:
        return None


def _sync_rows(batch) -> Optional[int]:
    """syncEachOp's wait: read a device batch's row count, a copy on the
    current stream that waits for everything queued before it (a counted
    ``profile.syncEachOp`` sync); None for a host frame."""
    if not isinstance(batch, DeviceBatch):
        return None
    with sync_scope("profile.syncEachOp", nbytes=4):
        return int(batch.num_rows.item())


class HostCopy:
    """A device tensor's copy to the host, started without waiting: on a
    CUDA device a non-blocking copy into pinned host memory with a CUDA
    event recorded after it (a copy into pageable memory would wait, and
    so would reading the pinned tensor before its event), on the CPU the
    tensor itself. The JAX package's ``_start_host_copies``: the deferred
    speculation check (``session._verify_speculation``) waits on the
    events inside its one counted sync and reads nothing before."""

    __slots__ = ("host", "event")

    def __init__(self, tensor: torch.Tensor):
        if tensor.device.type == "cuda":
            self.host = torch.empty(tensor.shape, dtype=tensor.dtype,
                                    pin_memory=True)
            self.host.copy_(tensor, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = tensor
            self.event = None

    @property
    def nbytes(self) -> int:
        return self.host.numel() * self.host.element_size()

    def wait(self) -> None:
        if self.event is not None:
            self.event.synchronize()

    def tolist(self):
        """The values (call ``wait`` first, inside the sync scope)."""
        return self.host.tolist()


def plan_fingerprint(node: PhysicalPlan) -> str:
    """Structural identity of a plan subtree, stable across executions of
    the same query over the same data (each scan's data identity is in
    its ``fingerprint_extra``): keys the session's aggregation ratio
    cache and its capacity speculation cache."""
    parts: List[str] = []

    def rec(n: PhysicalPlan) -> None:
        parts.extend((n.describe(), n.fingerprint_extra(), "("))
        for c in n.children:
            rec(c)
        parts.append(")")
    rec(node)
    return hashlib.md5("|".join(parts).encode()).hexdigest()


class ExecContext:
    """Per-query execution context: the conf, the session (its caches),
    the device the query's batches live on, and the query's metrics and
    profile stats."""

    def __init__(self, conf, session=None, device="cuda",
                 speculate: bool = True):
        from spark_rapids_tpu_torch.obs.metrics import MetricsRegistry
        self.conf = conf
        self.session = session
        self.device = torch.device(device)
        # adaptive capacity speculation (spark.rapids.sql.adaptiveCapacity
        # .enabled): operators that speculated a device->host size fetch
        # from the session cache append (key, totals HostCopy or None,
        # width, caps used, ok-flag HostCopies, exact counts or None)
        # here; the session verifies the whole list in ONE fetch at the
        # query's end and re-executes without speculation on any miss
        # (session._execute). ``speculate=False`` is that re-execution.
        self.speculate = (
            speculate and session is not None
            and conf.get_bool("spark.rapids.sql.adaptiveCapacity.enabled",
                              True))
        self.spec_pending: list = []
        # agg_ratio_cache entries written by this execution: a speculative
        # run that fails verification learned its ratios from possibly
        # wrong group counts, and the session drops exactly these before
        # re-executing
        self.ratio_writes: list = []
        # the shared subtrees' batches of this execution (exec/reuse.py)
        self.reuse_state: dict = {}
        # catalog ids of this query's transient spillables (broadcast
        # tables, reused subtrees, out-of-core buckets), freed at its end
        self.transient_bids: set = set()
        # the shuffle ids this query registered with the shuffle manager
        # (session.next_shuffle_id), unregistered at its end
        self.active_shuffles: list = []
        # {operator: {metric: value}} of this query
        self.metrics: dict = {}
        self._metrics_lock = threading.Lock()
        # one lock for the metrics and the per-node stats
        self._stats_lock = self._metrics_lock
        # a per-query registry for labelled metrics of this query's own
        self.registry = MetricsRegistry()
        self.metrics_enabled = conf.get_bool(
            "spark.rapids.sql.metrics.enabled", True)
        # per-plan-node (identity-keyed) inclusive time, rows and batches
        # of the profile report (obs/profile.py)
        self.node_stats: dict = {}
        # a wait for the device after each operator's batch, so time is
        # attributable per operator (obs/profile.py breakdown)
        self.profile_sync = conf.get_bool(
            "spark.rapids.sql.profile.syncEachOp", False)
        self.node_times: dict = {}
        # per-plan-node wall-time components (obs/compileledger
        # note_breakdown): pull_s and sync_s under profile_sync,
        # transfer_s from the transfer sites
        self.node_breakdown: dict = {}
        # the live QueryProgress record (obs/progress.py), set by the
        # session only while PROGRESS is enabled
        self.progress = None
        # the cooperative cancel scope (serving/cancellation.py) the
        # scheduler's worker installed on this thread, checked at every
        # batch pull; None outside the scheduler
        from spark_rapids_tpu_torch.serving.cancellation import (
            current_scope,
        )
        self.cancel = current_scope()

    def metric_add(self, op: str, name: str, value) -> None:
        """Add ``value`` to metric ``name`` of operator ``op`` (its
        ``describe()``) in this query's metrics."""
        with self._metrics_lock:
            ms = self.metrics.setdefault(op, {})
            ms[name] = ms.get(name, 0) + value

    def record_op(self, op: str, node_id: int, seconds: float,
                  rows: Optional[int]) -> None:
        """One executed batch of one operator: its metrics and the
        per-node stats the profile report attributes time with (rows
        where known)."""
        with self._metrics_lock:
            ms = self.metrics.setdefault(op, {})
            ms["totalTime"] = ms.get("totalTime", 0) + seconds
            ms["numOutputBatches"] = ms.get("numOutputBatches", 0) + 1
            st = self.node_stats.get(node_id)
            if st is None:
                st = self.node_stats[node_id] = {
                    "time": 0.0, "rows": 0, "batches": 0}
            st["time"] += seconds
            st["batches"] += 1
            if rows is not None:
                ms["numOutputRows"] = ms.get("numOutputRows", 0) + rows
                st["rows"] += rows

    def op_metrics(self) -> dict:
        """A copy of this query's metrics, {op: {metric: value}}."""
        with self._metrics_lock:
            return {op: dict(ms) for op, ms in self.metrics.items()}

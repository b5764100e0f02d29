"""Device columnar physical operators (counterpart of the JAX package's
``exec/tpu.py``; the joins are in ``exec/tpujoin.py``).

Where the JAX package compiles each operator's per-batch work into one
``jax.jit`` program, each operator here runs its PyTorch ops and the
port's kernels eagerly, one batch at a time, without a host sync: row
counts stay on the device. Ported: Scan (in-memory uploads and Parquet
files), Project, Filter, HashAggregate (partial and final, with the
runtime partial skip), Sort, the three limits, CoalescePartitions, Union,
Range, Expand, and the shuffle exchange's one-device routes: the
collapse, the buckets and the shuffle manager (``TpuShuffleExchangeExec``).

Under the memory runtime (``memory/``): each concat's output is metered
against the session's device budget (``concat_device(..., dm=)``); the
aggregate, the sort and the join (``exec/tpujoin.py``) probe their input
stream against ``spark.rapids.tpu.outOfCore.partitionBytes`` and past it
hand it to the out-of-core drivers (``exec/outofcore.py``): the grace
aggregate, the external sort, the grace join. Under the hash aggregation
(``agg.hashAggEnabled``) a partial batch whose slot table would pass
``agg.hash.maxTableSlots`` splits by key hash into slices that fit
(``_bucketed_update``, up to three levels); a merge past it still takes
the sorted-payload branch, as in the JAX package.

Not ported, and why nothing here needs them yet:
  * the fused filter masks, fused selections and whole-stage programs of
    ``exec/fusion.py`` and ``exec/stagecompiler`` (ROADMAP A.10);
  * the dense composite grouping key (``agg.denseKeys``,
    ``ops/aggregate.dense_composite``, ``exec/statsutil.py``): it engages
    only under the session's capacity speculation (ROADMAP A.10); the
    aggregate takes the JAX package's other branches, with the same result;
  * the first-batch partial-skip heuristic (``agg.runtimeSkip=false``):
    the partial pass always decides its skip at run time, the JAX
    package's default;
  * the exchange's capacity shrink (a counted sync) and its speculation
    (ROADMAP A.10): the collapse route passes the child's batches on with
    no sync, which already streams its pieces as the JAX package's
    collapse does under out-of-core. Only a concat whose padded capacity
    would pass CONCAT_SHRINK_ROWS reads its live rows
    (``concat_device``);
  * the exchange's mesh route (``shuffle/ici.py``, an all_to_all across
    cards; ROADMAP A.9).
"""

from __future__ import annotations

import itertools
from typing import Iterator, List, Optional, Sequence, Tuple

import torch

from spark_rapids_tpu_torch.columnar import dtype as dtypes
from spark_rapids_tpu_torch.columnar.batch import (
    DeviceBatch, Schema, bucket_capacity,
)
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.columnar.dtype import torch_dtype
from spark_rapids_tpu_torch.config import conf as C
from spark_rapids_tpu_torch.exec.aggutil import AggPlan
from spark_rapids_tpu_torch.exec.base import (
    ExecContext, Partition, PhysicalPlan, group_contiguous,
    plan_fingerprint,
)
from spark_rapids_tpu_torch.obs.events import EVENTS
from spark_rapids_tpu_torch.obs.syncledger import sync_scope
from spark_rapids_tpu_torch.ops import aggregate as agg_ops
from spark_rapids_tpu_torch.ops import rowops, sortops
from spark_rapids_tpu_torch.sql.exprs.core import Alias, BoundRef, Expression
from spark_rapids_tpu_torch.sql.exprs.evalbridge import (
    eval_projection, make_context, to_device_column,
)
from spark_rapids_tpu_torch.sql.functions import SortOrder


class TpuExec(PhysicalPlan):
    columnar_output = True


def empty_batch(schema: Schema, device) -> DeviceBatch:
    """A batch of no rows (capacity 1): an empty partition's output."""
    cols = []
    for dt in schema.dtypes:
        validity = torch.zeros(1, dtype=torch.bool, device=device)
        if dt.is_string:
            cols.append(DeviceColumn(dt, None, validity, torch.zeros(
                1, dtype=torch.int32, device=device), ()))
        else:
            cols.append(DeviceColumn(dt, torch.zeros(
                1, dtype=torch_dtype(dt.np_dtype), device=device),
                validity))
    batch = DeviceBatch(schema, cols, torch.zeros(
        (), dtype=torch.int32, device=device))
    batch.host_rows = 0
    return batch


# a concat whose summed capacities pass this many rows sizes its output
# by its live rows instead (one counted sync, where a batch's row count is
# not known on the host): padded partials (a 12x cross join's partial
# aggregates, each at its input's capacity) would otherwise ask for a
# capacity the card cannot hold
CONCAT_SHRINK_ROWS = 1 << 27
# the concats that read their live rows, since the last reset
CONCAT_SHRINKS = {"synced": 0}


def reset_concat_shrinks() -> None:
    CONCAT_SHRINKS["synced"] = 0


def device_manager_of(ctx: ExecContext):
    """The session's device budget meter, or None outside a session."""
    return getattr(ctx.session, "device_manager", None)


def concat_device(batches: List[DeviceBatch], schema: Schema,
                  growth: float, device, dm=None) -> DeviceBatch:
    """Concatenate device batches (GpuCoalesceBatches): one
    ``rowops.concat_batches`` at the bucketed sum of their capacities, or
    of their live rows past CONCAT_SHRINK_ROWS. A new output is metered
    on ``dm`` (a ``memory/device.TpuDeviceManager``) where given."""
    if len(batches) == 1:
        return batches[0]
    if not batches:
        return empty_batch(schema, device)
    out = _concat(batches, growth)
    if dm is not None:
        dm.meter_batch(out)
    return out


def _concat(batches: List[DeviceBatch], growth: float) -> DeviceBatch:
    out_cap = bucket_capacity(sum(b.capacity for b in batches), growth)
    if out_cap > CONCAT_SHRINK_ROWS:
        if all(b.host_rows is not None for b in batches):
            rows = sum(b.host_rows for b in batches)
        else:
            with sync_scope("concat.liveRows", nbytes=4):
                rows = int(torch.stack([b.num_rows for b in batches])
                           .to(torch.int64).sum().item())
            CONCAT_SHRINKS["synced"] += 1
        out_cap = bucket_capacity(max(rows, 1), growth)
    return rowops.concat_batches(batches, out_cap)


def split_by_pid(batch: DeviceBatch, pid: torch.Tensor, n: int):
    """(rows sorted by partition id, (n,) int64 row count of each id): a
    stable sort of the ids with dead rows last, the contiguous-split
    analogue (GpuPartitioning.scala:41-75; the JAX package's
    ``_split_by_pid``). No host sync."""
    pid = torch.where(batch.row_mask(), pid.to(torch.int64), n)
    order = torch.sort(pid, stable=True).indices
    sorted_b = rowops.gather_batch(batch, order.to(torch.int32),
                                   batch.num_rows)
    counts = torch.zeros(n + 1, dtype=torch.int64, device=pid.device)
    counts.index_add_(0, pid, torch.ones_like(pid))
    return sorted_b, counts[:n]


def _select_view(batch: DeviceBatch, sel) -> DeviceBatch:
    """Column selection without device work."""
    names, idx = sel
    return DeviceBatch(
        Schema(list(names), [batch.schema.dtypes[i] for i in idx]),
        [batch.columns[i] for i in idx], batch.num_rows)


def _as_ref(e: Expression) -> Optional[BoundRef]:
    """The BoundRef behind a (possibly aliased) expression, else None."""
    while isinstance(e, Alias):
        e = e.children[0]
    return e if isinstance(e, BoundRef) else None


def _per_batch(node: PhysicalPlan, ctx: ExecContext, exprs, fn
               ) -> List[Partition]:
    """``fn`` over each batch of each child partition. Where ``exprs``
    hold a nondeterministic expression, the task context gets the
    partition's index and the rows its earlier batches held before each
    batch (``exec/taskctx``); a batch whose row count the host does not
    know reads it in one counted sync (``nondet.rowBase``). A pure
    operator pays nothing."""
    from spark_rapids_tpu_torch.exec import taskctx
    from spark_rapids_tpu_torch.sql.exprs.nondet import has_nondeterministic
    impure = any(has_nondeterministic(e) for e in exprs)

    def make(index: int, part: Partition) -> Partition:
        def run() -> Iterator[DeviceBatch]:
            seen = 0
            for batch in part():
                if impure:
                    taskctx.set_partition(index)
                    taskctx.set_row_base(seen)
                    if batch.host_rows is not None:
                        seen += batch.host_rows
                    else:
                        with sync_scope("nondet.rowBase", nbytes=4):
                            seen += int(batch.num_rows.item())
                yield fn(batch)
        return run
    return [make(i, p) for i, p in
            enumerate(node.children[0].executed_partitions(ctx))]


class TpuProjectExec(TpuExec):
    """reference: GpuProjectExec. Bare column references pass their column
    objects through; only derived outputs are computed."""

    def __init__(self, child: PhysicalPlan,
                 exprs: Sequence[Tuple[str, Expression]]):
        super().__init__([child])
        self.exprs = list(exprs)

    def output_schema(self) -> Schema:
        cs = self.children[0].output_schema()
        return Schema([n for n, _ in self.exprs],
                      [e.dtype(cs) for _, e in self.exprs])

    def describe(self) -> str:
        return f"TpuProjectExec([{', '.join(n for n, _ in self.exprs)}])"

    def fingerprint_extra(self) -> str:
        return ";".join(repr(e) for _, e in self.exprs)

    def _project(self, batch: DeviceBatch) -> DeviceBatch:
        names = [n for n, _ in self.exprs]
        refs = [_as_ref(e) for _, e in self.exprs]
        if all(r is not None for r in refs):
            return _select_view(batch, (names, [r.index for r in refs]))
        comp = [e for (_n, e), r in zip(self.exprs, refs) if r is None]
        computed = iter(eval_projection(
            batch, comp, [f"c{i}" for i in range(len(comp))]).columns)
        cols = [batch.columns[r.index] if r is not None else next(computed)
                for r in refs]
        return DeviceBatch(Schema(names, [c.dtype for c in cols]), cols,
                           batch.num_rows)

    def partitions(self, ctx: ExecContext) -> List[Partition]:
        return _per_batch(self, ctx, [e for _, e in self.exprs],
                          self._project)


class TpuFilterExec(TpuExec):
    """reference: GpuFilterExec: the predicate's keep mask, then one row
    compaction (kernel B1) of every column."""

    def __init__(self, child: PhysicalPlan, condition: Expression):
        super().__init__([child])
        self.condition = condition

    def output_schema(self) -> Schema:
        return self.children[0].output_schema()

    def describe(self) -> str:
        return f"TpuFilterExec({self.condition!r})"

    def fingerprint_extra(self) -> str:
        return repr(self.condition)

    def _filter(self, batch: DeviceBatch) -> DeviceBatch:
        ectx = make_context(batch)
        pred = to_device_column(ectx, self.condition.eval_device(ectx))
        return rowops.filter_batch(batch, pred.data & pred.validity)

    def partitions(self, ctx: ExecContext) -> List[Partition]:
        return _per_batch(self, ctx, [self.condition], self._filter)


def _note_skip(decision: str, measured: float, batches: int,
               threshold: float) -> None:
    """A measured runtime partial-aggregation skip decision, journaled."""
    EVENTS.emit("aggSkipDecision", decision=decision, source="measured",
                measuredRatio=float(measured), batches=batches,
                threshold=threshold)


class TpuHashAggregateExec(TpuExec):
    """reference: GpuHashAggregateExec. Partial: per-batch update, then a
    concat and merge of the partials within the partition; final: concat,
    merge, finalize."""

    # batches sampled before an undecided plan commits to the update path
    _SKIP_SAMPLE_BATCHES = 3

    def __init__(self, child: PhysicalPlan, plan: AggPlan, mode: str):
        super().__init__([child])
        self.plan = plan
        self.mode = mode

    def output_schema(self) -> Schema:
        return (self.plan.partial_schema if self.mode == "partial"
                else self.plan.output_schema)

    def describe(self) -> str:
        keys = ", ".join(n for n, _ in self.plan.grouping)
        return f"TpuHashAggregateExec(mode={self.mode}, keys=[{keys}])"

    def fingerprint_extra(self) -> str:
        return ";".join(repr(e) for _, e in self.plan.grouping
                        + self.plan.results)

    # -- per-batch steps -----------------------------------------------------
    def _update(self, batch: DeviceBatch, hash_table) -> DeviceBatch:
        p = self.plan
        return agg_ops.aggregate_update(
            batch, [e for _, e in p.grouping], p.update_inputs,
            p.update_reductions, p.partial_schema, hash_table=hash_table)

    def _merge(self, batch: DeviceBatch, hash_table) -> DeviceBatch:
        p = self.plan
        return agg_ops.aggregate_merge(
            batch, p.num_keys, p.merge_reductions, p.partial_schema,
            hash_table=hash_table)

    def _passthrough(self, batch: DeviceBatch) -> DeviceBatch:
        p = self.plan
        return agg_ops.aggregate_passthrough(
            batch, [e for _, e in p.grouping], p.update_inputs,
            p.update_reductions, p.partial_schema)

    def _finalize(self, batch: DeviceBatch) -> DeviceBatch:
        final = self.plan.finalize_exprs()
        return eval_projection(batch, [e for _, e in final],
                               [n for n, _ in final])

    def _update_fn(self, ctx: ExecContext, hash_table):
        """The per-batch update: ``_update``, or under the hash aggregation
        with column-reference keys ``_bucketed_update``: a batch whose slot
        table would pass ``agg.hash.maxTableSlots`` splits by key hash
        into slices that fit (disjoint key sets), each aggregates on B2,
        and their partials concatenate into one partial batch (no key
        spans two slices); a slice still too large splits again with the
        next level's hash, up to three levels. A batch the dictionary
        branch aggregates (every key dictionary-encoded, a small joint
        table) needs no hash table and does not split."""
        def update(b):
            return self._update(b, hash_table)
        if hash_table is None or self.mode != "partial":
            return update
        if not all(isinstance(e, BoundRef) for _, e in self.plan.grouping):
            return update
        key_idx = [e.index for _, e in self.plan.grouping]
        growth = ctx.conf.capacity_growth
        dm = device_manager_of(ctx)
        from spark_rapids_tpu_torch.ops.kernels import hash_table_size

        def bucketed(b, level=0):
            size = hash_table_size(b.capacity)
            if (level >= 3 or size <= hash_table
                    or agg_ops._dict_path_info(b, key_idx) is not None):
                # in budget, or the dictionary branch takes it (no table)
                return update(b)
            need = -(-size // hash_table)
            n = 2
            while n < 2 * need and n < 64:
                n <<= 1
            from spark_rapids_tpu_torch.exec import outofcore as ooc
            parts = [bucketed(piece, level + 1)
                     for piece in ooc.split_batch_by_hash(
                         ctx, key_idx, b, n, level, growth)]
            if not parts:
                return update(b)
            return concat_device(parts, self.plan.partial_schema, growth,
                                 b.device, dm=dm)
        return bucketed

    # -- the partial pass and its skip ---------------------------------------
    def _partial(self, ctx: ExecContext, part: Partition, update,
                 hash_table, skip_ratio: float) -> Iterator[DeviceBatch]:
        """The partial pass with the runtime partial-aggregation skip (the
        JAX package's agg.runtimeSkip, its default; its first-batch
        alternative is not ported): measure output groups / input rows as
        batches stream, one counted sync a sampled batch, and switch to
        passthrough mid-stream once the cumulative ratio exceeds the
        threshold. The decision seeds the session's ratio cache, keyed on
        the plan's fingerprint (its data identity included), so later
        executions decide from batch 0 without a sync; a partial that
        shrank its capacity proves a strong reduction without one and
        decides "update"."""
        it = iter(part())
        first = next(it, None)
        if first is None:
            yield update(empty_batch(self.children[0].output_schema(),
                                     ctx.device))
            return
        cache = ctx.session.agg_ratio_cache if ctx.session else None
        sig = plan_fingerprint(self) + "|ratio"
        adaptive = (skip_ratio < 1.0 and cache is not None
                    and self.plan.num_keys > 0)
        prior = cache.get(sig) if adaptive else None
        if prior is None:
            decided = None if adaptive else "update"
        else:
            decided = "skip" if prior > skip_ratio else "update"
            if decided == "skip":
                EVENTS.emit("aggSkipDecision", decision="skip",
                            source="cache", measuredRatio=float(prior),
                            threshold=skip_ratio)
        partials = []
        in_rows = out_rows = sampled = 0
        b = first
        while b is not None:
            if decided == "skip":
                yield self._passthrough(b)
                b = next(it, None)
                continue
            part_b = update(b)
            partials.append(part_b)
            if decided is None:
                if part_b.capacity < b.capacity:
                    decided = "update"
                else:
                    with sync_scope("agg.runtimeSkip", nbytes=4):
                        out_rows += int(part_b.num_rows.item())
                    in_rows += b.num_rows_hint()
                    sampled += 1
                    measured = out_rows / max(in_rows, 1)
                    if measured > skip_ratio:
                        decided = "skip"
                        cache[sig] = measured
                        _note_skip(decided, measured, sampled, skip_ratio)
                        yield from partials
                        partials = []
                    elif sampled >= self._SKIP_SAMPLE_BATCHES:
                        decided = "update"
                        cache[sig] = measured
                        _note_skip(decided, measured, sampled, skip_ratio)
            b = next(it, None)
        if decided is None and sampled > 0:
            # the stream ended while still sampling: the cumulative
            # measurement is the plan's decision
            cache[sig] = out_rows / max(in_rows, 1)
            _note_skip("update", cache[sig], sampled, skip_ratio)
        if len(partials) == 1:
            yield partials[0]
        elif partials:
            yield self._merge(concat_device(
                partials, self.plan.partial_schema, ctx.conf.capacity_growth,
                ctx.device, dm=device_manager_of(ctx)), hash_table)

    def partitions(self, ctx: ExecContext) -> List[Partition]:
        from spark_rapids_tpu_torch.exec import outofcore as ooc
        conf = ctx.conf
        skip_ratio = float(conf.get(C.AGG_SKIP_RATIO.key))
        # the JAX package's dense composite keys (agg.denseKeys) are not
        # ported (ROADMAP A.10): its other branches give the same result
        use_hash = (conf.get_bool(C.AGG_HASH_ENABLED.key, False)
                    and self.plan.num_keys > 0)
        hash_table = (int(conf.get(C.AGG_HASH_MAX_SLOTS.key)) if use_hash
                      else None)
        update = self._update_fn(ctx, hash_table)
        growth = conf.capacity_growth
        out_of_core = ooc.enabled_for(ctx) and self.plan.num_keys > 0

        def make(part: Partition) -> Partition:
            def run() -> Iterator[DeviceBatch]:
                src = part
                if out_of_core:
                    # streaming probe: on engagement the unconsumed tail
                    # flows straight into the grace driver's staging pass
                    prefix, rest, engaged = ooc.split_stream_on_budget(
                        ctx, iter(part()))
                    if engaged:
                        yield from ooc.grace_aggregate(
                            ctx, self, itertools.chain(prefix, rest),
                            growth, update, hash_table)
                        return
                    src = lambda pre=prefix: iter(pre)  # noqa: E731
                if self.mode == "partial":
                    yield from self._partial(ctx, src, update, hash_table,
                                             skip_ratio)
                    return
                merged = concat_device(list(src()), self.plan.partial_schema,
                                       growth, ctx.device,
                                       dm=device_manager_of(ctx))
                yield self._finalize(self._merge(merged, hash_table))
            return run
        return [make(p) for p in self.children[0].executed_partitions(ctx)]


class TpuSortExec(TpuExec):
    """reference: GpuSortExec: concat the partition's batches, one device
    sort."""

    def __init__(self, child: PhysicalPlan, orders: Sequence[SortOrder]):
        super().__init__([child])
        self.orders = list(orders)

    def output_schema(self) -> Schema:
        return self.children[0].output_schema()

    def describe(self) -> str:
        return f"TpuSortExec({self.orders})"

    def _key_batch(self, batch: DeviceBatch):
        """(the batch with every sort key appended as a column, their
        indices)."""
        ectx = make_context(batch)
        cols = list(batch.columns)
        key_idx = []
        for o in self.orders:
            cols.append(to_device_column(ectx, o.expr.eval_device(ectx)))
            key_idx.append(len(cols) - 1)
        names = list(batch.schema.names) + [f"_sk{i}"
                                            for i in range(len(key_idx))]
        work = DeviceBatch(Schema(names, [c.dtype for c in cols]), cols,
                           batch.num_rows)
        return work, key_idx

    def _sort(self, batch: DeviceBatch) -> DeviceBatch:
        work, key_idx = self._key_batch(batch)
        out = sortops.sort_batch(work, key_idx,
                                 [o.ascending for o in self.orders],
                                 [o.nulls_first for o in self.orders])
        return DeviceBatch(batch.schema, out.columns[:len(batch.columns)],
                           out.num_rows)

    def partitions(self, ctx: ExecContext) -> List[Partition]:
        from spark_rapids_tpu_torch.exec import outofcore as ooc
        schema = self.output_schema()
        growth = ctx.conf.capacity_growth

        def make(part: Partition) -> Partition:
            def run() -> Iterator[DeviceBatch]:
                if ooc.enabled_for(ctx):
                    # a working set past the budget range-partitions onto
                    # the spill store and sorts bucket by bucket; the
                    # probe streams, never materializing past the budget
                    prefix, rest, engaged = ooc.split_stream_on_budget(
                        ctx, iter(part()))
                    if engaged:
                        yield from ooc.external_sort(
                            ctx, self, itertools.chain(prefix, rest),
                            schema, growth)
                        return
                    batches = prefix
                else:
                    batches = list(part())
                yield self._sort(concat_device(
                    batches, schema, growth, ctx.device,
                    dm=device_manager_of(ctx)))
            return run
        return [make(p) for p in self.children[0].executed_partitions(ctx)]


class TpuLocalLimitExec(TpuExec):
    """reference: GpuLocalLimitExec. The remaining count stays a device
    scalar threaded through one slice per batch; every eighth batch the
    host checks it (one counted sync) to stop draining an unbounded
    child."""

    def __init__(self, child: PhysicalPlan, limit: int):
        super().__init__([child])
        self.limit = limit

    def output_schema(self) -> Schema:
        return self.children[0].output_schema()

    def describe(self) -> str:
        return f"{self.name}({self.limit})"

    def _take(self, batches) -> Iterator[DeviceBatch]:
        remaining = None
        for i, batch in enumerate(batches):
            if remaining is None:
                remaining = torch.full((), self.limit, dtype=torch.int32,
                                       device=batch.device)
            elif (i + 1) % 8 == 0:
                with sync_scope("limit.remaining", nbytes=4):
                    if int(remaining.item()) <= 0:
                        return
            out = rowops.slice_batch(batch, 0, remaining)
            remaining = remaining - out.num_rows
            yield out

    def partitions(self, ctx: ExecContext) -> List[Partition]:
        def make(part: Partition) -> Partition:
            def run() -> Iterator[DeviceBatch]:
                return self._take(part())
            return run
        return [make(p) for p in self.children[0].executed_partitions(ctx)]


class TpuGlobalLimitExec(TpuLocalLimitExec):
    pass


class TpuCollectLimitExec(TpuLocalLimitExec):
    """Root-position limit (reference: GpuCollectLimitExec): one output
    partition draining the children in order."""

    def partitions(self, ctx: ExecContext) -> List[Partition]:
        child_parts = self.children[0].executed_partitions(ctx)

        def run() -> Iterator[DeviceBatch]:
            return self._take(b for p in child_parts for b in p())
        return [run]


class TpuCoalescePartitionsExec(TpuExec):
    """Narrow partition merge (Spark's CoalesceExec): child partitions
    grouped contiguously, no device work."""

    def __init__(self, child: PhysicalPlan, n: int):
        super().__init__([child])
        self.n = max(1, int(n))

    def output_schema(self) -> Schema:
        return self.children[0].output_schema()

    def describe(self) -> str:
        return f"TpuCoalescePartitionsExec({self.n})"

    def partitions(self, ctx: ExecContext) -> List[Partition]:
        groups = group_contiguous(self.children[0].executed_partitions(ctx),
                                  self.n)
        schema = self.output_schema()

        def make(group: List[Partition]) -> Partition:
            def run() -> Iterator[DeviceBatch]:
                got = False
                for p in group:
                    for b in p():
                        got = True
                        yield b
                if not got:
                    yield empty_batch(schema, ctx.device)
            return run
        return [make(g) for g in groups]


class TpuUnionExec(TpuExec):
    """reference: GpuUnionExec: the children's partitions, in order."""

    def output_schema(self) -> Schema:
        return self.children[0].output_schema()

    def partitions(self, ctx: ExecContext) -> List[Partition]:
        return [p for c in self.children for p in c.executed_partitions(ctx)]


class TpuRangeExec(TpuExec):
    """reference: GpuRangeExec: the sequence generated on the device."""

    def __init__(self, start: int, end: int, step: int, num_partitions: int,
                 name: str = "id"):
        super().__init__()
        self.start, self.end, self.step = start, end, step
        self.num_partitions = num_partitions
        self.col_name = name

    def output_schema(self) -> Schema:
        return Schema([self.col_name], [dtypes.INT64])

    def partitions(self, ctx: ExecContext) -> List[Partition]:
        total = max(0, -(-(self.end - self.start) // self.step))
        per = -(-total // self.num_partitions) if total else 0
        schema = self.output_schema()
        cap = bucket_capacity(max(per, 1), ctx.conf.capacity_growth)

        def make(i: int) -> Partition:
            def run() -> Iterator[DeviceBatch]:
                lo = i * per
                n = max(min(total, (i + 1) * per) - lo, 0)
                idx = torch.arange(cap, dtype=torch.int64, device=ctx.device)
                col = DeviceColumn(dtypes.INT64,
                                   self.start + (lo + idx) * self.step,
                                   idx < n)
                batch = DeviceBatch(schema, [col], torch.full(
                    (), n, dtype=torch.int32, device=ctx.device))
                batch.host_rows = n
                yield batch
            return run
        return [make(i) for i in range(self.num_partitions)]


class TpuExpandExec(TpuExec):
    """reference: GpuExpandExec: each input batch through every projection
    set."""

    def __init__(self, child: PhysicalPlan, projections):
        super().__init__([child])
        self.projections = [list(p) for p in projections]

    def output_schema(self) -> Schema:
        cs = self.children[0].output_schema()
        first = self.projections[0]
        return Schema([n for n, _ in first],
                      [e.dtype(cs) for _, e in first])

    def describe(self) -> str:
        return f"TpuExpandExec({len(self.projections)} sets)"

    def partitions(self, ctx: ExecContext) -> List[Partition]:
        def make(part: Partition) -> Partition:
            def run() -> Iterator[DeviceBatch]:
                for batch in part():
                    for proj in self.projections:
                        yield eval_projection(batch, [e for _, e in proj],
                                              [n for n, _ in proj])
            return run
        return [make(p) for p in self.children[0].executed_partitions(ctx)]


class TpuScanExec(TpuExec):
    """Columnar scan. An in-memory source's partitions are uploaded in
    ``batchSizeRows`` chunks (``exec/transitions.upload_frames``), as are
    a CSV or ORC source's, decoded by pyarrow. A Parquet source's row
    groups that its pushed filters leave (``pushed_filters``, pruned by
    the footers' statistics and the partition values; the count pruned in
    the query's metrics) are packed into partitions of at most
    ``batchSizeRows`` rows (``transitions.pack_splits``); each row group
    is decoded on the device (``upload_partition``, kernels B5-B8), a
    column the kernels do not decode by pyarrow on the host
    (``scan.device.fallbackColumns``; the JAX package's
    ``spark.rapids.sql.scan.deviceDecode``, off there by default, is not
    an option of the port). Every batch of a scan shares one dictionary
    registry; with ``cacheDeviceScans`` each uploaded batch registers in
    the session's spill catalog (metered, spillable) and a later execution
    replays it, faulted back where it was spilled. A partition's upload
    takes the session's semaphore."""

    def __init__(self, source, schema: Schema, pushed_filters=None):
        super().__init__()
        self.source = source
        self._schema = schema
        self.pushed_filters = pushed_filters

    def output_schema(self) -> Schema:
        return self._schema

    def describe(self) -> str:
        return f"TpuScanExec({self.source.describe()})"

    def fingerprint_extra(self) -> str:
        from spark_rapids_tpu_torch.exec.cpu import scan_fingerprint
        return scan_fingerprint(self.source, self.pushed_filters,
                                self._schema)

    def partitions(self, ctx: ExecContext) -> List[Partition]:
        from spark_rapids_tpu_torch.exec.cpu import kept_splits
        from spark_rapids_tpu_torch.exec.transitions import (
            cache_uploads, chain_partitions, pack_splits, replay_cached,
            scan_cache_for, upload_blocked_chars, upload_frames,
            upload_partition,
        )
        max_rows = ctx.conf.batch_size_rows
        cache = scan_cache_for(ctx, self.source, self._schema, max_rows,
                               self.pushed_filters)
        dict_state: dict = {}
        max_stride = upload_blocked_chars(ctx.conf)
        splits = kept_splits(ctx, self.source, self.pushed_filters)
        raw_parts = self.source.raw_partitions(
            max_stride, splits=splits,
            page_cache=getattr(ctx.session, "page_cache", None))
        parts = (raw_parts if raw_parts is not None
                 else self.source.cpu_partitions(splits))
        split_rows = self.source.split_rows(splits)
        if split_rows is not None:
            parts = chain_partitions(parts, pack_splits(split_rows, max_rows))

        # a cached batch is metered once, by the catalog it registers in
        meter = cache is None

        def upload(part: Partition) -> Iterator[DeviceBatch]:
            if raw_parts is not None:
                return upload_partition(part, self._schema, dict_state,
                                        ctx.device, ctx.session, meter)
            return upload_frames(part, max_rows, dict_state, ctx.device,
                                 ctx.session, meter, max_stride,
                                 self._schema)

        def make(i: int, part: Partition) -> Partition:
            def run() -> Iterator[DeviceBatch]:
                if ctx.session is not None:
                    ctx.session.semaphore.acquire_if_necessary()
                if cache is not None and i in cache:
                    return replay_cached(ctx.session, cache[i])
                if cache is None:
                    return upload(part)
                return cache_uploads(ctx.session, cache, i, upload(part))
            return run
        return [make(i, p) for i, p in enumerate(parts)]


class TpuShuffleExchangeExec(TpuExec):
    """reference: GpuShuffleExchangeExec + GpuPartitioning
    (GpuShuffleExchangeExec.scala:60-215, GpuPartitioning.scala:41-75), the
    JAX package's one-device routes. Each exchange edge picks one
    (``shuffle/manager.select_transport_kind``):

      * LOCAL collapse (a single exchange, and a hash or range one under
        ``spark.rapids.sql.shuffle.localCollapse``, the default): one
        partition of the child's batches passed on as they are (no copy,
        no host sync); its consumers concatenate what they need whole, and
        a join's stream side keeps its batches, each probed on its own;
      * LOCAL buckets (hash and range with ``localCollapse=false``, and
        round-robin, the user-visible ``repartition(n)`` shape, always):
        every child batch split on the device by partition id
        (``split_by_pid``: hash ``row_hashes(keys)[0] mod n``, range the
        sampled bounds' ``sortops.range_partition_ids``, round-robin the
        row position mod n), the per-id counts read in one counted
        ``exchange.split`` sync per window of 16 batches, each non-empty
        slice held in the spill catalog at the ``OUTPUT_FOR_READ`` band;
        each of the n partitions consumes its slices once and
        concatenates them (a second read raises);
      * MANAGER (``spark.rapids.shuffle.transport.enabled``): the same
        slices per map task written to the shuffle manager's executors
        (``CachingShuffleWriter``), each partition read back through
        ``CachingShuffleReader`` on executor 0, over the transport for
        another executor's blocks, with a bounded retry per peer group.

    A range exchange first reads up to 128 evenly spaced samples of every
    batch's sort-key operands and its row count in one counted
    ``exchange.rangeBounds`` sync; ``pick_bounds_from_samples`` makes the
    n-1 bounds."""

    def __init__(self, child: PhysicalPlan, partitioning):
        super().__init__([child])
        self.partitioning = partitioning

    def output_schema(self) -> Schema:
        return self.children[0].output_schema()

    def describe(self) -> str:
        return f"TpuShuffleExchangeExec({self.partitioning[0]})"

    def fingerprint_extra(self) -> str:
        return repr(self.partitioning)

    def _pids(self, batch: DeviceBatch, bounds) -> torch.Tensor:
        """int64 partition id of every row."""
        kind, n = self.partitioning[0], self.partitioning[-1]
        if kind == "roundrobin":
            # row-level round robin like Spark's repartition(n): every
            # output partition receives an even share of each batch
            return torch.arange(batch.capacity, dtype=torch.int64,
                                device=batch.device) % n
        if kind == "hash":
            from spark_rapids_tpu_torch.ops.groupby import row_hashes
            h1, _h2 = row_hashes(batch, list(self.partitioning[1]))
            return agg_ops._umod(h1, n)
        key_idx, asc, nf = self.partitioning[1:4]
        return sortops.range_partition_ids(batch, key_idx, asc, nf, bounds)

    def _range_bounds(self, batches: List[DeviceBatch], schema: Schema,
                      device) -> List[torch.Tensor]:
        """Sampled sort-key operands -> n-1 lexicographic upper bounds
        (GpuRangePartitioner.scala:42-120): each batch's
        ``np.linspace(0, rows - 1, min(rows, 128))`` rows, picked on the
        device, fetched with the row counts in one counted sync."""
        import numpy as np
        from spark_rapids_tpu_torch.columnar.column import host_to_device
        from spark_rapids_tpu_torch.parallel.distributed import (
            pick_bounds_from_samples,
        )
        key_idx, asc, nf, n = self.partitioning[1:]
        m = _RANGE_SAMPLES
        flats = []
        k = None
        for b in batches:
            ops = sortops.sort_key_operands(b, key_idx, asc, nf, exact=False)
            k = len(ops)
            rows = b.num_rows.to(torch.int64)
            take = rows.clamp(max=m)
            i = torch.arange(m, dtype=torch.int64, device=b.device)
            # np.linspace's float64 steps, its last row exact
            step = ((rows - 1).clamp(min=0).to(torch.float64)
                    / (take - 1).clamp(min=1).to(torch.float64))
            pos = (i.to(torch.float64) * step).to(torch.int64)
            pos = torch.where(i == take - 1, rows - 1, pos)
            pos = pos.clamp(0, b.capacity - 1)
            flats.append(torch.cat([torch.stack([o[pos] for o in ops])
                                    .reshape(-1), rows.reshape(1)]))
        samples = []
        if flats:
            flat = torch.cat(flats)
            with sync_scope("exchange.rangeBounds",
                            nbytes=flat.numel() * 8,
                            detail=f"batches={len(batches)}"):
                host = flat.cpu().numpy()
            per = k * m + 1
            for bi, b in enumerate(batches):
                got = host[bi * per:(bi + 1) * per]
                rows = int(got[-1])
                b.host_rows = rows
                if rows == 0:
                    continue
                ops = got[:-1].reshape(k, m)[:, :min(rows, m)]
                samples.append(np.ascontiguousarray(ops).view(np.uint64))
        else:
            # no batches at all: the operand count from an empty probe
            k = len(sortops.sort_key_operands(empty_batch(schema, device),
                                              key_idx, asc, nf, exact=False))
        return [host_to_device(np.ascontiguousarray(b).view(np.int64),
                               device)
                for b in pick_bounds_from_samples(samples, k, n)]

    def _split_to_slices(self, batches: List[DeviceBatch], bounds,
                         growth: float):
        """(batch index, pid, slice) of every non-empty (batch, pid): each
        batch split by partition id, the counts fetched one window of
        _SPLIT_WINDOW batches at a time (one round trip a window; one
        giant window would pin every split output at once), each slice cut
        to the capacity bucket of its known row count."""
        n = self.partitioning[-1]
        for w0 in range(0, len(batches), _SPLIT_WINDOW):
            window = [(bi, split_by_pid(b, self._pids(b, bounds), n))
                      for bi, b in enumerate(batches[w0:w0 + _SPLIT_WINDOW],
                                             w0)]
            counts = torch.stack([c for _bi, (_s, c) in window])
            with sync_scope("exchange.split", nbytes=counts.numel() * 8,
                            detail=f"window={len(window)}"):
                host = counts.cpu().numpy()
            for (bi, (sorted_b, _c)), host_counts in zip(window, host):
                start = 0
                for pid in range(n):
                    cnt = int(host_counts[pid])
                    if cnt:
                        piece = rowops.slice_batch_to(
                            sorted_b, start, cnt,
                            bucket_capacity(cnt, growth))
                        piece.host_rows = cnt
                        yield bi, pid, piece
                    start += cnt

    def partitions(self, ctx: ExecContext) -> List[Partition]:
        from spark_rapids_tpu_torch.shuffle.manager import (
            ShuffleTransportKind, select_transport_kind,
        )
        child_parts = self.children[0].executed_partitions(ctx)
        schema = self.output_schema()
        kind = self.partitioning[0]
        n_req = self.partitioning[-1] if kind != "single" else 1
        tkind = select_transport_kind(ctx.conf, ctx.session, kind, n_req)
        # round-robin never collapses: it is the user-visible
        # repartition(n) shape (the partition and file count of a write)
        collapse = (tkind is ShuffleTransportKind.LOCAL
                    and kind in ("hash", "range")
                    and ctx.conf.get_bool(C.SHUFFLE_LOCAL_COLLAPSE.key, True))
        if kind == "single" or collapse:
            def collapsed() -> Iterator[DeviceBatch]:
                got = False
                for p in child_parts:
                    for b in p():
                        got = True
                        yield b
                if not got:
                    yield empty_batch(schema, ctx.device)
            return [collapsed]
        if tkind is ShuffleTransportKind.MANAGER:
            return self._manager_partitions(ctx, child_parts, schema)
        return self._bucket_partitions(ctx, child_parts, schema)

    def _concat(self, ctx: ExecContext, pieces: List[DeviceBatch],
                schema: Schema) -> DeviceBatch:
        """One batch of a partition's pieces, its row count known on the
        host where every piece's is."""
        out = concat_device(pieces, schema, ctx.conf.capacity_growth,
                            ctx.device, dm=device_manager_of(ctx))
        if pieces and all(p.host_rows is not None for p in pieces):
            out.host_rows = sum(p.host_rows for p in pieces)
        return out

    def _bucket_partitions(self, ctx: ExecContext, child_parts,
                           schema: Schema) -> List[Partition]:
        """LOCAL buckets: the slices of every child batch in the spill
        catalog (spilled first under pressure, SpillPriorities.scala:
        26-50); each partition acquires its own (faulting spilled ones
        back) and frees them on consumption."""
        from spark_rapids_tpu_torch.memory.spill import SpillPriorities
        n = self.partitioning[-1]
        growth = ctx.conf.capacity_growth
        session = ctx.session
        state = {"buckets": None}

        def materialize():
            if state["buckets"] is not None:
                return state["buckets"]
            buckets: List[list] = [[] for _ in range(n)]
            batches = [b for p in child_parts for b in p()]
            bounds = (self._range_bounds(batches, schema, ctx.device)
                      if self.partitioning[0] == "range" else None)
            for _bi, pid, piece in self._split_to_slices(batches, bounds,
                                                         growth):
                buckets[pid].append(
                    session.add_transient_batch(
                        piece, SpillPriorities.OUTPUT_FOR_READ)
                    if session is not None else piece)
            state["buckets"] = buckets
            return buckets

        def make(pid: int) -> Partition:
            def run() -> Iterator[DeviceBatch]:
                buckets = materialize()
                if buckets[pid] is None:
                    raise RuntimeError(f"shuffle partition {pid} already "
                                       "consumed (freed on use)")
                if not buckets[pid]:
                    yield empty_batch(schema, ctx.device)
                    return
                if session is not None:
                    pieces = []
                    for bid in buckets[pid]:
                        pieces.append(session.buffer_catalog.acquire_batch(
                            bid))
                        session.consume_transient(bid)
                    buckets[pid] = None
                else:
                    pieces = buckets[pid]
                yield self._concat(ctx, pieces, schema)
            return run
        return [make(i) for i in range(n)]

    def _manager_partitions(self, ctx: ExecContext, child_parts,
                            schema: Schema) -> List[Partition]:
        """MANAGER: map tasks stripe across the session's executors
        (``spark.rapids.shuffle.executors``); with more than one, the
        reduce side's fetches of other executors' blocks traverse the
        transport (serializer -> server -> client). Each peer group moves
        in one metadata/transfer round trip and a failure re-fetches only
        that peer's blocks, still registered on the map side, up to
        ``spark.rapids.shuffle.maxFetchRetries`` times."""
        from spark_rapids_tpu_torch.shuffle.manager import (
            CachingShuffleReader, CachingShuffleWriter,
        )
        n = self.partitioning[-1]
        growth = ctx.conf.capacity_growth
        session = ctx.session
        mstate = {"statuses": None}

        def materialize():
            if mstate["statuses"] is not None:
                return mstate["statuses"]
            envs = session.shuffle_envs
            shuffle_id = session.next_shuffle_id()
            per_map = [list(p()) for p in child_parts]
            bounds = (self._range_bounds([b for bs in per_map for b in bs],
                                         schema, ctx.device)
                      if self.partitioning[0] == "range" else None)
            statuses = []
            for mi, batches in enumerate(per_map):
                per_pid: List[List[DeviceBatch]] = [[] for _ in range(n)]
                for _bi, pid, piece in self._split_to_slices(
                        batches, bounds, growth):
                    per_pid[pid].append(piece)
                writer = CachingShuffleWriter(envs[mi % len(envs)],
                                              shuffle_id, mi)
                statuses.append(writer.write(per_pid))
            if statuses and ctx.metrics_enabled:
                # per-shuffle skew from the device byte sizes the writer
                # recorded (MapStatus.partition_sizes)
                from spark_rapids_tpu_torch.obs.shuffleobs import (
                    record_shuffle_skew,
                )
                from spark_rapids_tpu_torch.shuffle.manager import (
                    aggregate_map_statistics,
                )
                record_shuffle_skew(
                    aggregate_map_statistics(statuses).bytes_by_partition,
                    source=f"tpu:manager-{shuffle_id}")
            mstate["statuses"] = (shuffle_id, statuses)
            return mstate["statuses"]

        def make(pid: int) -> Partition:
            def run() -> Iterator[DeviceBatch]:
                shuffle_id, statuses = materialize()
                reader = CachingShuffleReader(session.shuffle_env)
                batches: List[DeviceBatch] = []
                for peer, group in reader.peer_groups(statuses):
                    batches.extend(_read_with_retry(
                        ctx, reader, shuffle_id, pid, peer, group))
                if not batches:
                    yield empty_batch(schema, ctx.device)
                    return
                yield self._concat(ctx, batches, schema)
            return run
        return [make(i) for i in range(n)]


# a range exchange's samples per batch, and the batches whose split counts
# one exchange.split sync fetches
_RANGE_SAMPLES = 128
_SPLIT_WINDOW = 16


def _read_with_retry(ctx: ExecContext, reader, shuffle_id: int, pid: int,
                     peer, group) -> List[DeviceBatch]:
    """One peer group's blocks of partition ``pid``, re-read on a
    ShuffleFetchFailedError up to ``spark.rapids.shuffle.maxFetchRetries``
    times (each retry counted in ``shuffle.fetch.retries``, a
    ``shuffle.fetch.retry`` instant and a ``fetchRetry`` event); the last
    failure propagates (RapidsShuffleClient.scala:409-418)."""
    import logging

    from spark_rapids_tpu_torch.obs.metrics import REGISTRY
    from spark_rapids_tpu_torch.obs.progress import PROGRESS
    from spark_rapids_tpu_torch.obs.trace import TRACER
    from spark_rapids_tpu_torch.shuffle.client import ShuffleFetchFailedError
    max_retries = ctx.conf.get_int(C.SHUFFLE_FETCH_RETRIES.key, 3)
    attempt = 0
    while True:
        try:
            return reader.read_group(shuffle_id, pid, peer, group)
        except ShuffleFetchFailedError as e:
            attempt += 1
            if attempt > max_retries:
                raise
            REGISTRY.counter("shuffle.fetch.retries").add(1)
            TRACER.instant("shuffle.fetch.retry", peer=str(peer),
                           attempt=attempt)
            EVENTS.emit("fetchRetry", peer=str(peer), attempt=attempt,
                        error=str(e)[:200])
            if PROGRESS.enabled:
                PROGRESS.shuffle_retry()
            logging.getLogger(__name__).warning(
                "shuffle fetch failed (%s); retrying %d/%d", e, attempt,
                max_retries)

"""Device columnar physical operators (counterpart of the JAX package's
``exec/tpu.py``; the joins are in ``exec/tpujoin.py``).

Where the JAX package compiles each operator's per-batch work into one
``jax.jit`` program, each operator here runs its PyTorch ops and the
port's kernels eagerly, one batch at a time, without a host sync: row
counts stay on the device. Ported: Scan (in-memory uploads and Parquet
files), Project, Filter, HashAggregate (partial and final, with the
runtime partial skip), Sort, the three limits, CoalescePartitions, Union,
Range, Expand, and the shuffle exchange's one-device collapse.

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
  * the out-of-core split of a batch whose hash table exceeds
    ``agg.hash.maxTableSlots`` (``exec/outofcore.py``, ROADMAP A.8): such a
    batch aggregates on the sorted-payload branch instead, with the same
    result;
  * the exchange's capacity shrink (a counted sync), its speculation, and
    the multi-device routes (ROADMAP A.9): on one device a hash or range
    exchange is one partition of the child's batches, with no sync.
"""

from __future__ import annotations

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


def concat_device(batches: List[DeviceBatch], schema: Schema,
                  growth: float, device) -> DeviceBatch:
    """Concatenate device batches (GpuCoalesceBatches): one
    ``rowops.concat_batches`` at the bucketed sum of their capacities."""
    if len(batches) == 1:
        return batches[0]
    if not batches:
        return empty_batch(schema, device)
    out_cap = bucket_capacity(sum(b.capacity for b in batches), growth)
    return rowops.concat_batches(batches, out_cap)


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
        def make(part: Partition) -> Partition:
            def run() -> Iterator[DeviceBatch]:
                for batch in part():
                    yield self._project(batch)
            return run
        return [make(p)
                for p in self.children[0].executed_partitions(ctx)]


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
        def make(part: Partition) -> Partition:
            def run() -> Iterator[DeviceBatch]:
                for batch in part():
                    yield self._filter(batch)
            return run
        return [make(p)
                for p in self.children[0].executed_partitions(ctx)]


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

    # -- the partial pass and its skip ---------------------------------------
    def _partial(self, ctx: ExecContext, part: Partition, hash_table,
                 skip_ratio: float) -> Iterator[DeviceBatch]:
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
            yield self._update(empty_batch(self.children[0].output_schema(),
                                           ctx.device), hash_table)
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
        partials = []
        in_rows = out_rows = sampled = 0
        b = first
        while b is not None:
            if decided == "skip":
                yield self._passthrough(b)
                b = next(it, None)
                continue
            part_b = self._update(b, hash_table)
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
                        yield from partials
                        partials = []
                    elif sampled >= self._SKIP_SAMPLE_BATCHES:
                        decided = "update"
                        cache[sig] = measured
            b = next(it, None)
        if decided is None and sampled > 0:
            # the stream ended while still sampling: the cumulative
            # measurement is the plan's decision
            cache[sig] = out_rows / max(in_rows, 1)
        if len(partials) == 1:
            yield partials[0]
        elif partials:
            yield self._merge(concat_device(
                partials, self.plan.partial_schema, ctx.conf.capacity_growth,
                ctx.device), hash_table)

    def partitions(self, ctx: ExecContext) -> List[Partition]:
        conf = ctx.conf
        skip_ratio = float(conf.get(C.AGG_SKIP_RATIO.key))
        # the JAX package's dense composite keys (agg.denseKeys) are not
        # ported (ROADMAP A.10): its other branches give the same result
        use_hash = (conf.get_bool(C.AGG_HASH_ENABLED.key, False)
                    and self.plan.num_keys > 0)
        hash_table = (int(conf.get(C.AGG_HASH_MAX_SLOTS.key)) if use_hash
                      else None)

        def make(part: Partition) -> Partition:
            def run() -> Iterator[DeviceBatch]:
                if self.mode == "partial":
                    yield from self._partial(ctx, part, hash_table,
                                             skip_ratio)
                    return
                merged = concat_device(list(part()), self.plan.partial_schema,
                                       conf.capacity_growth, ctx.device)
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

    def _sort(self, batch: DeviceBatch) -> DeviceBatch:
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
        out = sortops.sort_batch(work, key_idx,
                                 [o.ascending for o in self.orders],
                                 [o.nulls_first for o in self.orders])
        return DeviceBatch(batch.schema, out.columns[:len(batch.columns)],
                           out.num_rows)

    def partitions(self, ctx: ExecContext) -> List[Partition]:
        schema = self.output_schema()

        def make(part: Partition) -> Partition:
            def run() -> Iterator[DeviceBatch]:
                yield self._sort(concat_device(
                    list(part()), schema, ctx.conf.capacity_growth,
                    ctx.device))
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
    ``batchSizeRows`` chunks (``exec/transitions.upload_frames``). A
    Parquet source's row groups are packed into partitions of at most
    ``batchSizeRows`` rows (``transitions.pack_splits``); each row group
    is decoded on the device (``upload_partition``, kernels B5-B8), a
    column the kernels do not decode by pyarrow on the host
    (``scan.device.fallbackColumns``; the JAX package's
    ``spark.rapids.sql.scan.deviceDecode``, off there by default, is not
    an option of the port). Every batch of a scan shares one dictionary
    registry; with ``cacheDeviceScans`` a later execution replays the
    device batches."""

    def __init__(self, source, schema: Schema):
        super().__init__()
        self.source = source
        self._schema = schema

    def output_schema(self) -> Schema:
        return self._schema

    def describe(self) -> str:
        return f"TpuScanExec({self.source.describe()})"

    def fingerprint_extra(self) -> str:
        return f"{self.source.data_uid()}|{','.join(self._schema.names)}"

    def partitions(self, ctx: ExecContext) -> List[Partition]:
        from spark_rapids_tpu_torch.exec.transitions import (
            chain_partitions, pack_splits, scan_cache_for,
            upload_blocked_chars, upload_frames, upload_partition,
        )
        max_rows = ctx.conf.batch_size_rows
        cache = scan_cache_for(ctx, self.source, self._schema, max_rows)
        dict_state: dict = {}
        raw_parts = self.source.raw_partitions(upload_blocked_chars())
        parts = (raw_parts if raw_parts is not None
                 else self.source.cpu_partitions())
        split_rows = self.source.split_rows()
        if split_rows is not None:
            parts = chain_partitions(parts, pack_splits(split_rows, max_rows))

        def upload(part: Partition) -> Iterator[DeviceBatch]:
            if raw_parts is not None:
                return upload_partition(part, self._schema, dict_state,
                                        ctx.device)
            return upload_frames(part, max_rows, dict_state, ctx.device)

        def make(i: int, part: Partition) -> Partition:
            def run() -> Iterator[DeviceBatch]:
                if cache is not None and i in cache:
                    return iter(cache[i])
                if cache is None:
                    return upload(part)
                cache[i] = list(upload(part))
                return iter(cache[i])
            return run
        return [make(i, p) for i, p in enumerate(parts)]


class TpuShuffleExchangeExec(TpuExec):
    """reference: GpuShuffleExchangeExec, on one device: a hash, range or
    single exchange collapses its child's partitions into one, passing the
    batches on as they are (no copy, no host sync); its consumers, the
    final aggregate, the sort, the join's build side, concatenate what
    they need whole. A join's stream side thus keeps its batches, each
    probed on its own, as the query runners probe them. The round-robin
    exchange is not converted (it stays on the CPU)."""

    def __init__(self, child: PhysicalPlan, partitioning):
        super().__init__([child])
        self.partitioning = partitioning

    def output_schema(self) -> Schema:
        return self.children[0].output_schema()

    def describe(self) -> str:
        return f"TpuShuffleExchangeExec({self.partitioning[0]})"

    def fingerprint_extra(self) -> str:
        return repr(self.partitioning)

    def partitions(self, ctx: ExecContext) -> List[Partition]:
        child_parts = self.children[0].executed_partitions(ctx)
        schema = self.output_schema()

        def collapse() -> Iterator[DeviceBatch]:
            got = False
            for p in child_parts:
                for b in p():
                    got = True
                    yield b
            if not got:
                yield empty_batch(schema, ctx.device)
        return [collapse]

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

Adaptive pieces of the JAX package (ROADMAP A.10), on by default there
and here:
  * the filter fusions (``exec/fusion.py``): a filter under a partial
    aggregate is its live mask (``TpuHashAggregateExec(pre_mask=)``, on
    every branch, the runtime skip's pass-through and ``_bucketed_update``
    included); a pure selection above a filter is its output selection
    (``TpuFilterExec(out_sel=)``); a filter under a collapse or a broadcast
    folds into one masked concat (``_fused_filter_source``);
  * the dense composite grouping key (``agg.denseKeys``,
    ``_dense_group_plan``), from a plan's second execution, under the
    session's capacity speculation;
  * the exchange's capacity shrink (``_collapse_partitions``): a collapse
    over a padded producer (an aggregate, a limit, a semi or anti join,
    ``_padded_producer``) reads every batch's live rows and plain-string
    char totals in one counted ``exchange.shrink`` sync, slices each
    batch to its bucket and concatenates; warm runs of a deterministic
    subtree take the counts from the session cache once two runs agreed
    and verify them exactly at the query's end. A collapse over anything
    else passes the child's batches on with no copy and no sync;
  * ``materialize_stage``, the AQE stage barrier (one counted
    ``aqe.stageFetch`` a stage).
The JAX package's small-query fast path, which skips the shrink for one
resident batch, is not ported (ROADMAP); nor is the exchange's mesh
route (``shuffle/ici.py``, an all_to_all across cards; ROADMAP A.9). The
first-batch partial-skip heuristic (``agg.runtimeSkip=false``) is not
ported either: the partial pass always decides its skip at run time, the
JAX package's default.
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
# by its live rows instead (one counted ``concat.liveRows`` sync, where a
# batch's row count is not known on the host). Padded partials reaching a
# collapsed exchange are shrunk there first (``exchange.shrink``), so this
# catches the concats no exchange shrinks: a final aggregate's or a
# sort's input over the buckets or the shuffle manager, and a join's
# build side
CONCAT_SHRINK_ROWS = 1 << 27
# the concats that read their live rows, since the last reset
CONCAT_SHRINKS = {"synced": 0}


def reset_concat_shrinks() -> None:
    CONCAT_SHRINKS["synced"] = 0


def device_manager_of(ctx: ExecContext):
    """The session's device budget meter, or None outside a session."""
    return getattr(ctx.session, "device_manager", None)


def _out_of_core(conf, session) -> bool:
    """``exec/outofcore.enabled_for`` from a conf and a session."""
    return session is not None and conf.get_bool(C.OOC_ENABLED.key, False)


def exchange_routes(node: PhysicalPlan, ctx: ExecContext) -> str:
    """The route of every shuffle exchange in ``node``'s subtree, in
    pre-order: part of a capacity speculation key, since sizes learned on
    one route (one collapsed partition, one concatenated batch) are not
    another's (n buckets, their slices)."""
    return ",".join(n.route(ctx.conf, ctx.session) for n in node.walk()
                    if isinstance(n, TpuShuffleExchangeExec))


def concat_device(batches: List[DeviceBatch], schema: Schema,
                  growth: float, device, dm=None,
                  coarse: bool = False) -> DeviceBatch:
    """Concatenate device batches (GpuCoalesceBatches): one
    ``rowops.concat_batches`` at the bucketed sum of their capacities, or
    of their live rows past CONCAT_SHRINK_ROWS. A new output is metered
    on ``dm`` (a ``memory/device.TpuDeviceManager``) where given.
    ``coarse``: the capacity pads up the shape-bucket ladder
    (``utils/kernelcache.bucket_dim``), a single batch included; the
    identity while the buckets are off."""
    if not batches:
        return empty_batch(schema, device)
    if len(batches) == 1:
        if not coarse:
            return batches[0]
        from spark_rapids_tpu_torch.utils.kernelcache import bucket_dim
        if bucket_dim(batches[0].capacity) == batches[0].capacity:
            return batches[0]
    out = _concat(batches, growth, coarse)
    if dm is not None:
        dm.meter_batch(out)
    return out


def _concat(batches: List[DeviceBatch], growth: float,
            coarse: bool = False) -> DeviceBatch:
    from spark_rapids_tpu_torch.utils.kernelcache import bucket_dim
    out_cap = bucket_capacity(sum(b.capacity for b in batches), growth)
    if coarse:
        out_cap = bucket_dim(out_cap)
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


def _fused_filter_source(node: PhysicalPlan):
    """(source node, mask function, out_sel) for a collapse or broadcast
    concat whose exchange claims the filter below it (its
    ``claims_filter``, under ``spark.rapids.sql.exchange.fuseFilter``): a
    deterministic TpuFilterExec directly below (looking through one
    TpuCoalesceBatchesExec, which the concat makes redundant) folds its
    predicate into the concat's single compaction gather
    (``concat_batches(keep_masks=)``) instead of compacting every batch,
    the exchange-side sibling of ``exec/fusion.fuse_filter_into_aggregate``.
    ``out_sel`` is the filter's fused output selection, applied as a
    column view before the concat. (node, None, None) where nothing fuses.
    ``claimed_filter`` names the nodes it folds; the whole-stage cutter
    leaves them out of its stages."""
    claimed = claimed_filter(node)
    if not claimed:
        return node, None, None
    filt = claimed[-1]
    cond = filt.condition

    def mask(batch: DeviceBatch) -> torch.Tensor:
        ectx = make_context(batch)
        pred = to_device_column(ectx, cond.eval_device(ectx))
        return pred.data & pred.validity & batch.row_mask()
    return filt.children[0], mask, filt.out_sel


def claimed_filter(node: PhysicalPlan) -> list:
    """The nodes a claiming exchange above ``node`` folds into its concat:
    [coalesce, filter] or [filter] for a deterministic TpuFilterExec at
    ``node`` or under one TpuCoalesceBatchesExec there, else []."""
    from spark_rapids_tpu_torch.exec.coalesce import TpuCoalesceBatchesExec
    chain = []
    if isinstance(node, TpuCoalesceBatchesExec):
        chain.append(node)
        node = node.children[0]
    if isinstance(node, TpuFilterExec) and not node._impure:
        return chain + [node]
    return []


def fused_concat(batches: List[DeviceBatch], masks, out_sel,
                 schema: Schema, growth: float, device, dm=None
                 ) -> DeviceBatch:
    """One batch of ``batches`` with a fused filter's keep masks applied
    in the concat's one compaction (``_fused_filter_source``)."""
    if not batches:
        return empty_batch(schema, device)
    if out_sel is not None:
        batches = [_select_view(b, out_sel) for b in batches]
    out = rowops.concat_batches(
        batches, bucket_capacity(sum(b.capacity for b in batches), growth),
        keep_masks=masks)
    if dm is not None:
        dm.meter_batch(out)
    return out


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
        from spark_rapids_tpu_torch.sql.exprs.nondet import (
            has_nondeterministic,
        )
        self._impure = any(has_nondeterministic(e) for _, e in self.exprs)
        # a selection/rename only: column objects re-arranged, no device
        # work
        self._pure_selection = not self._impure and all(
            _as_ref(e) is not None for _, e in self.exprs)

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
    compaction (kernel B1) of every column.

    ``out_sel``: an optional (names, indices) output selection fused from
    a pure-column Project above (``exec/fusion.fuse_selection_into_
    filter``): the predicate evaluates over the FULL input, but the
    compaction gathers ONLY the selected columns."""

    def __init__(self, child: PhysicalPlan, condition: Expression,
                 out_sel=None):
        super().__init__([child])
        self.condition = condition
        self.out_sel = out_sel
        from spark_rapids_tpu_torch.sql.exprs.nondet import (
            has_nondeterministic,
        )
        self._impure = has_nondeterministic(condition)

    def output_schema(self) -> Schema:
        cs = self.children[0].output_schema()
        if self.out_sel is None:
            return cs
        names, idx = self.out_sel
        return Schema(list(names), [cs.dtypes[i] for i in idx])

    def describe(self) -> str:
        sel = ("" if self.out_sel is None
               else f", sel={list(self.out_sel[0])}")
        return f"TpuFilterExec({self.condition!r}{sel})"

    def fingerprint_extra(self) -> str:
        return repr(self.condition) + (
            "" if self.out_sel is None else f"|sel={self.out_sel!r}")

    def _filter(self, batch: DeviceBatch) -> DeviceBatch:
        ectx = make_context(batch)
        pred = to_device_column(ectx, self.condition.eval_device(ectx))
        if self.out_sel is not None:
            batch = _select_view(batch, self.out_sel)
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
    merge, finalize.

    ``pre_mask``: a fused pre-filter predicate (``exec/fusion.py``),
    ANDed into the partial's live mask on every branch (and compacting
    the rows of the runtime skip's pass-through), replacing a standalone
    Filter's compaction."""

    # batches sampled before an undecided plan commits to the update path
    _SKIP_SAMPLE_BATCHES = 3

    def __init__(self, child: PhysicalPlan, plan: AggPlan, mode: str,
                 pre_mask: Optional[Expression] = None):
        super().__init__([child])
        self.plan = plan
        self.mode = mode
        self.pre_mask = pre_mask

    def output_schema(self) -> Schema:
        return (self.plan.partial_schema if self.mode == "partial"
                else self.plan.output_schema)

    def describe(self) -> str:
        keys = ", ".join(n for n, _ in self.plan.grouping)
        fused = (f", fused_filter={self.pre_mask!r}"
                 if self.pre_mask is not None else "")
        return f"TpuHashAggregateExec(mode={self.mode}, keys=[{keys}]{fused})"

    def fingerprint_extra(self) -> str:
        extra = ("" if self.pre_mask is None
                 else f"|mask:{self.pre_mask!r}")
        return ";".join(repr(e) for _, e in self.plan.grouping
                        + self.plan.results) + extra

    # -- per-batch steps -----------------------------------------------------
    def _update(self, batch: DeviceBatch, hash_table, dense=None):
        p = self.plan
        return agg_ops.aggregate_update(
            batch, [e for _, e in p.grouping], p.update_inputs,
            p.update_reductions, p.partial_schema, mask_expr=self.pre_mask,
            dense=dense, hash_table=hash_table)

    def _merge(self, batch: DeviceBatch, hash_table, dense=None):
        p = self.plan
        return agg_ops.aggregate_merge(
            batch, p.num_keys, p.merge_reductions, p.partial_schema,
            dense=dense, hash_table=hash_table)

    def _passthrough(self, batch: DeviceBatch) -> DeviceBatch:
        p = self.plan
        return agg_ops.aggregate_passthrough(
            batch, [e for _, e in p.grouping], p.update_inputs,
            p.update_reductions, p.partial_schema, mask_expr=self.pre_mask)

    def _finalize(self, batch: DeviceBatch) -> DeviceBatch:
        final = self.plan.finalize_exprs()
        return eval_projection(batch, [e for _, e in final],
                               [n for n, _ in final])

    def _dense_group_plan(self, ctx: ExecContext):
        """(los, sizes, spec key) for the bounded-int composite grouping
        key, or None: non-integer keys, unresolvable stats, past 62 bits,
        speculation off, ``agg.denseKeys`` off, a plan the session has not
        executed before (the first execution's scan stats may not cover
        this upload yet: they record as batches stream, after planning),
        or blocklisted after a verification miss. The device-computed ok
        flag joins the deferred speculation verification; a miss
        re-executes without dense and blocklists the
        ``nocache|densegroup|...`` key, so chronically stale stats do not
        re-run every execution."""
        if (ctx.session is None or not ctx.speculate
                or not ctx.conf.get_bool(C.AGG_DENSE_KEYS.key, True)):
            return None
        p = self.plan
        if p.num_keys == 0:
            return None
        from spark_rapids_tpu_torch.exec.statsutil import dense_group_plan
        key_names, key_dts = [], []
        if self.mode == "partial":
            cs = p.child_schema
            for name, e in p.grouping:
                if not isinstance(e, BoundRef):
                    return None
                names = {name}
                if 0 <= e.index < len(cs.names):
                    names.add(cs.names[e.index])
                key_names.append(names)
                key_dts.append(cs.dtypes[e.index])
        else:
            ps = p.partial_schema
            for j in range(p.num_keys):
                key_names.append({ps.names[j]})
                key_dts.append(ps.dtypes[j])
        fp = plan_fingerprint(self)
        seen = ctx.session.dense_plans_seen
        if fp not in seen:
            seen.add(fp)
            return None
        got = dense_group_plan(ctx.session, key_names, key_dts)
        if got is None:
            return None
        skey = f"nocache|densegroup|{fp}|{got[1]}"
        if skey in ctx.session.capacity_spec_blocklist:
            return None
        return got[0], got[1], skey

    def _update_fn(self, ctx: ExecContext, hash_table, update):
        """The per-batch update: ``update``, or under the hash aggregation
        with column-reference keys ``_bucketed_update``: a batch whose
        slot table would pass ``agg.hash.maxTableSlots`` splits by key
        hash into slices that fit (disjoint key sets), each aggregates on
        B2 (a fused filter's mask evaluated over each slice's rows), and
        their partials concatenate into one partial batch (no key spans
        two slices); a slice still too large splits again with the next
        level's hash, up to three levels. A batch the dictionary branch
        aggregates (every key dictionary-encoded, a small joint table)
        needs no hash table and does not split."""
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
    def _partial(self, ctx: ExecContext, part: Partition, update, merge,
                 skip_ratio: float) -> Iterator[DeviceBatch]:
        """The partial pass with the runtime partial-aggregation skip (the
        JAX package's agg.runtimeSkip, its default; ``false`` takes
        ``_first_batch_partial``): measure output groups / input rows as
        batches stream, one counted sync a sampled batch, and switch to
        passthrough mid-stream once the cumulative ratio exceeds the
        threshold. The decision seeds the session's ratio cache, keyed on
        the plan's fingerprint (its data identity included), so later
        executions decide from batch 0 without a sync; a partial that
        shrank its capacity proves a strong reduction without one and
        decides "update". Each cache write is noted in
        ``ctx.ratio_writes`` (a speculation miss drops them)."""
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

        def learn(measured: float) -> None:
            cache[sig] = measured
            ctx.ratio_writes.append(sig)
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
                        learn(measured)
                        _note_skip(decided, measured, sampled, skip_ratio)
                        yield from partials
                        partials = []
                    elif sampled >= self._SKIP_SAMPLE_BATCHES:
                        decided = "update"
                        learn(measured)
                        _note_skip(decided, measured, sampled, skip_ratio)
            b = next(it, None)
        if decided is None and sampled > 0:
            # the stream ended while still sampling: the cumulative
            # measurement is the plan's decision
            learn(out_rows / max(in_rows, 1))
            _note_skip("update", cache[sig], sampled, skip_ratio)
        if len(partials) == 1:
            yield partials[0]
        elif partials:
            yield merge(concat_device(
                partials, self.plan.partial_schema, ctx.conf.capacity_growth,
                ctx.device, dm=device_manager_of(ctx)))

    def _first_batch_partial(self, ctx: ExecContext, part: Partition,
                             update, merge, skip_ratio: float
                             ) -> Iterator[DeviceBatch]:
        """The partial pass under ``spark.rapids.sql.agg.runtimeSkip=
        false``: the JAX package's first-batch heuristic. A plan whose
        ratio the session's cache holds skips or updates from batch 0;
        otherwise the first batch's pass learns the ratio (one counted
        ``batch.rowCount`` sync, only where the partial kept its input's
        capacity), and past the threshold every later batch passes
        through. No ``aggSkipDecision`` events."""
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
        if adaptive and cache.get(sig) is not None \
                and cache[sig] > skip_ratio:
            yield self._passthrough(first)
            for b in it:
                yield self._passthrough(b)
            return
        p0 = update(first)
        second = next(it, None)
        ratio = None
        if adaptive and sig not in cache and p0.capacity >= first.capacity:
            ratio = p0.num_rows_host() / max(first.num_rows_hint(), 1)
            cache[sig] = ratio
            ctx.ratio_writes.append(sig)
        if second is None:
            yield p0
            return
        if ratio is not None and ratio > skip_ratio:
            yield p0
            while second is not None:
                yield self._passthrough(second)
                second = next(it, None)
            return
        partials = [p0, update(second)]
        partials.extend(update(b) for b in it)
        yield merge(concat_device(
            partials, self.plan.partial_schema, ctx.conf.capacity_growth,
            ctx.device, dm=device_manager_of(ctx)))

    def partitions(self, ctx: ExecContext) -> List[Partition]:
        from spark_rapids_tpu_torch.exec import outofcore as ooc
        conf = ctx.conf
        skip_ratio = float(conf.get(C.AGG_SKIP_RATIO.key))
        runtime_skip = conf.get_bool(C.AGG_RUNTIME_SKIP.key, True)
        dense = self._dense_group_plan(ctx)
        # dense keys outrank the hash table (an exact composite key, one
        # sort operand); the hash table engages where dense cannot
        use_hash = (conf.get_bool(C.AGG_HASH_ENABLED.key, False)
                    and self.plan.num_keys > 0 and dense is None)
        hash_table = (int(conf.get(C.AGG_HASH_MAX_SLOTS.key)) if use_hash
                      else None)
        if dense is not None:
            import numpy as np

            from spark_rapids_tpu_torch.columnar.column import host_to_device
            from spark_rapids_tpu_torch.exec.base import HostCopy
            dspec = (host_to_device(np.asarray(dense[0], dtype=np.int64),
                                    ctx.device), dense[1])
            skey = dense[2]

            def register(ok: torch.Tensor) -> None:
                ctx.spec_pending.append((skey, None, 0, [],
                                         [HostCopy(ok)], None))

            def update_dense(b):
                out, ok = self._update(b, None, dspec)
                register(ok)
                return out

            def merge(b):
                out, ok = self._merge(b, None, dspec)
                register(ok)
                return out
            update = update_dense
        else:
            def update(b):
                return self._update(b, hash_table)

            def merge(b):
                return self._merge(b, hash_table)
        update = self._update_fn(ctx, hash_table, update)
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
                    partial = (self._partial if runtime_skip
                               else self._first_batch_partial)
                    yield from partial(ctx, src, update, merge, skip_ratio)
                    return
                merged = concat_device(list(src()), self.plan.partial_schema,
                                       growth, ctx.device,
                                       dm=device_manager_of(ctx))
                yield self._finalize(merge(merged))
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
            cache_uploads, chain_partitions, dict_enabled, pack_splits,
            replay_cached, scan_cache_for, upload_blocked_chars,
            upload_frames, upload_partition,
        )
        max_rows = ctx.conf.batch_size_rows
        cache = scan_cache_for(ctx, self.source, self._schema, max_rows,
                               self.pushed_filters)
        dict_state: dict = {}
        max_stride = upload_blocked_chars(ctx.conf)
        dict_encode = dict_enabled(ctx.conf)
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
                                 self._schema, dict_encode)

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

    @staticmethod
    def _padded_producer(node: PhysicalPlan) -> bool:
        """Does the subtree below (up to the next exchange) hold an
        operator whose batches systematically carry far more capacity than
        rows? Aggregates always do; limits and semi/anti joins compact
        hard within an unchanged capacity. Plain filters are deliberately
        not counted (the JAX package's rule: at moderate selectivity the
        shrink's sync and gathers cost more than they save)."""
        from spark_rapids_tpu_torch.exec.tpujoin import (
            TpuShuffledHashJoinExec,
        )
        if isinstance(node, (TpuHashAggregateExec, TpuLocalLimitExec)):
            return True
        if (isinstance(node, TpuShuffledHashJoinExec)
                and node.join_type in ("leftsemi", "leftanti")):
            return True
        if isinstance(node, TpuShuffleExchangeExec):
            return False  # already shrunk at that boundary
        return any(TpuShuffleExchangeExec._padded_producer(c)
                   for c in node.children)

    def describe(self) -> str:
        return f"TpuShuffleExchangeExec({self.partitioning[0]})"

    def materialize_stage(self, ctx: ExecContext):
        """AQE query-stage materialization (``sql/adaptive/``): run the map
        side on the device, bring every batch to the host in ONE counted
        ``aqe.stageFetch`` sync, split each map partition with the
        canonical host hash and report per-(map, partition) sizes. AQE is
        a statistics barrier by design: the map output must become host
        addressable for the runtime to measure and re-partition it (the
        role of the reference's shuffle catalog registration,
        RapidsCachingWriter -> MapStatus.partition_sizes)."""
        import time

        from spark_rapids_tpu_torch.exec.cpu import concat_host_frames
        from spark_rapids_tpu_torch.obs import compileledger
        from spark_rapids_tpu_torch.sql.adaptive import stats as aqestats
        assert self.partitioning[0] == "hash", self.partitioning
        key_idx = list(self.partitioning[1])
        n = self.partitioning[-1]
        schema = self.output_schema()
        per_map = [list(part())
                   for part in self.children[0].executed_partitions(ctx)]
        flat = [b for bs in per_map for b in bs]
        with compileledger.op_context(self.describe(), id(self), ctx):
            t0 = time.perf_counter()
            with sync_scope("aqe.stageFetch",
                            detail=f"batches={len(flat)}") as sc:
                frames = [b.to_pandas() for b in flat]
                sc.add_bytes(sum(b.device_memory_size() for b in flat))
            compileledger.note_transfer(time.perf_counter() - t0, "d2h")
        map_outputs = []
        pos = 0
        for bs in per_map:
            dfs = frames[pos:pos + len(bs)]
            pos += len(bs)
            map_outputs.append(aqestats.split_frame(
                concat_host_frames(dfs, schema), key_idx, n))
        return map_outputs, aqestats.stats_from_map_outputs(map_outputs)

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

    def route(self, conf, session) -> str:
        """The route this exchange takes (class docstring): "collapse",
        "buckets" or "manager", by ``shuffle/manager.select_transport_kind``
        and ``spark.rapids.sql.shuffle.localCollapse``. A single exchange
        always collapses, and round-robin never does: it is the
        user-visible ``repartition(n)`` shape (the partition and file count
        of a write). ``session`` None plans outside a session, where the
        shuffle manager is never taken. ``partitions`` dispatches on it,
        the whole-stage cutter reads it through ``claims_filter``, and the
        capacity speculation's keys carry it (``exchange_routes``)."""
        from spark_rapids_tpu_torch.shuffle.manager import (
            ShuffleTransportKind, select_transport_kind,
        )
        kind = self.partitioning[0]
        if kind == "single":
            return "collapse"
        if select_transport_kind(conf, session, kind, self.partitioning[-1]
                                 ) is ShuffleTransportKind.MANAGER:
            return "manager"
        if (kind in ("hash", "range")
                and conf.get_bool(C.SHUFFLE_LOCAL_COLLAPSE.key, True)):
            return "collapse"
        return "buckets"

    def shrinks(self, conf, session) -> bool:
        """Does this exchange take the capacity shrink? On the collapse
        route, over a padded producer (``_padded_producer``), out of core
        off (``exec/outofcore.enabled_for``: out of core streams the
        pieces)."""
        return (self.route(conf, session) == "collapse"
                and not _out_of_core(conf, session)
                and self._padded_producer(self.children[0]))

    def claims_filter(self, conf, session) -> bool:
        """Does this exchange fold a deterministic filter directly below it
        (``claimed_filter``) into its concat? Under
        ``spark.rapids.sql.exchange.fuseFilter``, on the collapse route,
        out of core off, where it does not shrink (a padded producer's
        batches take the shrink instead)."""
        return (conf.get_bool(C.EXCHANGE_FUSE_FILTER.key, True)
                and self.route(conf, session) == "collapse"
                and not _out_of_core(conf, session)
                and not self._padded_producer(self.children[0])
                and bool(claimed_filter(self.children[0])))

    def partitions(self, ctx: ExecContext) -> List[Partition]:
        child_parts = self.children[0].executed_partitions(ctx)
        schema = self.output_schema()
        route = self.route(ctx.conf, ctx.session)
        if route == "collapse":
            return self._collapse_partitions(ctx, child_parts, schema)
        if route == "manager":
            return self._manager_partitions(ctx, child_parts, schema)
        return self._bucket_partitions(ctx, child_parts, schema)

    def _collapse_partitions(self, ctx: ExecContext, child_parts,
                             schema: Schema) -> List[Partition]:
        """The LOCAL collapse's one partition, by producer:

          * a padded producer (``_padded_producer``: an aggregate, a
            limit, a semi or anti join below) takes the capacity shrink:
            ONE counted ``exchange.shrink`` fetch of every batch's live
            rows and plain-string char totals, each batch sliced to its
            bucket (``rowops.slice_batch_to``), then one concat, so every
            downstream operator runs at the real scale instead of the
            padded one. Under capacity speculation a deterministic
            subtree's counts come from the session cache once they have
            proven stable over two runs, as exact host metadata checked
            for EXACT equality at the query's end
            (``session._verify_speculation``);
          * a deterministic filter directly below folds into one masked
            concat (``_fused_filter_source``);
          * otherwise (and under out-of-core) the child's batches pass on
            as they are, with no copy and no sync: the consumer
            concatenates what it needs, and a join's stream side probes
            each batch on its own. The JAX package concatenates here; the
            port keeps its pieces, which out-of-core streams too."""
        growth = ctx.conf.capacity_growth
        dm = device_manager_of(ctx)
        if self.shrinks(ctx.conf, ctx.session):
            def shrunk() -> Iterator[DeviceBatch]:
                batches = [b for p in child_parts for b in p()]
                if not batches:
                    yield empty_batch(schema, ctx.device)
                    return
                yield concat_device(self._shrink(ctx, batches), schema,
                                    growth, ctx.device, dm=dm)
            return [shrunk]
        if self.claims_filter(ctx.conf, ctx.session):
            src_node, mask_fn, out_sel = _fused_filter_source(
                self.children[0])
            src_parts = src_node.executed_partitions(ctx)

            def fused() -> Iterator[DeviceBatch]:
                batches = [b for p in src_parts for b in p()]
                yield fused_concat(batches, [mask_fn(b) for b in batches],
                                   out_sel, schema, growth, ctx.device, dm)
            return [fused]

        def collapsed() -> Iterator[DeviceBatch]:
            got = False
            for p in child_parts:
                for b in p():
                    got = True
                    yield b
            if not got:
                yield empty_batch(schema, ctx.device)
        return [collapsed]

    def _shrink(self, ctx: ExecContext, batches: List[DeviceBatch]
                ) -> List[DeviceBatch]:
        """Each batch sliced to the bucket of its live rows (and a plain
        string column to the bucket of its live chars): the counts come
        from one counted ``exchange.shrink`` fetch, or under speculation
        from the session cache (deferred exact check)."""
        from spark_rapids_tpu_torch.columnar.column import char_bucket
        from spark_rapids_tpu_torch.exec.base import HostCopy
        from spark_rapids_tpu_torch.exec.reuse import subtree_deterministic
        growth = ctx.conf.capacity_growth
        cache = entry = skey = None
        if ctx.speculate and subtree_deterministic(self):
            skey = (f"{plan_fingerprint(self)}|{exchange_routes(self, ctx)}"
                    "|shrink")
            cache = ctx.session.capacity_cache
            entry = cache.get(skey)
        # under speculation the entry keys on the whole batch set, which
        # is the same every execution (which batches know their rows on
        # the host is not)
        need = (list(batches) if cache is not None
                else [b for b in batches if b.host_rows is None])
        if need:
            # per batch: its row count and each plain string column's
            # live char total (slab and dictionary columns move rows)
            per_batch = []
            for b in need:
                vals = [b.num_rows.to(torch.int64).reshape(1)]
                for col in b.columns:
                    if col.dtype.is_string and col.is_plain:
                        vals.append(col.offsets[-1].to(torch.int64)
                                    .reshape(1))
                per_batch.append(vals)
            layout = tuple(len(v) for v in per_batch)
            flat = torch.cat([v for vals in per_batch for v in vals])
            if (entry is not None and entry.get("layout") == layout
                    and entry.get("stable")):
                ctx.session.capacity_spec_hits += 1
                ctx.spec_pending.append((skey, HostCopy(flat), 0, [], [],
                                         entry["counts"]))
                stats = entry["counts"]
            else:
                with sync_scope("exchange.shrink", nbytes=flat.numel() * 8,
                                detail=f"counts={flat.numel()}"):
                    stats = [int(c) for c in flat.tolist()]
                if cache is not None:
                    if (entry is not None and entry.get("layout") == layout
                            and entry["counts"] == stats):
                        entry["stable"] = True
                    else:
                        cache[skey] = {"layout": layout, "counts": stats}
            pos = 0
            for b, n_vals in zip(need, layout):
                b.host_rows = int(stats[pos])
                b._host_chars = [int(c) for c in stats[pos + 1:pos + n_vals]]
                pos += n_vals
        out = []
        for b in batches:
            target = bucket_capacity(max(b.host_rows, 1), growth)
            chars = list(getattr(b, "_host_chars", None) or [])
            ccaps = []
            char_shrink = False
            for col in b.columns:
                if col.dtype.is_string and col.is_plain and chars:
                    cc = char_bucket(max(chars.pop(0), 1))
                    char_shrink |= cc < int(col.chars.shape[0])
                    ccaps.append(cc)
                else:
                    ccaps.append(None)
            if target < b.capacity or char_shrink:
                sb = rowops.slice_batch_to(b, 0, b.host_rows, target, ccaps)
                sb.host_rows = b.host_rows
                out.append(sb)
            else:
                out.append(b)
        return out

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

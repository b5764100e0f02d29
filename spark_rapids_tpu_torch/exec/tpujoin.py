"""Equi-joins over device batches on the hash table (counterpart of the
JAX package's ``exec/tpujoin.py``): the plain function ``hash_join`` over
lists of batches (the query runners' entry), and the session's operators
``TpuShuffledHashJoinExec``, ``TpuBroadcastExchangeExec`` and
``TpuBroadcastHashJoinExec`` over the same two steps, ``build_side`` (the
build side's concat and kernel B3, once) and ``probe_expand`` (kernel B4
and the expand, per stream batch).

The join keeps the JAX exec's behaviour:

  * the side rule: stream = left, build = right, except for a right outer
    join, which streams the right side against a left build so that every
    preserved row is a stream row;
  * the build side is concatenated once, at the summed capacity of its
    batches;
  * every stream batch is probed first, then all expansion totals come back
    in ONE device->host copy per join, inside ``sync_scope``;
  * the expand runs per stream batch, plus the full-outer tail.

The probe takes the routes of the JAX exec on a TPU:

  * the dense direct-index probe (``ops/joins.dense_build`` and
    ``dense_lookup``) where the session's scan statistics
    (``column_stats``, through the rename aliases ``column_aliases``)
    bound a single integer build key to at most 2^24 values
    (``dense_plan``). The bounds are advisory and the build verifies
    them on the device: an expanding join reads the flag in the same copy
    as its expansion totals, a semi or anti join once for all its stream
    batches, one counted sync. Where a build key falls outside, the join
    takes the hash route and fetches again;
  * the hash table, the JAX exec's ``_hash_probe_kernel`` route: the
    build side's key images go through B3 once per join
    (``kernels.hash_join_build``) and each stream batch through B4
    (``kernels.hash_join_lookup``);
  * the union-lexsort probe (``ops/joins.join_probe``) for a join with a
    string key, which the hash route never takes.

Semi and anti joins off the dense route need only the match counts, so
they never wait for the host. A full outer join always emits its tail
batch, empty or not, where the JAX exec fetched the tail's row count to
decide. A broadcast join builds its table once per execution and probes
it from every stream partition: one counted sync a stream partition.

A cross join (join type ``"cross"``, no keys) takes the JAX package's
cross route of the probe (``ops/joins.cross_probe``: every live stream row
against every live build row, no table) and the same expand, one counted
sync a stream partition: ``TpuCartesianProductExec`` runs it over two
single partitions, and ``TpuBroadcastNestedLoopJoinExec`` runs it for each
stream partition against the broadcast build, then keeps the rows its
condition holds for (one compaction, kernel B1).

Under the memory runtime (``memory/``), as in the JAX package: the
broadcast table lives in the session's spill catalog at the
``OUTPUT_FOR_WRITE`` band (acquired per use, faulted back where it was
spilled, freed at the query's end); each expanded output is metered
against the session's device budget; and under
``spark.rapids.tpu.outOfCore.enabled`` the shuffled join probes both
sides' streams against ``outOfCore.partitionBytes`` (the build side first,
the stream side against what the build left) and past it runs the grace
join (``exec/outofcore.grace_join``), bucket by bucket through
``build_side`` and ``probe_expand``.

Capacity speculation (``spark.rapids.sql.adaptiveCapacity.enabled``, on
by default, the JAX package's): a warm run of a deterministic join
partition expands straight into the sizes the session cached from its
earlier run (``Speculation``; keyed by the join's data-stamped plan
fingerprint, the growth and the partition) and defers its totals, and
the dense route's flag, to the one ``speculation.verify`` fetch at the
query's end; a miss re-executes the query without speculation. A
broadcast materialization folds a deterministic filter directly below it
into its concat (``exec/tpu._fused_filter_source``).
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence

import torch

from spark_rapids_tpu_torch.columnar.batch import (
    MIN_CAPACITY, DeviceBatch, Schema, bucket_capacity,
)
from spark_rapids_tpu_torch.columnar.column import char_bucket
from spark_rapids_tpu_torch.exec.base import (
    ExecContext, Partition, PhysicalPlan,
)
from spark_rapids_tpu_torch.obs.metrics import bump
from spark_rapids_tpu_torch.obs.syncledger import sync_scope
from spark_rapids_tpu_torch.ops import joins as join_ops
from spark_rapids_tpu_torch.ops import kernels, rowops
from spark_rapids_tpu_torch.ops.sortops import u64_key_image

SUPPORTED_JOIN_TYPES = ("inner", "left", "right", "full", "leftsemi",
                        "leftanti", "cross")
OUTER = ("left", "right", "full")


def output_schema(left: Schema, right: Schema, join_type: str) -> Schema:
    if join_type in ("leftsemi", "leftanti"):
        return left
    return Schema(list(left.names) + list(right.names),
                  list(left.dtypes) + list(right.dtypes))


def _key_images(batch: DeviceBatch, keys: Sequence[int]
                ) -> List[torch.Tensor]:
    """The fixed-width keys' images of the hash route."""
    imgs: List[torch.Tensor] = []
    for ki in keys:
        if batch.schema.dtypes[ki].is_string:
            raise ValueError("hash route: string keys take the "
                             "union-lexsort probe")
        imgs.extend(u64_key_image(batch.columns[ki]))
    return imgs


def _concat_build(batches: Sequence[DeviceBatch]) -> DeviceBatch:
    if len(batches) == 1:
        return batches[0]
    return rowops.concat_batches(
        batches, bucket_capacity(sum(b.capacity for b in batches)))


# the widest key range the dense probe tables (the JAX exec's)
DENSE_MAX_RANGE = 1 << 24

# stream batches probed, and build sides built, by route
ROUTES = {"dense": 0, "hash": 0, "union": 0, "cross": 0}
BUILDS = {"dense": 0, "hash": 0, "union": 0, "cross": 0}


def reset_routes() -> None:
    for k in ROUTES:
        ROUTES[k] = 0
        BUILDS[k] = 0


class BuiltSide:
    """A join's build side: its batch (the build batches concatenated),
    its keys and its route: "hash" (``table``, the B3 table), "dense"
    (``dense``, verified at the first probe; a failed verification builds
    the hash table), "union" (a string key: built per stream batch) or
    "cross"."""

    def __init__(self, batch: DeviceBatch, keys: Sequence[int], route: str,
                 table: Optional[kernels.JoinTable] = None,
                 dense: Optional[join_ops.DenseTable] = None):
        self.batch = batch
        self.keys = list(keys)
        self.route = route
        self.table = table
        self.dense = dense
        # the dense verification's answer, once read
        self.dense_ok: Optional[bool] = None

    def hash_table(self) -> kernels.JoinTable:
        if self.table is None:
            bump(BUILDS, "hash")
            self.table = kernels.hash_join_build(
                _key_images(self.batch, self.keys),
                join_ops._key_valid(self.batch, self.keys),
                kernels.hash_table_size(self.batch.capacity))
        return self.table


def build_side(batches: Sequence[DeviceBatch], keys: Sequence[int],
               dense: Optional[tuple] = None) -> BuiltSide:
    """Concatenate the build batches once and build their side: the dense
    table where ``dense`` (lo, table size) is given, none for a string
    key (the union probe sorts per stream batch) or a cross join, else
    the B3 table."""
    build = _concat_build(batches)
    route = ("cross" if not keys else
             "union" if any(build.schema.dtypes[k].is_string for k in keys)
             else "dense" if dense is not None else "hash")
    if route != "hash":
        bump(BUILDS, route)
    if route in ("cross", "union"):
        return BuiltSide(build, keys, route)
    if route == "dense":
        return BuiltSide(build, keys, "dense", dense=join_ops.dense_build(
            build, keys[0], dense[0], dense[1]))
    side = BuiltSide(build, keys, "hash")
    side.hash_table()
    return side


def _probe(built: BuiltSide, stream: DeviceBatch,
           stream_keys: Sequence[int], route: str):
    """(counts, bstart, bperm) of one stream batch on ``route``."""
    build = built.batch
    bump(ROUTES, route)
    if route == "cross":
        return join_ops.cross_probe(build, stream)
    if route == "union":
        return join_ops.join_probe(build, stream, built.keys, stream_keys)
    if route == "dense":
        counts, bstart = join_ops.dense_lookup(built.dense, stream,
                                               stream_keys[0])
        return counts, bstart, built.dense.bperm
    jt = built.hash_table()
    counts, bstart = kernels.hash_join_lookup(
        jt, _key_images(stream, stream_keys),
        join_ops._key_valid(stream, stream_keys))
    return counts, bstart, jt.bperm


def _empty(schema: Schema, device) -> DeviceBatch:
    return DeviceBatch(schema, join_ops.null_columns(schema, MIN_CAPACITY,
                                                     device),
                       torch.zeros((), dtype=torch.int32, device=device))


class Speculation:
    """A join partition's capacity speculation (``spark.rapids.sql.
    adaptiveCapacity.enabled``): its execution context and its key in the
    session's ``capacity_cache`` (the join's data-stamped plan
    fingerprint, the growth and the partition)."""

    __slots__ = ("ctx", "key")

    def __init__(self, ctx: ExecContext, key: str):
        self.ctx = ctx
        self.key = key

    @property
    def cache(self) -> dict:
        return self.ctx.session.capacity_cache

    def defer(self, totals, width: int, caps: list, oks) -> None:
        """Hand device totals and ok flags to the query-end check, their
        host copies started now (``exec/base.HostCopy``)."""
        from spark_rapids_tpu_torch.exec.base import HostCopy
        self.ctx.session.capacity_spec_hits += 1
        self.ctx.spec_pending.append(
            (self.key, HostCopy(totals) if totals is not None else None,
             width, caps, [HostCopy(o) for o in oks], None))


def probe_expand(built: BuiltSide, streams: Sequence[DeviceBatch],
                 join_type: str, stream_keys: Sequence[int],
                 stream_is_left: bool, out_schema: Schema, dm=None,
                 spec: Optional[Speculation] = None
                 ) -> Iterator[DeviceBatch]:
    """Probe every stream batch against the built side, then expand: all
    expansion totals come back in one counted copy (with the dense
    route's verification flag), none for semi and anti joins off the
    dense route. Each stream batch's expansion is made only when the
    consumer asks for it, so one expanded batch at a time is alive (a
    12x cross join of 12M rows would hold 144M at once), metered on
    ``dm`` (the session's device manager) where given. At least one
    batch comes back (an empty one where the join yields no rows).

    Under ``spec`` (capacity speculation), a partition whose sizes the
    session cached from an earlier run with the same number of stream
    batches expands straight into the cached buckets, with no
    ``join.expandTotals`` (nor ``join.denseVerify``) sync: the device
    totals and the dense flag join the query-end ``speculation.verify``
    fetch, which re-executes the query where a capacity fell short. The
    verified part is the consumed prefix (a CollectLimit may stop the
    expansion early); a cached empty batch is skipped and must be empty.
    Speculated totals are not exact, so a batch of a speculated
    expansion carries its cached total as ``rows_hint``, not
    ``host_rows``."""
    build = built.batch
    if not streams:
        yield _empty(out_schema, build.device)
        return
    route = built.route
    if route == "dense" and built.dense_ok is False:
        route = "hash"
    # probe every stream batch before any host wait
    probes = [_probe(built, s, stream_keys, route) for s in streams]
    semi = join_type in ("leftsemi", "leftanti")
    verify = route == "dense" and built.dense_ok is None
    entry = spec.cache.get(spec.key) if spec is not None else None
    if semi:
        if verify:
            if (entry is not None and entry.get("dense_ok")
                    and entry.get("n") == len(streams)):
                # last run's advisory bounds held: defer the flag
                spec.defer(None, 0, [], [built.dense.ok])
            else:
                with sync_scope("join.denseVerify", nbytes=1):
                    built.dense_ok = bool(built.dense.ok.item())
                if spec is not None:
                    spec.cache[spec.key] = {"dense_ok": built.dense_ok,
                                            "n": len(streams)}
                if not built.dense_ok:
                    yield from probe_expand(built, streams, join_type,
                                            stream_keys, stream_is_left,
                                            out_schema, dm)
                    return
        elif (route == "dense" and spec is not None and entry is None
              and built.dense_ok):
            # a broadcast build verified by an earlier stream partition:
            # this partition's entry, so its next run defers the flag too
            spec.cache[spec.key] = {"dense_ok": True, "n": len(streams)}
        for s, (counts, _b, _p) in zip(streams, probes):
            yield join_ops.semi_anti_filter(s, counts,
                                            anti=join_type == "leftanti")
        return
    adjs = [join_ops.outer_adjusted_counts(s, counts)
            if join_type in OUTER else counts
            for s, (counts, _b, _p) in zip(streams, probes)]
    totals = torch.stack([
        join_ops.expand_totals(build, s, adj, counts, bstart, bperm)
        for s, adj, (counts, bstart, bperm) in zip(streams, adjs, probes)
    ]).reshape(-1)
    width = totals.numel() // len(streams)
    caps_used: Optional[list] = None
    if (entry is not None and entry.get("n") == len(streams)
            and entry.get("dense_ok", True)
            and entry.get("sizes") is not None):
        # speculate: expand into last run's buckets
        sizes = entry["sizes"]
        caps_used = []
        spec.defer(totals, width, caps_used,
                   [built.dense.ok] if verify else [])
    else:
        if verify:
            totals = torch.cat([totals, built.dense.ok.to(torch.int64)
                                .reshape(1)])
        with sync_scope("join.expandTotals", nbytes=totals.numel() * 8):
            flat = totals.cpu().tolist()
        if verify:
            built.dense_ok = bool(flat.pop())
            if not built.dense_ok:
                yield from probe_expand(built, streams, join_type,
                                        stream_keys, stream_is_left,
                                        out_schema, dm, spec)
                return
        sizes = [flat[i * width:(i + 1) * width]
                 for i in range(len(streams))]
        if spec is not None:
            spec.cache[spec.key] = {"n": len(streams), "sizes": sizes,
                                    "dense_ok": built.dense_ok is not False}
    any_out = False
    matched = (torch.zeros(build.capacity, dtype=torch.bool,
                           device=build.device)
               if join_type == "full" else None)
    for stream, (counts, bstart, bperm), adj, size in zip(streams, probes,
                                                          adjs, sizes):
        if join_type == "full":
            matched |= join_ops.build_match_flags(build, counts, bstart,
                                                  bperm)
        total = size[0]
        if total >= 1 << 31:
            raise ValueError(f"hash_join: {total} output rows of one stream "
                             "batch exceed int32")
        if not total and caps_used is not None:
            # speculated empty: the check requires the actual total be 0
            caps_used.append(None)
        if total:
            out_cap = bucket_capacity(total)
            if caps_used is not None:
                caps_used.append((out_cap, [char_bucket(c)
                                            for c in size[1:]]))
            batch = join_ops.join_expand(
                build, stream, counts, adj, bstart, bperm,
                out_cap, swap_sides=not stream_is_left,
                char_totals=size[1:])
            if caps_used is None:
                batch.host_rows = total
            else:
                # the cached total: coalescing above sees the same counts
                # as in the run that measured them
                batch.rows_hint = total
            if dm is not None:
                dm.meter_batch(batch)
            any_out = True
            yield batch
    if join_type == "full":
        any_out = True
        yield join_ops.unmatched_build_batch(
            build, matched, streams[0].schema, swap_sides=False)
    if not any_out:
        yield _empty(out_schema, build.device)


def _check_join(join_type: str, left_keys, right_keys) -> None:
    if join_type not in SUPPORTED_JOIN_TYPES:
        raise NotImplementedError(f"hash_join: join type {join_type!r} is "
                                  "not ported yet")
    if join_type == "cross":
        if left_keys or right_keys:
            raise ValueError("hash_join: a cross join takes no keys")
    elif len(left_keys) != len(right_keys) or not left_keys:
        raise ValueError("hash_join: needs matching, non-empty key lists")


def hash_join(left_batches: Sequence[DeviceBatch],
              right_batches: Sequence[DeviceBatch], join_type: str,
              left_keys: Sequence[int], right_keys: Sequence[int]
              ) -> List[DeviceBatch]:
    """Equi-join of two lists of batches on key column indices, ``join_type``
    one of SUPPORTED_JOIN_TYPES. Output columns: left then right (left only
    for semi and anti joins). Returns at least one batch (an empty one where
    the join yields no rows), on the device of the inputs."""
    _check_join(join_type, left_keys, right_keys)
    if not left_batches or not right_batches:
        raise ValueError("hash_join: each side needs at least one batch "
                         "(an empty table is one batch with no rows)")
    stream_is_left = join_type != "right"
    streams, builds = ((left_batches, right_batches) if stream_is_left
                       else (right_batches, left_batches))
    skey, bkey = ((left_keys, right_keys) if stream_is_left
                  else (right_keys, left_keys))
    schema = output_schema(left_batches[0].schema, right_batches[0].schema,
                           join_type)
    return list(probe_expand(build_side(builds, bkey), streams, join_type,
                             skey, stream_is_left, schema))


# ---------------------------------------------------------------------------
# The session's operators
# ---------------------------------------------------------------------------

class TpuBroadcastExchangeExec(PhysicalPlan):
    """The child materialized once per execution as one device batch, the
    one partition every consumer reads (reference:
    GpuBroadcastExchangeExec)."""

    columnar_output = True

    def __init__(self, child: PhysicalPlan):
        super().__init__([child])

    def output_schema(self) -> Schema:
        return self.children[0].output_schema()

    def claims_filter(self, conf, session) -> bool:
        """Does this exchange fold a deterministic filter directly below it
        (``exec/tpu.claimed_filter``) into its one concat? Always, under
        ``spark.rapids.sql.exchange.fuseFilter``."""
        from spark_rapids_tpu_torch.exec.tpu import claimed_filter
        return (conf.get_bool("spark.rapids.sql.exchange.fuseFilter", True)
                and bool(claimed_filter(self.children[0])))

    def partitions(self, ctx: ExecContext) -> List[Partition]:
        from spark_rapids_tpu_torch.exec.tpu import (
            _fused_filter_source, concat_device, device_manager_of,
            fused_concat,
        )
        # a deterministic filter directly below folds into the concat's
        # one compaction (spark.rapids.sql.exchange.fuseFilter)
        src_node, mask_fn, out_sel = (
            _fused_filter_source(self.children[0])
            if self.claims_filter(ctx.conf, ctx.session)
            else (self.children[0], None, None))
        child_parts = src_node.executed_partitions(ctx)
        schema = self.output_schema()
        state: dict = {}

        def materialize() -> DeviceBatch:
            batches = [b for p in child_parts for b in p()]
            if mask_fn is not None:
                out = fused_concat(batches, [mask_fn(b) for b in batches],
                                   out_sel, schema, ctx.conf.capacity_growth,
                                   ctx.device, device_manager_of(ctx))
            else:
                out = concat_device(batches, schema,
                                    ctx.conf.capacity_growth, ctx.device,
                                    dm=device_manager_of(ctx))
            if ctx.metrics_enabled:
                # the build table's device size on record, beside the
                # threshold that chose the broadcast (host metadata)
                from spark_rapids_tpu_torch.obs.events import EVENTS
                from spark_rapids_tpu_torch.obs.metrics import REGISTRY
                nbytes = out.device_memory_size()
                REGISTRY.gauge("shuffle.broadcast.bytes").set(nbytes)
                REGISTRY.counter("shuffle.broadcast.builds").add(1)
                EVENTS.emit("broadcastMaterialized", bytes=int(nbytes),
                            batches=len(batches))
            return out

        if ctx.session is None:
            def run() -> Iterator[DeviceBatch]:
                if "batch" not in state:
                    state["batch"] = materialize()
                yield state["batch"]
            return [run]

        # the broadcast table lives in the spill catalog (the reference
        # keeps broadcasts as spillable device buffers,
        # GpuBroadcastExchangeExec.scala:230-436): consumers acquire per
        # use, faulting a spilled table back; the OUTPUT_FOR_WRITE band, so
        # out-of-core buckets (OUTPUT_FOR_READ) spill first
        def run_catalog() -> Iterator[DeviceBatch]:
            from spark_rapids_tpu_torch.memory.spill import SpillPriorities
            session = ctx.session
            bid = state.get("bid")
            if bid is None or not session.buffer_catalog.contains(bid):
                bid = state["bid"] = session.add_transient_batch(
                    materialize(), SpillPriorities.OUTPUT_FOR_WRITE)
            yield session.buffer_catalog.acquire_batch(bid)
        return [run_catalog]


class TpuShuffledHashJoinExec(PhysicalPlan):
    """reference: GpuShuffledHashJoinExec: co-partitioned sides, each
    partition's build side concatenated and built (B3), its stream
    batches probed (B4) and expanded. A right outer join streams the right
    side against a left build, so every preserved row is a stream row."""

    columnar_output = True

    def __init__(self, left: PhysicalPlan, right: PhysicalPlan,
                 join_type: str, left_keys: Sequence[int],
                 right_keys: Sequence[int]):
        super().__init__([left, right])
        _check_join(join_type, left_keys, right_keys)
        self.join_type = join_type
        self.left_keys = list(left_keys)
        self.right_keys = list(right_keys)
        self._stream_is_left = join_type != "right"

    def output_schema(self) -> Schema:
        return output_schema(self.children[0].output_schema(),
                             self.children[1].output_schema(),
                             self.join_type)

    def describe(self) -> str:
        return f"{self.name}({self.join_type})"

    def fingerprint_extra(self) -> str:
        return f"{self.join_type}|{self.left_keys}|{self.right_keys}"

    def _sides(self):
        """(stream child index, stream keys, build keys)."""
        if self._stream_is_left:
            return 0, self.left_keys, self.right_keys
        return 1, self.right_keys, self.left_keys

    def dense_plan(self, session) -> Optional[tuple]:
        """(lo, table size) where the dense probe applies (the JAX exec's
        ``_dense_plan``): one integer build key whose name resolves,
        through the session's rename aliases, to scan statistics bounding
        it to at most ``DENSE_MAX_RANGE`` values; else None. Read at the
        build, after the build side's scans ran."""
        si, _skey, bkey = self._sides()
        if self.join_type == "cross" or len(bkey) != 1 or session is None:
            return None
        schema = self.children[1 - si].output_schema()
        dt = schema.dtypes[bkey[0]]
        if not dt.is_integral:
            return None
        from spark_rapids_tpu_torch.exec.statsutil import (
            int_bounds_for_names,
        )
        bounds = int_bounds_for_names(session, {schema.names[bkey[0]]})
        if bounds is None:
            return None
        lo = bounds[0]
        rng = bounds[1] - lo + 1
        if rng <= 0 or rng > DENSE_MAX_RANGE:
            return None
        size = 1024
        while size < rng:
            size <<= 1
        return lo, size

    def _builder(self, ctx: ExecContext, build_part: Partition):
        """The partition's build step, run at its first use."""
        si, _skey, bkey = self._sides()
        schema = self.children[1 - si].output_schema()
        state: dict = {}

        def built() -> BuiltSide:
            if "side" not in state:
                batches = list(build_part())
                if not batches:
                    from spark_rapids_tpu_torch.exec.tpu import empty_batch
                    batches = [empty_batch(schema, ctx.device)]
                state["side"] = build_side(batches, bkey,
                                           self.dense_plan(ctx.session))
            return state["side"]
        return built

    def _paired_builds(self, ctx: ExecContext, n_stream: int,
                       build_parts: List[Partition]) -> list:
        if len(build_parts) != n_stream:
            raise AssertionError("join children must be co-partitioned")
        return [self._builder(ctx, bp) for bp in build_parts]

    # the grace join applies to co-partitioned sides (not to a broadcast
    # build, materialized once for every stream partition)
    _grace = True

    def partitions(self, ctx: ExecContext) -> List[Partition]:
        from spark_rapids_tpu_torch.exec import outofcore as ooc
        from spark_rapids_tpu_torch.exec.tpu import device_manager_of
        si, skey, _bkey = self._sides()
        stream_parts = self.children[si].executed_partitions(ctx)
        build_parts = self.children[1 - si].executed_partitions(ctx)
        schema = self.output_schema()
        dm = device_manager_of(ctx)
        if self._grace and ooc.join_applicable(ctx, self):
            if len(build_parts) != len(stream_parts):
                raise AssertionError("join children must be co-partitioned")
            return [self._grace_partition(ctx, sp, bp)
                    for sp, bp in zip(stream_parts, build_parts)]
        builders = self._paired_builds(ctx, len(stream_parts), build_parts)
        spec_fp = self._spec_fingerprint(ctx)

        def make(pidx: int, sp: Partition, built) -> Partition:
            def run() -> Iterator[DeviceBatch]:
                side = built()
                spec = (Speculation(ctx, f"{spec_fp}|g"
                                    f"{ctx.conf.capacity_growth}|part{pidx}")
                        if spec_fp else None)
                yield from probe_expand(side, list(sp()),
                                        self.join_type, skey,
                                        self._stream_is_left, schema, dm,
                                        spec)
            return run
        return [make(i, sp, b)
                for i, (sp, b) in enumerate(zip(stream_parts, builders))]

    def _spec_fingerprint(self, ctx: ExecContext) -> Optional[str]:
        """The join's data-stamped plan fingerprint and the routes of the
        exchanges below it (``exec/tpu.exchange_routes``) under capacity
        speculation, or None: speculation off, or a nondeterministic input
        (a rand() filter changes the sizes every run, so speculation would
        alternate learn and miss)."""
        if not ctx.speculate:
            return None
        from spark_rapids_tpu_torch.exec.base import plan_fingerprint
        from spark_rapids_tpu_torch.exec.reuse import subtree_deterministic
        from spark_rapids_tpu_torch.exec.tpu import exchange_routes
        if not subtree_deterministic(self):
            return None
        return f"{plan_fingerprint(self)}|{exchange_routes(self, ctx)}"

    def _grace_partition(self, ctx: ExecContext, sp: Partition,
                         bp: Partition) -> Partition:
        """One partition under out-of-core: the streaming probe on both
        sides (never materializing past the budget). The build side is
        consumed up to the budget; if it fits, the stream side up to what
        it left; on engagement the unconsumed tails flow straight into the
        grace join's staging pass, else the in-memory join runs."""
        import itertools

        from spark_rapids_tpu_torch.exec import outofcore as ooc
        from spark_rapids_tpu_torch.exec.tpu import (
            device_manager_of, empty_batch,
        )
        si, skey, bkey = self._sides()
        growth = ctx.conf.capacity_growth

        def run() -> Iterator[DeviceBatch]:
            budget = ooc.working_set_budget(ctx)
            bpre, brest, bover = ooc.split_stream_on_budget(
                ctx, iter(bp()), budget)
            if bover:
                yield from ooc.grace_join(
                    ctx, self, itertools.chain(bpre, brest), sp(), growth)
                return
            bbytes = ooc.total_batch_bytes(bpre)
            spre, srest, sover = ooc.split_stream_on_budget(
                ctx, iter(sp()), max(budget - bbytes, 1))
            if sover:
                yield from ooc.grace_join(
                    ctx, self, bpre, itertools.chain(spre, srest), growth)
                return
            if not bpre:
                bpre = [empty_batch(self.children[1 - si].output_schema(),
                                    ctx.device)]
            side = build_side(bpre, bkey, self.dense_plan(ctx.session))
            yield from probe_expand(side, spre, self.join_type, skey,
                                    self._stream_is_left,
                                    self.output_schema(),
                                    device_manager_of(ctx))
        return run


class TpuBroadcastHashJoinExec(TpuShuffledHashJoinExec):
    """reference: GpuBroadcastHashJoinExec: the broadcast side's one batch
    built into a table once per execution (B3), probed by every stream
    partition (B4). Full outer joins are never planned so. An inner join
    whose LEFT side is the broadcast (AQE demotes the smaller measured
    side, ``sql/adaptive/rules.broadcast_sides``) streams its right side
    instead; the output columns stay left then right."""

    _grace = False

    def __init__(self, left: PhysicalPlan, right: PhysicalPlan,
                 join_type: str, left_keys: Sequence[int],
                 right_keys: Sequence[int]):
        super().__init__(left, right, join_type, left_keys, right_keys)
        if (join_type == "inner"
                and isinstance(left, TpuBroadcastExchangeExec)
                and not isinstance(right, TpuBroadcastExchangeExec)):
            self._stream_is_left = False

    def _paired_builds(self, ctx: ExecContext, n_stream: int,
                       build_parts: List[Partition]) -> list:
        if len(build_parts) != 1:
            raise AssertionError("a broadcast join's build side is one "
                                 "partition")
        return [self._builder(ctx, build_parts[0])] * n_stream


class TpuCartesianProductExec(TpuShuffledHashJoinExec):
    """reference: GpuCartesianProductExec: the unconditioned cross product
    of two single partitions (the planner puts a single-partition exchange
    under each side), every live left row against every live right row."""

    def __init__(self, left: PhysicalPlan, right: PhysicalPlan):
        super().__init__(left, right, "cross", [], [])

    def describe(self) -> str:
        return "TpuCartesianProductExec"


class TpuBroadcastNestedLoopJoinExec(PhysicalPlan):
    """reference: GpuBroadcastNestedLoopJoinExec (inner/cross, disabled by
    default): the cross product of each stream batch with the broadcast
    build batch, then one filter of the rows where the condition (bound to
    the combined left + right schema) holds, compacted by kernel B1."""

    columnar_output = True

    def __init__(self, left: PhysicalPlan, right: PhysicalPlan,
                 join_type: str, condition):
        super().__init__([left, right])
        self.join_type = join_type
        self.condition = condition

    def output_schema(self) -> Schema:
        return output_schema(self.children[0].output_schema(),
                             self.children[1].output_schema(), "cross")

    def describe(self) -> str:
        return f"{self.name}({self.join_type})"

    def fingerprint_extra(self) -> str:
        return f"{self.join_type}|{self.condition!r}"

    def partitions(self, ctx: ExecContext) -> List[Partition]:
        # the cross product over the children as they stand after the
        # transitions were inserted, then the condition as one filter
        from spark_rapids_tpu_torch.exec.tpu import TpuFilterExec
        cross = TpuBroadcastHashJoinExec(*self.children, "cross", [], [])
        if self.condition is None:
            return cross.partitions(ctx)
        return TpuFilterExec(cross, self.condition).partitions(ctx)

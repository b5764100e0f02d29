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

Capacity speculation (A.10) and out-of-core grace joins (A.8) wait for
later slices.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence

import torch

from spark_rapids_tpu_torch.columnar.batch import (
    MIN_CAPACITY, DeviceBatch, Schema, bucket_capacity,
)
from spark_rapids_tpu_torch.exec.base import (
    ExecContext, Partition, PhysicalPlan,
)
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
            BUILDS["hash"] += 1
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
        BUILDS[route] += 1
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
    ROUTES[route] += 1
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


def probe_expand(built: BuiltSide, streams: Sequence[DeviceBatch],
                      join_type: str, stream_keys: Sequence[int],
                      stream_is_left: bool, out_schema: Schema
                      ) -> Iterator[DeviceBatch]:
    """Probe every stream batch against the built side, then expand: all
    expansion totals come back in one counted copy (with the dense
    route's verification flag), none for semi and anti joins off the
    dense route. Each stream batch's expansion is made only when the
    consumer asks for it, so one expanded batch at a time is alive (a
    12x cross join of 12M rows would hold 144M at once). At least one
    batch comes back (an empty one where the join yields no rows)."""
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
    if semi:
        if verify:
            with sync_scope("join.denseVerify", nbytes=1):
                built.dense_ok = bool(built.dense.ok.item())
            if not built.dense_ok:
                yield from probe_expand(built, streams, join_type,
                                             stream_keys, stream_is_left,
                                             out_schema)
                return
        for s, (counts, _b, _p) in zip(streams, probes):
            yield join_ops.semi_anti_filter(s, counts,
                                            anti=join_type == "leftanti")
        return
    adjs = [join_ops.outer_adjusted_counts(s, counts)
            if join_type in OUTER else counts
            for s, (counts, _b, _p) in zip(streams, probes)]
    totals = torch.stack([join_ops.expand_totals(build, s, adj)
                          for s, adj in zip(streams, adjs)]).reshape(-1)
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
                                         out_schema)
            return
    width = len(flat) // len(streams)
    sizes = [flat[i * width:(i + 1) * width] for i in range(len(streams))]
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
        if total:
            batch = join_ops.join_expand(
                build, stream, counts, adj, bstart, bperm,
                bucket_capacity(total), swap_sides=not stream_is_left)
            batch.host_rows = total
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

    def partitions(self, ctx: ExecContext) -> List[Partition]:
        from spark_rapids_tpu_torch.exec.tpu import concat_device
        child_parts = self.children[0].executed_partitions(ctx)
        schema = self.output_schema()
        state: dict = {}

        def run() -> Iterator[DeviceBatch]:
            if "batch" not in state:
                state["batch"] = concat_device(
                    [b for p in child_parts for b in p()], schema,
                    ctx.conf.capacity_growth, ctx.device)
            yield state["batch"]
        return [run]


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
        names = {schema.names[bkey[0]]}
        frontier = set(names)
        for _ in range(8):  # alias chains are shallow; bound the walk
            nxt = set()
            for n in frontier:
                nxt |= session.column_aliases.get(n, set()) - names
            if not nxt:
                break
            names |= nxt
            frontier = nxt
        bounds = [session.column_stats[n] for n in names
                  if n in session.column_stats]
        if not bounds:
            return None
        lo = min(b[0] for b in bounds)
        rng = max(b[1] for b in bounds) - lo + 1
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

    def partitions(self, ctx: ExecContext) -> List[Partition]:
        si, skey, _bkey = self._sides()
        stream_parts = self.children[si].executed_partitions(ctx)
        builders = self._paired_builds(
            ctx, len(stream_parts),
            self.children[1 - si].executed_partitions(ctx))
        schema = self.output_schema()

        def make(sp: Partition, built) -> Partition:
            def run() -> Iterator[DeviceBatch]:
                side = built()
                yield from probe_expand(side, list(sp()),
                                             self.join_type, skey,
                                             self._stream_is_left, schema)
            return run
        return [make(sp, b) for sp, b in zip(stream_parts, builders)]


class TpuBroadcastHashJoinExec(TpuShuffledHashJoinExec):
    """reference: GpuBroadcastHashJoinExec: the broadcast side's one batch
    built into a table once per execution (B3), probed by every stream
    partition (B4). Full outer joins are never planned so."""

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

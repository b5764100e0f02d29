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

The probe is the hash table, the JAX exec's own ``_hash_probe_kernel``
route (its default is the union-lexsort probe: the same rows in another
order): the build side's key images go through B3 once per join
(``kernels.hash_join_build``) and each stream batch through B4
(``kernels.hash_join_lookup``). Semi and anti joins need only the match
counts, so they never wait for the host. A full outer join always emits
its tail batch, empty or not, where the JAX exec fetched the tail's row
count to decide. A broadcast join builds its table once per execution and
probes it from every stream partition: one counted sync a stream
partition, none for semi and anti joins.

A cross join (join type ``"cross"``, no keys) takes the JAX package's
cross route of the probe (``ops/joins.cross_probe``: every live stream row
against every live build row, no table) and the same expand, one counted
sync a stream partition: ``TpuCartesianProductExec`` runs it over two
single partitions, and ``TpuBroadcastNestedLoopJoinExec`` runs it for each
stream partition against the broadcast build, then keeps the rows its
condition holds for (one compaction, kernel B1).

The dense direct-index probe (A.4), capacity speculation (A.10),
out-of-core grace joins (A.8) and string join keys (A.4) wait for later
slices.
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
    imgs: List[torch.Tensor] = []
    for ki in keys:
        if batch.schema.dtypes[ki].is_string:
            raise NotImplementedError(
                "hash_join: string join keys need the union-lexsort probe, "
                "which is not ported yet")
        imgs.extend(u64_key_image(batch.columns[ki]))
    return imgs


def _concat_build(batches: Sequence[DeviceBatch]) -> DeviceBatch:
    if len(batches) == 1:
        return batches[0]
    return rowops.concat_batches(
        batches, bucket_capacity(sum(b.capacity for b in batches)))


class BuiltSide:
    """A join's build side: its batch (the build batches concatenated) and
    the B3 table over its keys (None for a cross join)."""

    def __init__(self, batch: DeviceBatch,
                 table: Optional[kernels.JoinTable]):
        self.batch = batch
        self.table = table


def build_side(batches: Sequence[DeviceBatch],
               keys: Sequence[int]) -> BuiltSide:
    """Concatenate the build batches once and build their table (B3); a
    cross join (no keys) builds none."""
    build = _concat_build(batches)
    if not keys:
        return BuiltSide(build, None)
    return BuiltSide(build, kernels.hash_join_build(
        _key_images(build, keys), join_ops._key_valid(build, keys),
        kernels.hash_table_size(build.capacity)))


def _empty(schema: Schema, device) -> DeviceBatch:
    return DeviceBatch(schema, join_ops.null_columns(schema, MIN_CAPACITY,
                                                     device),
                       torch.zeros((), dtype=torch.int32, device=device))


def probe_expand(built: BuiltSide, streams: Sequence[DeviceBatch],
                 join_type: str, stream_keys: Sequence[int],
                 stream_is_left: bool, out_schema: Schema
                 ) -> List[DeviceBatch]:
    """Probe every stream batch against the built side (B4), then expand:
    all expansion totals come back in one counted copy, none for semi and
    anti joins. At least one batch comes back (an empty one where the
    join yields no rows)."""
    build, jt = built.batch, built.table
    if not streams:
        return [_empty(out_schema, build.device)]
    # probe every stream batch before any host wait
    if jt is None:  # a cross join
        crossed = [join_ops.cross_probe(build, s) for s in streams]
        probes = [(counts, bstart) for counts, bstart, _p in crossed]
        bperm = crossed[0][2]
    else:
        probes = [kernels.hash_join_lookup(
            jt, _key_images(s, stream_keys),
            join_ops._key_valid(s, stream_keys)) for s in streams]
        bperm = jt.bperm
    if join_type in ("leftsemi", "leftanti"):
        return [join_ops.semi_anti_filter(s, counts,
                                          anti=join_type == "leftanti")
                for s, (counts, _b) in zip(streams, probes)]
    adjs = [join_ops.outer_adjusted_counts(s, counts)
            if join_type in OUTER else counts
            for s, (counts, _b) in zip(streams, probes)]
    totals = torch.stack([join_ops.expand_totals(build, s, adj)
                          for s, adj in zip(streams, adjs)])
    with sync_scope("join.expandTotals", nbytes=totals.numel() * 8):
        sizes = totals.cpu().tolist()
    out: List[DeviceBatch] = []
    matched = (torch.zeros(build.capacity, dtype=torch.bool,
                           device=build.device)
               if join_type == "full" else None)
    for stream, (counts, bstart), adj, size in zip(streams, probes, adjs,
                                                   sizes):
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
            out.append(batch)
    if join_type == "full":
        out.append(join_ops.unmatched_build_batch(
            build, matched, streams[0].schema, swap_sides=False))
    return out or [_empty(out_schema, build.device)]


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
    return probe_expand(build_side(builds, bkey), streams, join_type, skey,
                        stream_is_left, schema)


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
                state["side"] = build_side(batches, bkey)
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
                yield from probe_expand(side, list(sp()), self.join_type,
                                        skey, self._stream_is_left, schema)
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

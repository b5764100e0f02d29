"""Equi-join over device batches on the hash table (counterpart of the
in-core loop of the JAX package's ``exec/tpujoin.TpuShuffledHashJoinExec``;
the plan node itself waits for the session slice, so this is a plain
function over lists of batches).

``hash_join`` keeps the JAX exec's behaviour:

  * the side rule: stream = left, build = right, except for a right outer
    join, which streams the right side against a left build so that every
    preserved row is a stream row;
  * the build side is concatenated once, at the summed capacity of its
    batches;
  * every stream batch is probed first, then all expansion totals come back
    in ONE device->host copy per join, inside ``sync_scope``;
  * the expand runs per stream batch, plus the full-outer tail.

The probe is the hash table: the build side's key images go through B3
once per join (``kernels.hash_join_build``) and each stream batch through
B4 (``kernels.hash_join_lookup``), where the JAX exec rebuilt the table per
stream batch. Semi and anti joins need only the match counts, so they never
wait for the host. A full outer join always emits its tail batch, empty or
not, where the JAX exec fetched the tail's row count to decide.

Cross joins, the broadcast nested-loop join, out-of-core grace joins,
capacity speculation and string join keys wait for later slices.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from spark_rapids_tpu_torch.columnar.batch import (
    MIN_CAPACITY, DeviceBatch, Schema, bucket_capacity,
)
from spark_rapids_tpu_torch.obs.syncledger import sync_scope
from spark_rapids_tpu_torch.ops import joins as join_ops
from spark_rapids_tpu_torch.ops import kernels, rowops
from spark_rapids_tpu_torch.ops.sortops import u64_key_image

SUPPORTED_JOIN_TYPES = ("inner", "left", "right", "full", "leftsemi",
                        "leftanti")
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


def hash_join(left_batches: Sequence[DeviceBatch],
              right_batches: Sequence[DeviceBatch], join_type: str,
              left_keys: Sequence[int], right_keys: Sequence[int]
              ) -> List[DeviceBatch]:
    """Equi-join of two lists of batches on key column indices, ``join_type``
    one of SUPPORTED_JOIN_TYPES. Output columns: left then right (left only
    for semi and anti joins). Returns at least one batch (an empty one where
    the join yields no rows), on the device of the inputs."""
    if join_type not in SUPPORTED_JOIN_TYPES:
        raise NotImplementedError(f"hash_join: join type {join_type!r} is "
                                  "not ported yet")
    if len(left_keys) != len(right_keys) or not left_keys:
        raise ValueError("hash_join: needs matching, non-empty key lists")
    if not left_batches or not right_batches:
        raise ValueError("hash_join: each side needs at least one batch "
                         "(an empty table is one batch with no rows)")
    stream_is_left = join_type != "right"
    streams, builds = ((left_batches, right_batches) if stream_is_left
                       else (right_batches, left_batches))
    skey, bkey = ((left_keys, right_keys) if stream_is_left
                  else (right_keys, left_keys))
    build = _concat_build(builds)
    jt = kernels.hash_join_build(_key_images(build, bkey),
                                 join_ops._key_valid(build, bkey),
                                 kernels.hash_table_size(build.capacity))
    # probe every stream batch before any host wait
    probes = [kernels.hash_join_lookup(jt, _key_images(s, skey),
                                       join_ops._key_valid(s, skey))
              for s in streams]
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
                                                  jt.bperm)
        total = size[0]
        if total >= 1 << 31:
            raise ValueError(f"hash_join: {total} output rows of one stream "
                             "batch exceed int32")
        if total:
            out.append(join_ops.join_expand(
                build, stream, counts, adj, bstart, jt.bperm,
                bucket_capacity(total), swap_sides=not stream_is_left))
    if join_type == "full":
        out.append(join_ops.unmatched_build_batch(
            build, matched, streams[0].schema, swap_sides=False))
    if out:
        return out
    schema = output_schema(left_batches[0].schema, right_batches[0].schema,
                           join_type)
    dev = left_batches[0].device
    return [DeviceBatch(schema, join_ops.null_columns(schema, MIN_CAPACITY,
                                                      dev),
                        torch.zeros((), dtype=torch.int32, device=dev))]

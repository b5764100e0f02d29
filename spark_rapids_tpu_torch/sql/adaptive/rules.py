"""Runtime re-optimization rules over materialized stage statistics
(counterpart of the JAX package's ``sql/adaptive/rules.py``).

Three rules, the reference's AQE triad:

  * **partition coalescing** (Spark CoalesceShufflePartitions): merge
    adjacent reduce partitions while the group's measured size stays
    under ``spark.rapids.sql.adaptive.coalesce.minPartitionSize``. Join
    inputs plan jointly over COMBINED sizes so both sides stay
    co-partitioned.
  * **dynamic broadcast conversion** (Spark DynamicJoinSelection /
    DemoteBroadcastHashJoin inverse): a shuffled join whose build side's
    *measured* total lands under the broadcast threshold becomes a
    broadcast hash join, reusing the materialized map output and eliding
    a not-yet-run stream-side shuffle.
  * **skew-join splitting** (Spark OptimizeSkewedJoin): a reduce
    partition beyond ``skewedPartitionFactor x median`` (and the absolute
    threshold) splits into map-range sub-partitions on the skewed side,
    the other side replicated per sub-range.

All pure planning — the executor applies the outputs; every function
returns decision records for the event journal.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional, Sequence, Set, Tuple

from spark_rapids_tpu_torch.sql.adaptive.stages import (
    CoalescedSpec, PartialSpec, ShuffleStage,
)

# which join side may be split without changing results: splitting side S
# and replicating side O is valid iff no output row needs to see all of S
# at once — any join type where S is the probe/preserved side
SPLITTABLE_LEFT = ("inner", "left", "leftsemi", "leftanti")
SPLITTABLE_RIGHT = ("inner", "right")


def coalesce_groups(sizes: Sequence[int], min_size: int,
                    isolated: Set[int] = frozenset()) -> List[List[int]]:
    """Greedy adjacent grouping: accumulate partitions until the group's
    combined size reaches ``min_size`` (Spark's algorithm). Partitions in
    ``isolated`` (skew candidates) always stand alone."""
    groups: List[List[int]] = []
    cur: List[int] = []
    cur_sz = 0
    for p, sz in enumerate(sizes):
        if p in isolated:
            if cur:
                groups.append(cur)
                cur, cur_sz = [], 0
            groups.append([p])
            continue
        cur.append(p)
        cur_sz += sz
        if cur_sz >= min_size:
            groups.append(cur)
            cur, cur_sz = [], 0
    if cur:
        groups.append(cur)
    return groups


def split_map_ranges(map_sizes: Sequence[int],
                     target: int) -> List[Tuple[int, int]]:
    """Greedy map-range chunks of ~target bytes (Spark's
    ShufflePartitionsUtil.splitSizeListByTargetSize shape)."""
    ranges: List[Tuple[int, int]] = []
    lo, acc = 0, 0
    for m, sz in enumerate(map_sizes):
        acc += sz
        if acc >= target:
            ranges.append((lo, m + 1))
            lo, acc = m + 1, 0
    if lo < len(map_sizes):
        ranges.append((lo, len(map_sizes)))
    return ranges


def skewed_partitions(sizes: Sequence[int], factor: float,
                      threshold: int) -> Set[int]:
    """Partitions whose size exceeds factor x median AND the absolute
    threshold (both tests, like Spark's OptimizeSkewedJoin)."""
    if not sizes:
        return set()
    med = statistics.median(sizes)
    return {p for p, s in enumerate(sizes)
            if s > factor * med and s > threshold}


def solo_specs(stage: ShuffleStage, conf,
               decisions: Optional[List[dict]] = None) -> List[CoalescedSpec]:
    """Read plan for a single-stage consumer (final aggregate, sort,
    window): coalescing only — splitting an aggregation partition would
    separate rows of one key."""
    n = stage.n_partitions
    if not conf.adaptive_coalesce_enabled:
        return [CoalescedSpec((p,)) for p in range(n)]
    groups = coalesce_groups(stage.stats.bytes_by_partition,
                             conf.adaptive_coalesce_min_size)
    specs = [CoalescedSpec(tuple(g)) for g in groups]
    if decisions is not None and len(specs) < n:
        decisions.append({"rule": "coalesce", "stages": [stage.id],
                          "fromPartitions": n,
                          "toPartitions": len(specs)})
    return specs


def join_specs(left: ShuffleStage, right: ShuffleStage, join_type: str,
               conf, decisions: Optional[List[dict]] = None,
               ) -> Tuple[List, List]:
    """Joint read plan for a shuffled join's two materialized sides:
    aligned spec lists (equal length), jointly coalesced, skew-split
    where valid. Every reduce partition is covered exactly once per side
    (sub-split ranges partition the skewed side's maps)."""
    n = left.n_partitions
    assert right.n_partitions == n, (left.id, right.id)
    lsz = left.stats.bytes_by_partition
    rsz = right.stats.bytes_by_partition
    combined = [lsz[p] + rsz[p] for p in range(n)]

    # skew candidates per splittable side
    skew_side: Dict[int, str] = {}
    if conf.adaptive_skew_enabled:
        factor = conf.adaptive_skew_factor
        threshold = conf.adaptive_skew_threshold
        lskew = (skewed_partitions(lsz, factor, threshold)
                 if join_type in SPLITTABLE_LEFT and left.num_maps > 1
                 else set())
        rskew = (skewed_partitions(rsz, factor, threshold)
                 if join_type in SPLITTABLE_RIGHT and right.num_maps > 1
                 else set())
        for p in lskew | rskew:
            if p in lskew and p in rskew:
                skew_side[p] = "left" if lsz[p] >= rsz[p] else "right"
            else:
                skew_side[p] = "left" if p in lskew else "right"

    min_size = (conf.adaptive_coalesce_min_size
                if conf.adaptive_coalesce_enabled else 0)
    groups = coalesce_groups(combined, min_size,
                             isolated=set(skew_side)) \
        if min_size > 0 else \
        [[p] for p in range(n)]
    target = max(conf.adaptive_coalesce_min_size, 1)

    lspecs: List = []
    rspecs: List = []
    split_count = 0
    for g in groups:
        p = g[0]
        if len(g) == 1 and p in skew_side:
            side = skew_side[p]
            stage = left if side == "left" else right
            ranges = split_map_ranges(stage.stats.partition_map_sizes(p),
                                      target)
            if len(ranges) > 1:
                split_count += 1
                if decisions is not None:
                    decisions.append({
                        "rule": "skewSplit", "stage": stage.id,
                        "side": side, "partition": p,
                        "splits": len(ranges),
                        "bytes": int((lsz if side == "left" else rsz)[p]),
                    })
                for lo, hi in ranges:
                    if side == "left":
                        lspecs.append(PartialSpec(p, lo, hi))
                        rspecs.append(CoalescedSpec((p,)))
                    else:
                        lspecs.append(CoalescedSpec((p,)))
                        rspecs.append(PartialSpec(p, lo, hi))
                continue
        lspecs.append(CoalescedSpec(tuple(g)))
        rspecs.append(CoalescedSpec(tuple(g)))
    if decisions is not None and not split_count and len(lspecs) < n:
        decisions.append({"rule": "coalesce",
                          "stages": [left.id, right.id],
                          "fromPartitions": n,
                          "toPartitions": len(lspecs)})
    return lspecs, rspecs


def broadcast_sides(join_type: str) -> Tuple[bool, bool]:
    """(left allowed, right allowed) as the broadcast BUILD side: the
    build side must be the non-preserved side, so full outer never
    broadcasts (mirrors the static planner, sql/planner.py)."""
    if join_type == "inner":
        return True, True
    if join_type == "right":
        return True, False
    if join_type in ("left", "leftsemi", "leftanti"):
        return False, True
    return False, False

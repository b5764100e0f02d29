"""Out-of-core (larger-than-device) operator execution (counterpart of the
JAX package's ``exec/outofcore.py``).

When an operator's measured working set exceeds the working-set budget
(``spark.rapids.tpu.outOfCore.partitionBytes``, by default half the
metered device budget), its input is partitioned into fan-out buckets of
spillable slices registered on the 3-tier store (``memory/spill.py``); the
device store is spilled down to the budget as buckets fill, and the
operator then processes one bucket at a time, faulting its pieces back:

  * **grace hash join**: both sides hash-partitioned on the join keys
    (equal keys co-locate, so the per-bucket joins union to the exact
    result; NULL keys land in some bucket and never match, outer rows are
    kept wherever they land); a bucket whose build fragment still exceeds
    the budget recurses with the next level's hash, up to
    ``spark.rapids.tpu.outOfCore.maxRecursion`` levels. Each bucket runs
    the operator's own build and probe (``exec/tpujoin.build_side`` and
    ``probe_expand``: the dense, B3/B4 or union route, one counted sync for
    its expansion totals);
  * **external merge sort**: range bounds from a sample of every batch
    (one counted sync a batch, ``outofcore.sample``), range-partitioned
    spill buckets, one in-memory sort per bucket, buckets emitted in range
    order: their concatenation is exactly the single-batch sort (equal
    keys share a bucket, the split is stable and the pieces keep the input
    order, so ties keep the stable order);
  * **spillable aggregation**: partial-layout batches hash-partitioned on
    the grouping keys; the per-bucket merges (disjoint key sets) union to
    the exact aggregate.

The fan-out comes from the measured batch sizes
(``DeviceBatch.device_memory_size``, host metadata, no sync). Splitting a
batch reads its per-bucket row counts once (``outofcore.partitionCounts``,
one counted sync). Everything is opt-in (``outOfCore.enabled``, default
false) and changes only the order of the work, never its result.
``split_batch_by_hash`` is also the aggregate's split of a batch whose
hash table passes ``agg.hash.maxTableSlots`` (``exec/tpu.py``), on with
the hash aggregation alone.

``ooc.operators`` and ``ooc.fanout`` (by ``op``) count the engagements in
``obs/metrics.REGISTRY``; each is an ``outOfCore`` journal event (op,
fanout, bytes, budgetBytes, level; ``obs/events.py``), and ``RECORDS``
keeps the newest ones' operator, fan-out, bytes, budget and level.
"""

from __future__ import annotations

import collections
from typing import Iterator, List, Optional

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar.batch import (
    DeviceBatch, Schema, bucket_capacity,
)
from spark_rapids_tpu_torch.config import conf as C
from spark_rapids_tpu_torch.memory.spill import SpillPriorities
from spark_rapids_tpu_torch.obs.events import EVENTS
from spark_rapids_tpu_torch.obs.metrics import REGISTRY
from spark_rapids_tpu_torch.obs.syncledger import sync_scope
from spark_rapids_tpu_torch.ops import rowops, sortops
from spark_rapids_tpu_torch.ops.groupby import row_hashes
from spark_rapids_tpu_torch.ops.hashing import as_signed

_MAX_FANOUT = 64
# the engagements, newest last: (op, fanout, bytes, budget, level)
RECORDS: collections.deque = collections.deque(maxlen=1024)


# ---------------------------------------------------------------------------
# policy: enablement, budgets, fan-out
# ---------------------------------------------------------------------------

def enabled_for(ctx) -> bool:
    """Out-of-core applies when opted in and a session (and so the spill
    catalog) exists. The JAX package also steps aside under a device
    mesh, which the port does not have yet (ROADMAP A.9)."""
    if ctx.session is None:
        return False
    return ctx.conf.get_bool(C.OOC_ENABLED.key, False)


def working_set_budget(ctx) -> int:
    b = int(ctx.conf.get(C.OOC_PARTITION_BYTES.key, 0))
    if b > 0:
        return b
    dm = getattr(ctx.session, "device_manager", None)
    if dm is not None:
        return max(dm.hbm_budget // 2, 1 << 20)
    return 1 << 30


def total_batch_bytes(batches) -> int:
    """Measured device bytes of a batch list (capacity-based host
    metadata)."""
    return sum(b.device_memory_size() for b in batches if b is not None)


def choose_fanout(ctx, total_bytes: int, budget: int) -> int:
    """Bucket count from measured sizes: the next power of two of
    total/budget, clamped to [2, 64]; ``outOfCore.fanout`` overrides."""
    f = int(ctx.conf.get(C.OOC_FANOUT.key, 0))
    if f > 0:
        return max(2, min(f, _MAX_FANOUT))
    need = max(2, -(-int(total_bytes) // max(int(budget), 1)))
    n = 2
    while n < need and n < _MAX_FANOUT:
        n <<= 1
    return n


def _max_recursion(ctx) -> int:
    return int(ctx.conf.get(C.OOC_MAX_RECURSION.key, 3))


def split_stream_on_budget(ctx, it, budget: Optional[int] = None):
    """Consume ``it`` until the accumulated measured bytes exceed the
    budget. Returns ``(prefix, rest, engaged)``: on engagement ``rest`` is
    the still-unconsumed iterator (the input is never materialized past
    the budget); otherwise the whole input is in ``prefix`` and the caller
    keeps its in-memory path."""
    if budget is None:
        budget = working_set_budget(ctx)
    prefix: List[DeviceBatch] = []
    total = 0
    for b in it:
        prefix.append(b)
        total += b.device_memory_size()
        if total > budget:
            return prefix, it, True
    return prefix, None, False


def _stage_spillable(session, batches, budget: int, on_batch=None):
    """Register every incoming batch as a transient spillable (spilling the
    device store down to the budget as they arrive) without holding them
    live: peak residency stays near budget + one batch while the driver
    still needs a second look (to size the fan-out, to sample sort
    bounds). ``on_batch`` runs on each live batch before it is staged.
    Returns (ids, bytes)."""
    store = session.buffer_catalog.device_store
    bids: List[int] = []
    total = 0
    for b in batches:
        if b is None:
            continue
        if on_batch is not None:
            on_batch(b)
        total += b.device_memory_size()
        bids.append(session.add_transient_batch(
            b, SpillPriorities.OUTPUT_FOR_READ))
        del b
        if store.total_size > budget:
            store.synchronous_spill(budget)
    return bids, total


def _drain_staged(session, bids):
    """Yield staged batches one at a time, freeing each registration."""
    catalog = session.buffer_catalog
    for bid in bids:
        b = catalog.acquire_batch(bid)
        session.consume_transient(bid)
        yield b


def _record(op: str, fanout: int, total_bytes: int, budget: int,
            level: int = 0) -> None:
    REGISTRY.counter("ooc.operators", op=op).add(1)
    REGISTRY.counter("ooc.fanout", op=op).add(fanout)
    EVENTS.emit("outOfCore", op=op, fanout=fanout, bytes=int(total_bytes),
                budgetBytes=int(budget), level=level)
    RECORDS.append({"op": op, "fanout": fanout, "bytes": int(total_bytes),
                    "budget": int(budget), "level": level})


# ---------------------------------------------------------------------------
# spillable fan-out partitions
# ---------------------------------------------------------------------------

def _split_counts(split, batch: DeviceBatch):
    """(pid-sorted batch, host counts) of ``split(batch)``: one counted
    sync."""
    sorted_b, counts = split(batch)
    with sync_scope("outofcore.partitionCounts", nbytes=counts.numel() * 8):
        host = counts.cpu().tolist()
    return sorted_b, host


def _slices(sorted_b: DeviceBatch, counts, growth: float):
    """(bucket, slice) of every non-empty bucket of a pid-sorted batch,
    each gathered into a batch at its own capacity bucket."""
    off = 0
    for p, c in enumerate(counts):
        if c:
            piece = rowops.slice_batch_to(sorted_b, off, c,
                                          bucket_capacity(c, growth))
            piece.host_rows = c
            yield p, piece
        off += c


class SpilledPartitions:
    """Fan-out buckets of spillable batch slices.

    ``add_batch`` splits one batch by a per-row partition id, registers
    each non-empty slice as a transient spillable in the session catalog
    and pushes the device store down to the budget (partition-and-spill).
    ``consume_bucket`` faults a bucket's pieces back and frees them."""

    def __init__(self, session, n: int, growth: float, budget: int):
        self.session = session
        self.n = n
        self.growth = growth
        self.budget = budget
        self.buckets: List[List[int]] = [[] for _ in range(n)]
        self.bytes = [0] * n
        self.rows = [0] * n

    def add_batch(self, batch: DeviceBatch, split) -> None:
        """``split(batch) -> (pid-sorted batch, (n,) counts)``."""
        sorted_b, counts = _split_counts(split, batch)
        del batch
        for p, piece in _slices(sorted_b, counts, self.growth):
            self.bytes[p] += piece.device_memory_size()
            self.rows[p] += piece.host_rows
            self.buckets[p].append(self.session.add_transient_batch(
                piece, SpillPriorities.OUTPUT_FOR_READ))
        del sorted_b
        self.spill_to_budget()

    def spill_to_budget(self) -> None:
        store = self.session.buffer_catalog.device_store
        if store.total_size > self.budget:
            store.synchronous_spill(self.budget)

    def consume_bucket(self, p: int) -> List[DeviceBatch]:
        out = []
        catalog = self.session.buffer_catalog
        for bid in self.buckets[p]:
            out.append(catalog.acquire_batch(bid))
            self.session.consume_transient(bid)
        self.buckets[p] = []
        return out


def split_batch_by_hash(ctx, key_idx, batch: DeviceBatch, n: int,
                        level: int, growth: float) -> List[DeviceBatch]:
    """In-memory hash fan-out of one batch into <= n disjoint-key slices
    (equal keys co-locate; empty buckets are dropped): the light sibling of
    ``SpilledPartitions.add_batch``, without the spill store. The hash
    aggregation's table bound (``exec/tpu.py``) splits here a batch whose
    slot table would pass ``agg.hash.maxTableSlots``: the disjoint key
    sets make the slices' partial outputs union to exactly the whole
    batch's groups."""
    sorted_b, counts = _split_counts(hash_splitter(key_idx, n, level),
                                     batch)
    out = [piece for _p, piece in _slices(sorted_b, counts, growth)]
    _record("hashAggSplit", n, batch.device_memory_size(), 0, level)
    return out


# ---------------------------------------------------------------------------
# partition ids
# ---------------------------------------------------------------------------

_GAMMA = 0x9E3779B97F4A7C15


def _level_hash(batch: DeviceBatch, key_idx, level: int) -> torch.Tensor:
    """Per-row 64-bit key hash (int64 holding the uint64 pattern) for grace
    level ``level``: level 0 h1, level 1 the independent h2, deeper levels
    a mix, so a fragment that did not split at one level re-partitions
    differently at the next (equal keys still co-locate at every level).
    Strings hash their values, never dictionary codes."""
    h1, h2 = row_hashes(batch, list(key_idx))
    if level == 0:
        return h1
    if level == 1:
        return h2
    return h1 ^ (h2 + as_signed(_GAMMA * level))


def partition_ids_by_hash(batch: DeviceBatch, key_idx, n: int,
                          level: int) -> torch.Tensor:
    """int64 bucket of every row: the level hash, unsigned, mod ``n``."""
    from spark_rapids_tpu_torch.ops.aggregate import _umod
    return _umod(_level_hash(batch, key_idx, level), n)


def hash_splitter(key_idx, n: int, level: int):
    """(batch) -> (pid-sorted batch, counts), splitting on the key hash:
    the grace join's and the spillable aggregate's partitioner."""
    from spark_rapids_tpu_torch.exec.tpu import split_by_pid
    key_idx = list(key_idx)

    def split(b: DeviceBatch):
        return split_by_pid(b, partition_ids_by_hash(b, key_idx, n, level),
                            n)
    return split


# ---------------------------------------------------------------------------
# grace hash join
# ---------------------------------------------------------------------------

def join_applicable(ctx, exec_) -> bool:
    return (enabled_for(ctx) and exec_.join_type != "cross"
            and bool(exec_.left_keys))


def grace_join(ctx, exec_, build_batches, stream_batches, growth: float,
               level: int = 0) -> Iterator[DeviceBatch]:
    """Partition both sides on the join-key hash into spillable buckets,
    then join bucket by bucket; a build fragment still over budget recurses
    with the next level's hash. Both sides are iterables, never fully
    materialized: each batch is staged onto the spill store as it arrives,
    the fan-out comes from the staged measured totals, and the staged
    batches drain back one at a time into the partitioner."""
    session = ctx.session
    budget = working_set_budget(ctx)
    bbids, bbytes = _stage_spillable(session, build_batches, budget)
    sbids, sbytes = _stage_spillable(session, stream_batches, budget)
    n = choose_fanout(ctx, bbytes + sbytes, budget)
    _record("join", n, bbytes + sbytes, budget, level)
    _si, skey, bkey = exec_._sides()
    bparts = SpilledPartitions(session, n, growth, budget)
    sparts = SpilledPartitions(session, n, growth, budget)
    bsplit = hash_splitter(bkey, n, level)
    ssplit = hash_splitter(skey, n, level)
    for b in _drain_staged(session, bbids):
        bparts.add_batch(b, bsplit)
    for s in _drain_staged(session, sbids):
        sparts.add_batch(s, ssplit)
    emitted = False
    for p in range(n):
        frag_bytes = bparts.bytes[p]
        bpieces = bparts.consume_bucket(p)
        spieces = sparts.consume_bucket(p)
        if not bpieces and not spieces:
            continue
        if (frag_bytes > budget and level + 1 < _max_recursion(ctx)
                and len(bpieces) + len(spieces) > 1):
            for out in grace_join(ctx, exec_, bpieces, spieces, growth,
                                  level + 1):
                emitted = True
                yield out
            continue
        for out in _join_bucket(ctx, exec_, bpieces, spieces):
            emitted = True
            yield out
        bparts.spill_to_budget()
    if not emitted:
        from spark_rapids_tpu_torch.exec.tpu import empty_batch
        yield empty_batch(exec_.output_schema(), ctx.device)


def _join_bucket(ctx, exec_, bpieces: List[DeviceBatch],
                 spieces: List[DeviceBatch]) -> Iterator[DeviceBatch]:
    """One bucket's in-memory join through the operator's own build and
    probe. A bucket without stream rows yields only a full join's
    unmatched build rows."""
    from spark_rapids_tpu_torch.exec import tpujoin
    from spark_rapids_tpu_torch.exec.tpu import empty_batch
    si, skey, bkey = exec_._sides()
    if not spieces:
        if exec_.join_type != "full":
            return
        spieces = [empty_batch(exec_.children[si].output_schema(),
                               ctx.device)]
    if not bpieces:
        bpieces = [empty_batch(exec_.children[1 - si].output_schema(),
                               ctx.device)]
    side = tpujoin.build_side(bpieces, bkey, exec_.dense_plan(ctx.session))
    del bpieces
    yield from tpujoin.probe_expand(
        side, spieces, exec_.join_type, skey, exec_._stream_is_left,
        exec_.output_schema(), dm=ctx.session.device_manager)


# ---------------------------------------------------------------------------
# external merge sort
# ---------------------------------------------------------------------------

_SAMPLES_PER_BATCH = 128


def external_sort(ctx, exec_, batches, schema: Schema,
                  growth: float) -> Iterator[DeviceBatch]:
    """Sampled range bounds -> range-partitioned spill buckets -> one
    in-memory sort per bucket, emitted in range order: a globally sorted
    stream whose concatenation equals the single-batch sort.

    ``batches`` is an iterable, never fully materialized: each batch is
    sampled (128 evenly spaced live rows' sort operands and its row count,
    one counted copy) and then staged onto the spill store; bounds and
    fan-out come from the staged totals, and the staged batches drain back
    one at a time into the range partitioner."""
    from spark_rapids_tpu_torch.columnar.column import host_to_device
    from spark_rapids_tpu_torch.exec.tpu import concat_device, split_by_pid
    from spark_rapids_tpu_torch.parallel.distributed import (
        pick_bounds_from_samples,
    )
    session = ctx.session
    budget = working_set_budget(ctx)
    asc = [o.ascending for o in exec_.orders]
    nf = [o.nulls_first for o in exec_.orders]
    samples: List[np.ndarray] = []
    kbox = {"k": None}

    def sample(b: DeviceBatch) -> None:
        work, key_idx = exec_._key_batch(b)
        ops = sortops.sort_key_operands(work, key_idx, asc, nf, exact=False)
        m = _SAMPLES_PER_BATCH
        last = (b.num_rows.to(torch.int64) - 1).clamp(min=0)
        pos = torch.arange(m, dtype=torch.int64, device=b.device) \
            * last // (m - 1)
        picked = torch.stack([o[pos] for o in ops])
        flat = torch.cat([picked.reshape(-1),
                          b.num_rows.to(torch.int64).reshape(1)])
        with sync_scope("outofcore.sample", nbytes=flat.numel() * 8):
            host = flat.cpu().numpy()
        kbox["k"] = len(ops)
        if int(host[-1]) > 0:
            samples.append(host[:-1].reshape(len(ops), m).view(np.uint64))

    staged, total = _stage_spillable(session, batches, budget,
                                     on_batch=sample)
    k = kbox["k"]
    n = choose_fanout(ctx, total, budget)
    _record("sort", n, total, budget)
    device = ctx.device
    bounds = [host_to_device(np.ascontiguousarray(b).view(np.int64), device)
              for b in pick_bounds_from_samples(
                  samples, k if k is not None else len(asc), n)]

    def split(b: DeviceBatch):
        work, key_idx = exec_._key_batch(b)
        pid = sortops.range_partition_ids(work, key_idx, asc, nf, bounds)
        return split_by_pid(b, pid, n)

    parts = SpilledPartitions(session, n, growth, budget)
    for b in _drain_staged(session, staged):
        parts.add_batch(b, split)
    emitted = False
    dm = session.device_manager
    for p in range(n):
        pieces = parts.consume_bucket(p)
        if not pieces:
            continue
        merged = concat_device(pieces, schema, growth, device, dm=dm)
        del pieces
        emitted = True
        yield exec_._sort(merged)
        del merged
        parts.spill_to_budget()
    if not emitted:
        from spark_rapids_tpu_torch.exec.tpu import empty_batch
        yield exec_._sort(empty_batch(schema, device))


# ---------------------------------------------------------------------------
# spillable aggregation
# ---------------------------------------------------------------------------

def grace_aggregate(ctx, exec_, batches, growth: float, update,
                    hash_table) -> Iterator[DeviceBatch]:
    """Partial-layout batches hash-partitioned on the grouping keys into
    spillable buckets; each bucket merges (and in final mode finalizes) on
    its own: the key sets are disjoint across buckets, so the union of the
    per-bucket outputs is the aggregate. ``batches`` is an iterable: in
    partial mode ``update`` runs on each batch as it arrives and its
    partial is staged onto the spill store; the fan-out comes from the
    staged measured totals."""
    from spark_rapids_tpu_torch.exec.tpu import concat_device, empty_batch
    session = ctx.session
    plan = exec_.plan
    budget = working_set_budget(ctx)
    partial = exec_.mode == "partial"

    def updated():
        for b in batches:
            if b is not None:
                yield update(b) if partial else b
    staged, total = _stage_spillable(session, updated(), budget)
    n = choose_fanout(ctx, total, budget)
    _record("aggregate", n, total, budget)
    pschema = plan.partial_schema
    parts = SpilledPartitions(session, n, growth, budget)
    split = hash_splitter(range(plan.num_keys), n, 0)
    for b in _drain_staged(session, staged):
        parts.add_batch(b, split)
    emitted = False
    dm = session.device_manager
    for p in range(n):
        pieces = parts.consume_bucket(p)
        if not pieces:
            continue
        merged = exec_._merge(concat_device(pieces, pschema, growth,
                                            ctx.device, dm=dm), hash_table)
        del pieces
        emitted = True
        yield merged if partial else exec_._finalize(merged)
        del merged
        parts.spill_to_budget()
    if not emitted:
        if partial:
            yield update(empty_batch(exec_.children[0].output_schema(),
                                     ctx.device))
        else:
            yield exec_._finalize(exec_._merge(
                empty_batch(pschema, ctx.device), hash_table))

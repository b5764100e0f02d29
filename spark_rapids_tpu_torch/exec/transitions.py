"""Host <-> device transitions (counterpart of the JAX package's
``exec/transitions.py``).

  * ``upload_partition`` turns one Parquet scan partition into
    DeviceBatches: a ``RawRowGroup`` decode plan goes through
    ``ops/parquet_decode.decode_rowgroup`` (one host-to-device copy, then
    the decode kernels), one DeviceBatch per row group at
    ``bucket_capacity(rows)``. A split whose columns all fell back to the
    host arrives as a pandas frame and takes the same upload, every column
    as a host-decoded one.
  * ``upload_frames`` turns a partition of pandas frames (an in-memory
    source or a CPU operator's output) into
    DeviceBatches of at most ``batchSizeRows`` rows, every column probed
    for a dictionary (``DeviceBatch.from_pandas``; a string column that
    does not encode becomes a char slab of at most ``MAX_SLAB_STRIDE``
    bytes a row), inside one counted sync a batch.
  * ``pack_splits`` groups a Parquet scan's row groups, in file order,
    into partitions of at most ``batchSizeRows`` rows, so the coalesce
    above the scan concatenates them into batches of that size (the JAX
    package's scan keeps one row group a partition, where its coalesce
    cannot merge them).
  * ``HostToDeviceExec`` and ``DeviceToHostExec`` are the transition
    operators the overrides insert at every CPU/device boundary;
    ``scan_cache_for`` is the session's device scan cache
    (``spark.rapids.sql.cacheDeviceScans``).

The JAX package's HBM metering, spillable cache entries, semaphore and
double-buffered upload are not ported (ROADMAP A.8).
"""

from __future__ import annotations

import itertools
from typing import Iterator, List, Optional, Sequence

import pandas as pd

from spark_rapids_tpu_torch.columnar.batch import DeviceBatch, Schema
from spark_rapids_tpu_torch.exec.base import (
    ExecContext, Partition, PhysicalPlan,
)
from spark_rapids_tpu_torch.obs.syncledger import sync_scope
from spark_rapids_tpu_torch.ops.parquet_decode import (
    RawRowGroup, decode_rowgroup,
)

# widest per-row byte stride of a char slab (the JAX package's default
# spark.rapids.sql.dict.blockedChars.maxStride)
MAX_SLAB_STRIDE = 64


def upload_blocked_chars() -> int:
    """Max byte stride of the char-slab layout for plain string columns."""
    return MAX_SLAB_STRIDE


def _as_rowgroup(df, schema: Schema) -> RawRowGroup:
    """A host-decoded split as a RawRowGroup whose columns all fell back."""
    raw = RawRowGroup(len(df))
    raw.fallback = [(name, "host") for name in schema.names]
    raw.fallback_df = df
    return raw


def upload_partition(part: Partition, schema: Schema,
                     dict_state: Optional[dict],
                     device="cuda") -> Iterator[DeviceBatch]:
    """DeviceBatches of one scan partition. ``dict_state`` is shared by
    every partition of one scan, so all its batches agree on each string
    column's dictionary and slab stride."""
    for split in part():
        raw = split if getattr(split, "is_raw_rowgroup", False) \
            else _as_rowgroup(split, schema)
        batch = decode_rowgroup(raw, schema, dict_state, device)
        batch.host_rows = raw.n
        yield batch


def pack_splits(split_rows: Sequence[int], max_rows: int
                ) -> List[List[int]]:
    """Contiguous groups of split indices, each of at most ``max_rows``
    rows (a split larger than that alone)."""
    groups: List[List[int]] = []
    rows = 0
    for i, n in enumerate(split_rows):
        if groups and rows + n <= max_rows:
            groups[-1].append(i)
            rows += n
        else:
            groups.append([i])
            rows = n
    return groups


def chain_partitions(parts: Sequence[Partition],
                     groups: Sequence[Sequence[int]]) -> List[Partition]:
    """One partition per group: its parts' outputs in order."""
    def make(group: Sequence[int]) -> Partition:
        def run():
            return itertools.chain.from_iterable(parts[i]() for i in group)
        return run
    return [make(g) for g in groups]


def scan_cache_for(ctx: ExecContext, source, schema: Schema,
                   max_rows: int) -> Optional[dict]:
    """The session's device batches of one source ({partition: [batch]}),
    or None when spark.rapids.sql.cacheDeviceScans is off. The entry holds
    the source itself, so its id cannot be reused by another frame while
    the entry lives; projection views key on their base source."""
    if ctx.session is None or not ctx.conf.get_bool(
            "spark.rapids.sql.cacheDeviceScans", False):
        return None
    store = ctx.session.device_scan_cache
    base = getattr(source, "_base", source)
    key = (id(base), tuple(schema.names), max_rows)
    if key not in store:
        store[key] = (source, {})
    return store[key][1]


def upload_frames(part: Partition, max_rows: int, dict_state: dict,
                  device) -> Iterator[DeviceBatch]:
    """DeviceBatches of a partition of pandas frames, at most ``max_rows``
    rows each. ``dict_state`` is shared by every partition of one upload,
    so all its batches agree on each column's dictionary. The upload of a
    batch copies from pageable host memory: one counted sync."""
    for df in part():
        for lo in range(0, max(len(df), 1), max_rows):
            chunk = df if len(df) <= max_rows else \
                df.iloc[lo:lo + max_rows].reset_index(drop=True)
            with sync_scope("scan.upload"):
                batch = DeviceBatch.from_pandas(
                    chunk, dict_state, device=device,
                    slab_stride=upload_blocked_chars())
            yield batch


class HostToDeviceExec(PhysicalPlan):
    """pandas partitions -> DeviceBatches of at most batchSizeRows rows."""

    columnar_output = True

    def __init__(self, child: PhysicalPlan):
        super().__init__([child])

    def output_schema(self) -> Schema:
        return self.children[0].output_schema()

    def partitions(self, ctx: ExecContext) -> List[Partition]:
        max_rows = ctx.conf.batch_size_rows
        dict_state: dict = {}

        def make(part: Partition) -> Partition:
            def run() -> Iterator[DeviceBatch]:
                return upload_frames(part, max_rows, dict_state, ctx.device)
            return run
        return [make(p) for p in self.children[0].executed_partitions(ctx)]


class DeviceToHostExec(PhysicalPlan):
    """DeviceBatches -> pandas frames, one counted fetch a batch."""

    columnar_output = False

    def __init__(self, child: PhysicalPlan):
        super().__init__([child])

    def output_schema(self) -> Schema:
        return self.children[0].output_schema()

    def partitions(self, ctx: ExecContext) -> List[Partition]:
        def make(part: Partition) -> Partition:
            def run() -> Iterator[pd.DataFrame]:
                for batch in part():
                    yield batch.to_pandas()
            return run
        return [make(p) for p in self.children[0].executed_partitions(ctx)]

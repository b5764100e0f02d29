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
    does not encode becomes a char slab when its longest value fits
    ``upload_blocked_chars`` bytes, else plain offsets and chars, the JAX
    package's rule), inside one counted sync a batch. A later batch may
    take another form than the first: ``rowops.concat_batches`` widens
    narrower slabs and makes plain chars of mixed forms.
  * ``pack_splits`` groups a Parquet scan's kept row groups, in file order,
    into partitions of at most ``batchSizeRows`` rows, so the coalesce
    above the scan concatenates them into batches of that size (the JAX
    package's scan keeps one row group a partition, where its coalesce
    cannot merge them).
  * ``HostToDeviceExec`` and ``DeviceToHostExec`` are the transition
    operators the overrides insert at every CPU/device boundary;
    ``scan_cache_for`` is the session's device scan cache
    (``spark.rapids.sql.cacheDeviceScans``; keyed by the source, the
    columns, the batch size and the pushed filters, so that a scan pruned
    for one predicate never serves one that needs more row groups), whose
    batches live in the
    session's spill catalog (``cache_uploads``, ``replay_cached``; a
    replay publishes each batch's input file again, as the first run's
    scan did).

Under the memory runtime (``memory/``), as in the JAX package: a scan
batch uploaded for one execution is metered against the session's
device budget (freed with the batch); a cached one registers in the
catalog at the ``CACHED_SCAN`` band, so over budget it spills to host and
disk and a later execution faults it back; a partition's upload takes
the session's semaphore (``TpuScanExec``, ``HostToDeviceExec``). The
JAX package's double-buffered upload (``scan.prefetchDepth``) is not
ported: an upload from pageable memory waits for its copy anyway (one
counted sync a batch).

Observability, as in the JAX package: a frame upload is a ``scan.upload``
span and a device decode a ``scan.deviceDecode`` span; each reports its
seconds against the operator pulling it (``note_transfer("h2d")``, the
profile's transfer component; a device decode's copy reports from
``ops/parquet_decode``), and each uploaded batch is a
``PROGRESS.scan_upload`` note. ``DeviceToHostExec`` reports its fetches'
seconds as ``note_transfer("d2h")``.
"""

from __future__ import annotations

import itertools
import time
from typing import Iterator, List, Optional, Sequence

import pandas as pd

from spark_rapids_tpu_torch.columnar.batch import DeviceBatch, Schema
from spark_rapids_tpu_torch.columnar.column import MAX_SLAB_STRIDE
from spark_rapids_tpu_torch.exec.base import (
    ExecContext, Partition, PhysicalPlan,
)
from spark_rapids_tpu_torch.obs import compileledger
from spark_rapids_tpu_torch.obs.progress import PROGRESS
from spark_rapids_tpu_torch.obs.syncledger import sync_scope
from spark_rapids_tpu_torch.obs.trace import TRACER
from spark_rapids_tpu_torch.ops.parquet_decode import (
    RawRowGroup, decode_rowgroup,
)


def upload_blocked_chars(conf=None) -> int:
    """Max byte stride of the char-slab layout for string columns that do
    not dictionary-encode (``spark.rapids.sql.dict.blockedChars`` and its
    ``.maxStride``, as the JAX package reads them), or 0 when slabs are
    off (or ``spark.rapids.sql.dict.enabled`` is false, as in the JAX
    package); a longer column uploads as plain offsets and chars."""
    if conf is None:
        return MAX_SLAB_STRIDE
    if not conf.get_bool("spark.rapids.sql.dict.enabled", True):
        return 0
    if not conf.get_bool("spark.rapids.sql.dict.blockedChars", True):
        return 0
    return max(0, conf.get_int("spark.rapids.sql.dict.blockedChars.maxStride",
                               MAX_SLAB_STRIDE))


def dict_enabled(conf) -> bool:
    """``spark.rapids.sql.dict.enabled``: whether a pandas upload
    dictionary-encodes its columns."""
    return conf.get_bool("spark.rapids.sql.dict.enabled", True)


def _as_rowgroup(df, schema: Schema) -> RawRowGroup:
    """A host-decoded split as a RawRowGroup whose columns all fell back."""
    raw = RawRowGroup(len(df))
    raw.fallback = [(name, "host") for name in schema.names]
    raw.fallback_df = df
    return raw


def upload_partition(part: Partition, schema: Schema,
                     dict_state: Optional[dict],
                     device="cuda", session=None,
                     meter: bool = True) -> Iterator[DeviceBatch]:
    """DeviceBatches of one scan partition. ``dict_state`` is shared by
    every partition of one scan, so all its batches agree on each string
    column's dictionary and slab stride. A row group's footer bounds of
    its integer columns (or a host split's values) join the ``session``'s
    statistics, and its plans go through the session's encoded-page cache
    (``page_cache``). Each batch is metered against the session's budget
    unless ``meter`` is off: a cached upload is metered by the catalog
    (``cache_uploads``) instead."""
    page_cache = getattr(session, "page_cache", None)
    for split in part():
        raw = split if getattr(split, "is_raw_rowgroup", False) \
            else _as_rowgroup(split, schema)
        if session is not None:
            for name, (lo, hi) in raw.stats.items():
                note_bounds(session, name, lo, hi)
            if raw.fallback_df is not None:
                note_scan_stats(session, raw.fallback_df)
        with TRACER.span("scan.deviceDecode", rows=raw.n):
            batch = decode_rowgroup(raw, schema, dict_state, device,
                                    page_cache)
        batch.host_rows = raw.n
        if PROGRESS.enabled:
            PROGRESS.scan_upload(raw.n)
        if meter:
            _meter(session, batch)
        yield batch


def _meter(session, batch: DeviceBatch) -> None:
    """Meter an uploaded batch against the session's device budget."""
    if session is not None:
        session.device_manager.meter_batch(batch)


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
                   max_rows: int, pushed_filters=None) -> Optional[dict]:
    """The session's device batches of one source ({partition: [batch]}),
    or None when spark.rapids.sql.cacheDeviceScans is off. The entry holds
    the source itself, so its id cannot be reused by another frame while
    the entry lives; projection views key on their base source. The pushed
    filters are part of the key: a scan pruned for one predicate must not
    serve a query that needs more row groups."""
    if ctx.session is None or not ctx.conf.get_bool(
            "spark.rapids.sql.cacheDeviceScans", False):
        return None
    store = ctx.session.device_scan_cache
    base = getattr(source, "_base", source)
    fkey = tuple(pushed_filters) if pushed_filters else None
    key = (id(base), tuple(schema.names), max_rows, fkey)
    if key not in store:
        store[key] = (source, {})
    return store[key][1]


class CachedPartition(list):
    """A cached partition's batch ids, with the input file each batch was
    read from (``files``), which a replay publishes again."""

    def __init__(self):
        super().__init__()
        self.files: List[str] = []


def cache_uploads(session, cache: dict, i: int,
                  batches: Iterator[DeviceBatch]) -> Iterator[DeviceBatch]:
    """Pass partition ``i``'s uploads on, registering each in the session's
    spill catalog (the ``CACHED_SCAN`` band: re-faultable, so it spills
    before operator outputs); the partition's ids are published in
    ``cache`` once the upload ends. An abandoned or failed upload frees
    what it registered."""
    from spark_rapids_tpu_torch.exec import taskctx
    from spark_rapids_tpu_torch.memory.spill import SpillPriorities
    catalog = session.buffer_catalog
    out = CachedPartition()
    try:
        for batch in batches:
            out.append(catalog.add_batch(batch,
                                         SpillPriorities.CACHED_SCAN))
            out.files.append(taskctx.input_file())
            yield batch
        cache[i] = out
    finally:
        if cache.get(i) is not out:
            for bid in out:
                catalog.remove(bid)


def replay_cached(session, bids: Sequence[int]) -> Iterator[DeviceBatch]:
    """A cached partition's batches, each faulted back to the device where
    it was spilled, with its input file published while it is consumed
    (input_file_name() on a warm run)."""
    from spark_rapids_tpu_torch.exec import taskctx
    catalog = session.buffer_catalog
    files = getattr(bids, "files", None)
    try:
        for j, bid in enumerate(bids):
            if files:
                taskctx.set_input_file(files[j])
            yield catalog.acquire_batch(bid)
    finally:
        if files:
            taskctx.clear_input_file()


def note_scan_stats(session, df: pd.DataFrame) -> None:
    """Union each scanned integer column's (min, max) into the session's
    advisory statistics (``session.column_stats``). Called only from scan
    uploads, so a derived column never seeds them; the dense join verifies
    the bounds on the device before it relies on them
    (``exec/tpujoin.py``)."""
    if session is None:
        return
    for name in df.columns:
        s = df[name]
        if (not pd.api.types.is_integer_dtype(s.dtype)
                or pd.api.types.is_bool_dtype(s.dtype)
                or not int(s.count())):
            continue
        note_bounds(session, str(name), int(s.min()), int(s.max()))


def note_bounds(session, name: str, lo: int, hi: int) -> None:
    """Union (lo, hi) into the session's statistics of column ``name``."""
    prev = session.column_stats.get(name)
    if prev is not None:
        lo, hi = min(lo, prev[0]), max(hi, prev[1])
    session.column_stats[name] = (lo, hi)


def upload_frames(part: Partition, max_rows: int, dict_state: dict,
                  device, session=None, meter: bool = True,
                  max_stride: int = MAX_SLAB_STRIDE,
                  schema: Optional[Schema] = None,
                  dict_encode: bool = True
                  ) -> Iterator[DeviceBatch]:
    """DeviceBatches of a partition of pandas frames, at most ``max_rows``
    rows each. ``dict_state`` is shared by every partition of one upload,
    so all its batches agree on each column's dictionary. The upload of a
    batch copies from pageable host memory: one counted sync. A scan
    passes its ``session``, whose statistics each frame's integer columns
    then join, and whose budget meters each batch unless ``meter`` is off
    (a cached upload, metered by the catalog). ``max_stride`` is the
    widest char slab (``upload_blocked_chars``). A file scan passes its
    ``schema``, whose types the columns then take (a host reader's date
    column is a column of ``datetime.date`` objects). ``dict_encode``
    off (``spark.rapids.sql.dict.enabled=false``) uploads no
    dictionary."""
    for df in part():
        note_scan_stats(session, df)
        for lo in range(0, max(len(df), 1), max_rows):
            chunk = df if len(df) <= max_rows else \
                df.iloc[lo:lo + max_rows].reset_index(drop=True)
            with TRACER.span("scan.upload", rows=len(chunk)):
                t0 = time.perf_counter()
                with sync_scope("scan.upload") as sc:
                    batch = DeviceBatch.from_pandas(
                        chunk, dict_state, device=device,
                        slab_stride=max_stride, schema=schema,
                        dict_encode=dict_encode)
                    sc.add_bytes(batch.device_memory_size())
                compileledger.note_transfer(time.perf_counter() - t0, "h2d")
            if PROGRESS.enabled:
                PROGRESS.scan_upload(len(chunk))
            if meter:
                _meter(session, batch)
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
                if ctx.session is not None:
                    ctx.session.semaphore.acquire_if_necessary()
                for batch in upload_frames(
                        part, max_rows, dict_state, ctx.device,
                        max_stride=upload_blocked_chars(ctx.conf),
                        dict_encode=dict_enabled(ctx.conf)):
                    _meter(ctx.session, batch)
                    yield batch
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
                    t0 = time.perf_counter()
                    df = batch.to_pandas()
                    compileledger.note_transfer(time.perf_counter() - t0,
                                                "d2h")
                    yield df
            return run
        return [make(p) for p in self.children[0].executed_partitions(ctx)]

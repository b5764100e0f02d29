"""Typed configuration registry (counterpart of the JAX package's
``config/conf.py``): every key the JAX package registers is registered
here with its name, type and default, or listed in ``IGNORED_KEYS``
with the reason it means nothing in the port.

Every knob is a registered ``ConfEntry`` with a key, a converter, the JAX
package's default, a doc string and, where the JAX package has one, its
validator (a bad value raises ValueError when it is set); ``TpuConf`` wraps a dict of settings
with typed accessors. Unregistered keys are allowed (the per-operator
enable keys ``spark.rapids.sql.exec.<Name>`` are generated by the
overrides) and read back as given.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional


@dataclass(frozen=True)
class ConfEntry:
    key: str
    conv: Callable[[str], Any]
    default: Any
    doc: str
    validator: Optional[Callable[[Any], Optional[str]]] = None

    def convert(self, raw: Any) -> Any:
        value = self.conv(raw) if isinstance(raw, str) else raw
        if self.validator is not None:
            err = self.validator(value)
            if err:
                raise ValueError(f"invalid value for {self.key}: {err}")
        return value


_REGISTRY: Dict[str, ConfEntry] = {}


def _to_bool(s: str) -> bool:
    low = s.strip().lower()
    if low in ("true", "1", "yes"):
        return True
    if low in ("false", "0", "no"):
        return False
    raise ValueError(f"not a boolean: {s!r}")


def _to_bytes(s: str) -> int:
    """Parse '1g', '512m', '16k' or raw integers into bytes."""
    s = s.strip().lower()
    mults = {"k": 1 << 10, "m": 1 << 20, "g": 1 << 30, "t": 1 << 40, "b": 1}
    if s and s[-1] in mults:
        return int(float(s[:-1]) * mults[s[-1]])
    return int(s)


def _fraction(lo: float, hi: float) -> Callable[[Any], Optional[str]]:
    def check(v: Any) -> Optional[str]:
        if not (lo <= float(v) <= hi):
            return f"must be within [{lo}, {hi}], got {v}"
        return None
    return check


def _positive(v: Any) -> Optional[str]:
    return None if v > 0 else f"must be positive, got {v}"


def _non_negative(v: Any) -> Optional[str]:
    return None if v >= 0 else f"must be >= 0, got {v}"


def register(key: str, conv: Callable[[str], Any], default: Any,
             doc: str,
             validator: Optional[Callable[[Any], Optional[str]]] = None
             ) -> ConfEntry:
    entry = ConfEntry(key, conv, default, doc, validator)
    _REGISTRY[key] = entry
    return entry


SQL_ENABLED = register(
    "spark.rapids.sql.enabled", _to_bool, True,
    "Enable (true) or disable (false) device acceleration of SQL plans. "
    "When disabled every operator executes on the CPU path.")
EXPLAIN = register(
    "spark.rapids.sql.explain", str, "NONE",
    "Explain why parts of a query were or were not placed on the device: "
    "NONE, ALL (the full tag tree) or NOT_ON_TPU (the fallbacks only).")
TEST_ENABLED = register(
    "spark.rapids.sql.test.enabled", _to_bool, False,
    "For tests: a query fails if an operator not in "
    "spark.rapids.sql.test.allowedNonTpu runs on the CPU.")
TEST_ALLOWED_NONTPU = register(
    "spark.rapids.sql.test.allowedNonTpu", str, "",
    "Comma-separated operator class names allowed on the CPU in test mode.")
BATCH_SIZE_ROWS = register(
    "spark.rapids.sql.batchSizeRows", int, 1 << 20,
    "Target rows per columnar batch; batches pad to a power-of-two "
    "capacity bucket.")
CAPACITY_GROWTH = register(
    "spark.rapids.sql.batchCapacityGrowth", float, 2.0,
    "Growth factor between consecutive batch capacity buckets.")
CACHE_DEVICE_SCANS = register(
    "spark.rapids.sql.cacheDeviceScans", _to_bool, False,
    "Keep uploaded scan batches on the device across executions of the "
    "same source, so a warm execution skips the upload.")
SHUFFLE_PARTITIONS = register(
    "spark.rapids.sql.shuffle.partitions", int, 8,
    "Number of shuffle output partitions of a hash exchange.")
SHUFFLE_LOCAL_COLLAPSE = register(
    "spark.rapids.sql.shuffle.localCollapse", _to_bool, True,
    "When no device mesh is configured, collapse device-side shuffle "
    "exchanges to a single output partition instead of materializing n "
    "hash/range buckets. On one chip the buckets are pure overhead (they "
    "serialize anyway) and bucket-count readback costs a device->host "
    "round trip per window; the collapsed exchange is one fused concat "
    "with zero synchronization. Multi-chip meshes ignore this and "
    "exchange for real over ICI collectives.")
AGG_SKIP_RATIO = register(
    "spark.rapids.sql.agg.skipAggPassReductionRatio", float, 0.45,
    "Partial-aggregation skip, decided at run time: the partial pass "
    "measures output groups / input rows over its first batches (one "
    "counted host sync a sampled batch) and, once the ratio exceeds this "
    "value, projects later batches straight into the partial layout for "
    "the final aggregate. The decision seeds the session's ratio cache, so "
    "later executions decide from batch 0 without a sync. 1.0 disables "
    "it.")
AGG_HASH_ENABLED = register(
    "spark.rapids.sql.agg.hashAggEnabled", _to_bool, False,
    "One-pass open-addressing hash aggregation (kernel B2) for keys that "
    "are not all dictionary-encoded (off: the sorted-payload branch).")
AGG_HASH_MAX_SLOTS = register(
    "spark.rapids.sql.agg.hash.maxTableSlots", int, 1 << 17,
    "Slot-count bound of the hash-aggregation table; a batch sizing past "
    "it aggregates on the sorted-payload branch.")
BROADCAST_THRESHOLD = register(
    "spark.rapids.sql.autoBroadcastJoinThreshold", _to_bytes, 10 << 20,
    "Maximum estimated build-side size for which a join uses a broadcast "
    "exchange instead of hash-partitioned exchanges "
    "(spark.sql.autoBroadcastJoinThreshold equivalent). -1 disables.")

DICT_WIRE = register(
    "spark.rapids.sql.dict.wire", _to_bool, True,
    "Ship dictionary-encoded string columns over the shuffle wire as "
    "int32 codes + the dictionary values (wire format v2) instead of "
    "materialized char slabs, and rebuild them codes-only on the reduce "
    "side. false writes legacy v1 chars+offsets frames (dictionary "
    "columns decode host-side at serialization, still with no device "
    "char gather).")

DICT_BLOCKED_CHARS = register(
    "spark.rapids.sql.dict.blockedChars", _to_bool, True,
    "Upload a string column that does not dictionary-encode as a "
    "fixed-stride char slab when its longest value fits "
    "spark.rapids.sql.dict.blockedChars.maxStride; false uploads every "
    "such column as plain offsets and chars.")
DICT_BLOCKED_MAX_STRIDE = register(
    "spark.rapids.sql.dict.blockedChars.maxStride", int, 64,
    "Widest per-row byte stride (a power of two, at least 8) of a char "
    "slab; a longer column uploads as plain offsets and chars, whose "
    "device bytes are its values' total rather than rows x the longest "
    "value.")
CAST_STRING_TO_INTEGER = register(
    "spark.rapids.sql.castStringToInteger.enabled", _to_bool, False,
    "Enable casting strings to integral types on the device. Disabled by "
    "default because overflow corner cases differ from the CPU.")
CAST_STRING_TO_DATE = register(
    "spark.rapids.sql.castStringToDate.enabled", _to_bool, False,
    "Enable casting strings to dates on the device (yyyy-MM-dd prefix "
    "form, roundtrip-validated calendar).")

FUSE_COUNT_DISTINCT = register(
    "spark.rapids.sql.agg.fuseCountDistinct", _to_bool, True,
    "Run the two-level aggregation of a grouped count distinct as one "
    "pass (exec/aggfuse.py): hash group ids over kernel B3 where every "
    "key is fixed-width or a dictionary, one sort where a key is a char "
    "slab.")

AGG_FUSE_FILTER = register(
    "spark.rapids.sql.agg.fuseFilter", _to_bool, True,
    "Fuse a Filter (and intervening deterministic Projects) below a "
    "partial hash aggregate into the aggregation as a row mask, skipping "
    "the filter's row compaction (kernel B1 and one gather per column; "
    "exec/fusion.py).")
EXCHANGE_FUSE_FILTER = register(
    "spark.rapids.sql.exchange.fuseFilter", _to_bool, True,
    "Fuse a deterministic Filter directly below a collapsed exchange (or "
    "a broadcast materialization) into the concat's single compaction "
    "gather, eliminating the standalone filter's per-batch per-column "
    "gathers.")
ADAPTIVE_CAPACITY = register(
    "spark.rapids.sql.adaptiveCapacity.enabled", _to_bool, True,
    "Adaptive (AQE-style) output-capacity speculation: the session "
    "remembers each join's expansion sizes per structural plan "
    "fingerprint and later executions of the same query skip the "
    "per-join device->host capacity sync, expanding straight into the "
    "remembered buckets. The exact sizes are still computed on device; "
    "ONE deferred fetch at query end (speculation.verify) verifies every "
    "speculated capacity covered its actual size and the query "
    "transparently re-executes without speculation on any miss - "
    "correctness never depends on the cache. Also the verification "
    "substrate of spark.rapids.sql.agg.denseKeys, which this conf gates.")
AGG_DENSE_KEYS = register(
    "spark.rapids.sql.agg.denseKeys", _to_bool, True,
    "Bounded-int composite grouping keys: when every group key is a "
    "fixed-width integer with advisory scan-stat bounds fitting 62 bits "
    "of combined slot space, the grouping runs on ONE exact composite "
    "key (ops/aggregate.dense_composite) and outranks the hash table. "
    "The device-computed bounds check joins the deferred speculation "
    "verification: a stale-stats miss transparently re-executes the "
    "query without dense grouping and blocklists the plan. Requires "
    "spark.rapids.sql.adaptiveCapacity.enabled (the verification "
    "machinery); disabling that disables dense grouping too.")

# --- whole-stage fusion (exec/stagecompiler/) -------------------------------
FUSION_STAGE_ENABLED = register(
    "spark.rapids.sql.fusion.stageEnabled", _to_bool, False,
    "Whole-stage fusion (exec/stagecompiler/): cut the converted physical "
    "plan into fusible pipelines at exchange/scan/fallback boundaries and "
    "run each pipeline as ONE composed per-batch function "
    "(TpuFusedStageExec) instead of one operator iterator per member - "
    "chains of deterministic Project/Filter (with interleaved batch "
    "coalescing absorbed) run with one Python dispatch a batch. false "
    "(default) keeps the per-operator plans. Fused stages report their "
    "member-operator pipeline to the profile tree, progress records and "
    "flight recorder.")
FUSION_MIN_OPS = register(
    "spark.rapids.sql.fusion.minOperators", int, 2,
    "Minimum number of compute operators (projects/filters) a pipeline "
    "must contain before whole-stage fusion replaces it with a fused "
    "stage; shorter chains keep their standalone operators (fusing one "
    "operator only renames its dispatch).", validator=_positive)
FUSION_DONATE = register(
    "spark.rapids.sql.fusion.donateInputs", _to_bool, False,
    "Accepted for compatibility with the JAX package, where it donates "
    "the fused-stage program's input buffers (jax donate_argnums). Eager "
    "PyTorch has no buffer donation: on this backend the setting is "
    "accepted and changes nothing.")

# --- adaptive query execution (sql/adaptive/) -------------------------------
ADAPTIVE_ENABLED = register(
    "spark.rapids.sql.adaptive.enabled", _to_bool, False,
    "Adaptive query execution: cut the physical plan into query stages at "
    "hash-exchange boundaries, materialize each stage's map side, fold the "
    "observed per-partition sizes into MapOutputStatistics and re-optimize "
    "the not-yet-executed remainder (partition coalescing, dynamic "
    "broadcast conversion, skew-join splitting - sql/adaptive/). false "
    "(default) keeps the single-shot planner.")
ADAPTIVE_COALESCE_ENABLED = register(
    "spark.rapids.sql.adaptive.coalesce.enabled", _to_bool, True,
    "With AQE on, merge adjacent reduce partitions whose combined "
    "measured size is below "
    "spark.rapids.sql.adaptive.coalesce.minPartitionSize, so the reduce "
    "side runs fewer, fuller tasks (Spark's CoalesceShufflePartitions). "
    "Join inputs coalesce jointly (combined sizes) to stay "
    "co-partitioned.")
ADAPTIVE_COALESCE_MIN_SIZE = register(
    "spark.rapids.sql.adaptive.coalesce.minPartitionSize", _to_bytes,
    8 << 20,
    "Target (and minimum) measured byte size of one post-coalesce reduce "
    "partition; adjacent partitions merge until the group reaches it. "
    "Also the advisory target size of one skew-split sub-partition.",
    validator=_positive)
ADAPTIVE_BROADCAST_ENABLED = register(
    "spark.rapids.sql.adaptive.broadcast.enabled", _to_bool, True,
    "With AQE on, replace a planned shuffled-hash join with a broadcast "
    "hash join when the build side's MEASURED materialized size comes in "
    "under spark.rapids.sql.autoBroadcastJoinThreshold (which the static "
    "planner could not prove from estimates). The already-materialized "
    "map output is reused as the broadcast table - the source is never "
    "re-read - and a not-yet-materialized stream-side shuffle is elided "
    "entirely.")
ADAPTIVE_SKEW_ENABLED = register(
    "spark.rapids.sql.adaptive.skewJoin.enabled", _to_bool, True,
    "With AQE on, split a skewed reduce partition of a shuffled join "
    "into map-range sub-partitions on the skewed side and replicate the "
    "matching partition on the other side (Spark's "
    "OptimizeSkewedJoin). A partition is skewed when its measured size "
    "exceeds skewedPartitionFactor x the median AND "
    "skewedPartitionThreshold.")
ADAPTIVE_SKEW_FACTOR = register(
    "spark.rapids.sql.adaptive.skewJoin.skewedPartitionFactor", float, 5.0,
    "Multiple of the median reduce-partition size beyond which a join "
    "partition counts as skewed.", validator=_positive)
ADAPTIVE_SKEW_THRESHOLD = register(
    "spark.rapids.sql.adaptive.skewJoin.skewedPartitionThreshold",
    _to_bytes, 4 << 20,
    "Minimum measured byte size for a reduce partition to count as "
    "skewed (guards the factor test against tiny shuffles).",
    validator=_positive)

# --- shape buckets (utils/kernelcache.py) -----------------------------------
COMPILE_SHAPE_BUCKETS = register(
    "spark.rapids.tpu.compile.shapeBuckets", _to_bool, False,
    "Bucket-padded secondary shape dimensions: the coarse input "
    "re-batching of a fused stage and the other secondary-dimension "
    "materializations (utils/kernelcache.bucket_dim) pad up a coarser "
    "bucket ladder, so one capacity serves a dimension range. Row counts "
    "stay exact (the padding is masked like capacity padding), so results "
    "are value-identical - only capacities grow. false (default) leaves "
    "every dimension at its own bucket.")
COMPILE_SHAPE_BUCKETS_MIN = register(
    "spark.rapids.tpu.compile.shapeBuckets.minBucket", int, 4096,
    "Floor of the coarse secondary-dimension bucket ladder: every padded "
    "dimension is at least this, collapsing the small buckets "
    "(8..minBucket/2) into one shape. Padding cost is bounded by "
    "minBucket elements per small dimension.", validator=_positive)
COMPILE_SHAPE_BUCKETS_GROWTH = register(
    "spark.rapids.tpu.compile.shapeBuckets.growth", float, 2.0,
    "Growth factor between coarse secondary-dimension buckets above the "
    "floor. 2.0 keeps a power-of-two ladder; 4.0 halves the number of "
    "shapes again at the cost of up to 4x padding on those dimensions.",
    validator=_fraction(1.1, 16.0))

# --- shuffle transport (ref RapidsConf.scala:520-601) ----------------------
SHUFFLE_FETCH_RETRIES = register(
    "spark.rapids.shuffle.maxFetchRetries", int, 3,
    "Bounded retries PER PEER GROUP when a shuffle fetch fails over the "
    "transport before the error propagates: a failure re-fetches only "
    "that peer's blocks (the in-process analogue of the reference "
    "mapping transport errors into Spark's stage retry).")

SHUFFLE_TRANSPORT_ENABLED = register(
    "spark.rapids.shuffle.transport.enabled", _to_bool, False,
    "Enable the accelerated shuffle manager: shuffle blocks stay in device "
    "memory (spilling through the store framework) and move between workers "
    "over the mesh interconnect instead of the host serializer path.")

SHUFFLE_TRANSPORT_CLASS = register(
    "spark.rapids.shuffle.transport.class", str, "inprocess",
    "Transport implementation for the accelerated shuffle manager: "
    "'inprocess' (direct-call, single process) or 'socket' (real TCP "
    "loopback framing — the wire path the reference runs over UCX, "
    "UCXShuffleTransport.scala). The SPI accepts other implementations "
    "by class path.")

SHUFFLE_EXECUTORS = register(
    "spark.rapids.shuffle.executors", int, 1,
    "Number of simulated executors for the accelerated shuffle manager: "
    "map tasks stripe across this many ShuffleEnvs (each with its own "
    "transport endpoint and server), so reduce-side fetches of other "
    "executors' blocks traverse the full serializer->server->client wire "
    "path instead of the local catalog.", validator=_positive)

SHUFFLE_MAX_INFLIGHT = register(
    "spark.rapids.shuffle.maxMetadataFetchesInFlight", int, 128,
    "Bound on simultaneous in-flight shuffle fetches per task.",
    validator=_positive)

SHUFFLE_BOUNCE_BUFFER_SIZE = register(
    "spark.rapids.shuffle.bounceBuffers.size", _to_bytes, 4 << 20,
    "Size of each staging (bounce) buffer used when moving shuffle data "
    "between tiers or peers.")

SHUFFLE_BOUNCE_BUFFER_COUNT = register(
    "spark.rapids.shuffle.bounceBuffers.count", int, 16,
    "Number of staging buffers per direction.", validator=_positive)

SHUFFLE_TRANSPORT_MODE = register(
    "spark.rapids.tpu.shuffle.transport.mode", str, "legacy",
    "Per-edge shuffle transport selection (shuffle/manager.py "
    "ShuffleTransportKind). 'legacy' (default) reproduces the historical "
    "selection byte-identically: a configured device mesh routes "
    "hash/range (and device-count roundrobin) exchanges over the ICI "
    "mesh collective, spark.rapids.shuffle.transport.enabled routes them "
    "through the catalog+transport shuffle manager (inprocess/socket "
    "wire), everything else collapses locally. 'auto' picks per edge: "
    "in-slice edges (a mesh is configured and the partitioning is mesh-"
    "compatible) ride ICI, cross-host edges (a multi-executor transport "
    "pool is configured) ride the socket/DCN manager path, the rest stay "
    "local. 'ici' forces the mesh collective for every compatible edge "
    "(local fallback without a mesh); 'manager' forces the shuffle-"
    "manager wire path; 'local' forces single-process collapse — the "
    "rollback switch.",
    validator=(lambda v: None if str(v) in
               ("legacy", "auto", "ici", "manager", "local")
               else f"must be one of legacy|auto|ici|manager|local, "
                    f"got {v}"))

# --- file formats (the reference's RapidsConf.scala:433-474) ------------
PARQUET_ENABLED = register(
    "spark.rapids.sql.format.parquet.enabled", _to_bool, True,
    "Enable Parquet input/output acceleration.")
PARQUET_READ_ENABLED = register(
    "spark.rapids.sql.format.parquet.read.enabled", _to_bool, True,
    "Enable accelerated Parquet scans.")
PARQUET_WRITE_ENABLED = register(
    "spark.rapids.sql.format.parquet.write.enabled", _to_bool, True,
    "Enable accelerated Parquet writes.")
CSV_ENABLED = register(
    "spark.rapids.sql.format.csv.enabled", _to_bool, True,
    "Enable CSV input acceleration.")
CSV_READ_ENABLED = register(
    "spark.rapids.sql.format.csv.read.enabled", _to_bool, True,
    "Enable accelerated CSV scans.")
ORC_ENABLED = register(
    "spark.rapids.sql.format.orc.enabled", _to_bool, True,
    "Enable ORC input/output acceleration.")
ORC_READ_ENABLED = register(
    "spark.rapids.sql.format.orc.read.enabled", _to_bool, True,
    "Enable accelerated ORC scans.")
ORC_WRITE_ENABLED = register(
    "spark.rapids.sql.format.orc.write.enabled", _to_bool, True,
    "Enable accelerated ORC writes.")

# --- the encoded-page cache (memory/spill.EncodedPageCache) --------------
SCAN_PAGE_CACHE = register(
    "spark.rapids.sql.scan.pageCache.enabled", _to_bool, True,
    "Encoded-page cache of the device Parquet scan: column-chunk decode "
    "plans (run tables + encoded page bytes) cached by (path, file stamp, "
    "row group, column), so a hot table decodes again from cached, and "
    "within the device budget device-resident, pages instead of reading "
    "and uploading them again. Encoded pages are several times smaller "
    "than decoded columns.")
SCAN_PAGE_CACHE_BYTES = register(
    "spark.rapids.sql.scan.pageCache.maxBytes", _to_bytes, 256 << 20,
    "Host-memory budget of the encoded-page cache (LRU past it).")
SCAN_PAGE_CACHE_DEVICE_BYTES = register(
    "spark.rapids.sql.scan.pageCache.deviceMaxBytes", _to_bytes, 64 << 20,
    "Device budget of page-cache entries promoted to device residency "
    "after their first upload; colder entries demote to the host tier "
    "(their device bytes dropped, the host plan kept). Metered against the "
    "session's device budget, and dropped, not spilled, under its "
    "pressure.")

# --- memory pool and spill (the JAX package's defaults and converters) ----
ALLOC_FRACTION = register(
    "spark.rapids.memory.tpu.allocFraction", float, 0.9,
    "Fraction of the device's memory the framework budgets for columnar "
    "buffers (memory/device.py): on a CUDA device of "
    "torch.cuda.mem_get_info()'s total, on the CPU of 16 GiB. The device "
    "store spills to host once the budget is exceeded.")
HOST_SPILL_STORAGE_SIZE = register(
    "spark.rapids.memory.host.spillStorageSize", _to_bytes, 1 << 30,
    "Amount of host memory used to cache spilled device buffers before "
    "spilling them further to disk (the host arena: pinned memory for a "
    "CUDA session, plain memory for a CPU one).")
SPILL_DIR = register(
    "spark.rapids.memory.spill.diskDir", str, "",
    "Directory under which each session's disk tier makes a fresh "
    "directory of its own for its spill files (one .npz a buffer), "
    "removed at stop(); empty (the default): the system's temporary "
    "directory. Not a key of the JAX package, whose store always takes a "
    "temporary one.")
CONCURRENT_TPU_TASKS = register(
    "spark.rapids.sql.concurrentTpuTasks", int, 1,
    "Number of concurrent tasks admitted to the device at once (the "
    "GpuSemaphore admission model, memory/semaphore.py).")
OOC_ENABLED = register(
    "spark.rapids.tpu.outOfCore.enabled", _to_bool, False,
    "Out-of-core execution for join/aggregate/sort (exec/outofcore.py): "
    "when an operator's measured device working set exceeds the "
    "working-set budget (spark.rapids.tpu.outOfCore.partitionBytes), its "
    "input is hash- (for sort, range-) partitioned into spillable fan-out "
    "buckets on the 3-tier store (device -> host -> disk, memory/spill.py) "
    "and processed one bucket at a time: grace hash join, external merge "
    "sort, per-bucket aggregate merges. false (default) keeps every "
    "operator's in-memory path as it is.")
OOC_PARTITION_BYTES = register(
    "spark.rapids.tpu.outOfCore.partitionBytes", _to_bytes, 0,
    "Working-set budget of one out-of-core operator: partitioning fans "
    "out until each bucket is expected to fit in this many bytes, and "
    "the device store is synchronously spilled down to it while buckets "
    "accumulate. 0 (default) = half the metered device budget.")
OOC_FANOUT = register(
    "spark.rapids.tpu.outOfCore.fanout", int, 0,
    "Fixed fan-out (bucket count) for out-of-core partitioning. 0 "
    "(default) = from measured sizes: the next power of two of "
    "total_bytes / partitionBytes, clamped to [2, 64].")
OOC_MAX_RECURSION = register(
    "spark.rapids.tpu.outOfCore.maxRecursion", int, 3,
    "Grace hash join recursion bound: a bucket whose build fragment still "
    "exceeds the working-set budget is re-partitioned with a different "
    "hash up to this many levels; past it the fragment joins in one "
    "pass.")


# --- observability (obs/: metrics, tracing, the event journal, the host-sync
# ledger; the JAX package's keys, defaults and help) -------------------------
METRICS_ENABLED = register(
    "spark.rapids.sql.metrics.enabled", _to_bool, True,
    "Collect per-operator SQL metrics (rows/batches/time; the reference's "
    "GpuMetricNames, GpuExec.scala:24-41) and per-query profile reports "
    "(session.profile_report()). Disabling removes every timer from the "
    "batch hot path. Profiler trace ranges are separate: see the "
    "spark.rapids.tpu.trace.* keys.")
PROFILE_SYNC_EACH_OP = register(
    "spark.rapids.sql.profile.syncEachOp", _to_bool, False,
    "Wait for the device after every operator's batch (a counted "
    "profile.syncEachOp sync that reads the batch's row count), so each "
    "operator's time holds its own device work and the profile report "
    "splits it into device, transfer and dispatch seconds. Without it "
    "CUDA launches are asynchronous and an operator's time is its host "
    "dispatch. A profiling mode: it adds one host sync per operator per "
    "batch.")
TRACE_ENABLED = register(
    "spark.rapids.tpu.trace.enabled", _to_bool, False,
    "Collect structured tracer spans (exec operators, scan uploads and "
    "decodes, prefetch stalls, spill tier transitions, semaphore waits, "
    "host syncs, kernel builds) during query execution. Implied by a "
    "non-empty spark.rapids.tpu.trace.path. The NVTX-range analogue "
    "(NvtxWithMetrics.scala:17-44).")
TRACE_PATH = register(
    "spark.rapids.tpu.trace.path", str, "",
    "When set, every query execution exports its spans as Chrome "
    "trace-event JSON to this file (overwritten per query), viewable in "
    "Perfetto (ui.perfetto.dev) or chrome://tracing. Setting a path "
    "enables tracing.")
TRACE_NVTX = register(
    "spark.rapids.tpu.trace.nvtx", _to_bool, False,
    "Mirror tracer spans into NVTX ranges (torch.cuda.nvtx.range_push/"
    "range_pop, popped on an exception too) so they appear in a captured "
    "CUDA profiler timeline beside the kernels: the counterpart of the JAX "
    "package's spark.rapids.tpu.trace.jaxAnnotations. Needs a CUDA device: "
    "a query of a session without one raises. Off by default: a range "
    "costs a call per span.")
EVENT_LOG_ENABLED = register(
    "spark.rapids.tpu.eventLog.enabled", _to_bool, False,
    "Write the process-wide structured event journal (obs/events.py): "
    "query start/end with conf fingerprint and plan digest, per-operator "
    "CPU-fallback reasons, spill/memory-pressure events, scan-pipeline "
    "stalls, device-decode fallbacks and host syncs, as line-delimited "
    "JSON. Implied by a non-empty spark.rapids.tpu.eventLog.path.")
EVENT_LOG_PATH = register(
    "spark.rapids.tpu.eventLog.path", str, "",
    "Destination of the event journal (appended, rotated at "
    "spark.rapids.tpu.eventLog.maxFileBytes). Setting a path enables the "
    "journal; enabled with no path writes ./tpu-eventlog.jsonl.")
EVENT_LOG_MAX_BYTES = register(
    "spark.rapids.tpu.eventLog.maxFileBytes", _to_bytes, 16 << 20,
    "Size bound of the active event-log file; past it the file rotates "
    "to <path>.1 (older rotations shift up). Rotation and write-failure "
    "counts surface in the profile report's observability section.")
EVENT_LOG_ROTATIONS = register(
    "spark.rapids.tpu.eventLog.rotatedFiles", int, 2,
    "How many rotated event-log files (<path>.1 .. <path>.N) to keep; "
    "0 truncates in place at the size bound instead of rotating.")
FLIGHT_RECORDER_SIZE = register(
    "spark.rapids.tpu.eventLog.flightRecorderSize", int, 256,
    "Entries in the always-on flight-recorder ring (last N events, plus "
    "spans while tracing is on), auto-dumped into the event log when a "
    "query fails and exposed as session.dump_flight_recorder(). The ring "
    "runs even with the event log and tracer disabled - one deque append "
    "per (rare) event.")
EVENT_LOG_COMPRESS = register(
    "spark.rapids.tpu.eventLog.compress", _to_bool, False,
    "Gzip-compress rotated event-log segments: at the size bound the "
    "active file compresses to <path>.1.gz instead of renaming to "
    "<path>.1 (the active file stays plaintext so appends never pay "
    "per-event compression). tools/trace_summary.py reads both.")
SYNC_LEDGER_ENABLED = register(
    "spark.rapids.tpu.sync.ledger.enabled", _to_bool, True,
    "Record every device<->host blocking point (uploads, fetches, row "
    "counts, join totals, out-of-core working-set measurement, semaphore "
    "waits) in the process-wide host-sync ledger (obs/syncledger.py): "
    "sync site, wall seconds, bytes moved, triggering plan operator, "
    "query and thread, in a bounded in-memory ring. Feeds the profile "
    "report's 'syncs' section and device-occupancy estimate, hostSync "
    "journal events, the sync track in the Chrome trace export and "
    "flight-recorder failure dumps. On by default: syncs are the "
    "expensive operation being measured, so the bookkeeping is noise "
    "next to the blocked wall time it accounts.")
SYNC_LEDGER_MAX_ENTRIES = register(
    "spark.rapids.tpu.sync.ledger.maxEntries", int, 4096,
    "Entries kept in the host-sync ledger's bounded ring (oldest "
    "evicted first).")
SYNC_LEDGER_EVENT_MIN_SECONDS = register(
    "spark.rapids.tpu.sync.ledger.eventMinSeconds", float, 0.0,
    "Minimum blocked seconds before a sync also lands as a hostSync "
    "journal event (the ledger entry records it regardless). 0 journals "
    "every sync.")
DEBUG_TRANSFER_GUARD = register(
    "spark.rapids.tpu.debug.transferGuard", str, "off",
    "Coverage audit for the host-sync ledger: run a query's body under "
    "PyTorch's CUDA sync debug mode. 'log' (mode \"warn\") warns on every "
    "host wait for the device that happens OUTSIDE a sync_scope; "
    "'disallow' (mode \"error\") raises on it (sync scopes lift the mode, "
    "so every tracked site passes). Off by default - a debugging "
    "instrument, not a production conf. It has no effect on a CPU "
    "device, where no host wait exists to catch.")

# --- the live monitor (obs/monitor.py) --------------------------------------
UI_ENABLED = register(
    "spark.rapids.tpu.ui.enabled", _to_bool, False,
    "Serve the embedded live monitor (obs/monitor.py): GET /metrics (the "
    "process registry in Prometheus text format), /healthz, /api/status "
    "(the card's name and memory, the device budget, the spill catalog's "
    "tiers, semaphore permits, the journal's drop counts, the pre-warm "
    "and the shared compile cache), /api/queries and /api/query/<id> "
    "(live per-query progress), /api/tenants, /api/scheduler, /api/fleet "
    "and an HTML live view at /. false (default): no server thread, and "
    "the progress heartbeats stay off.")
UI_PORT = register(
    "spark.rapids.tpu.ui.port", int, 4040,
    "TCP port of the live monitor; 0 binds an ephemeral port (its bound "
    "port is obs.monitor.server().port). A bind failure warns once and "
    "leaves the monitor off instead of failing queries.",
    validator=_non_negative)
UI_HOST = register(
    "spark.rapids.tpu.ui.host", str, "127.0.0.1",
    "Bind address of the live monitor (loopback by default; the service "
    "is read-only and unauthenticated).")
UI_RECENT_QUERIES = register(
    "spark.rapids.tpu.ui.recentQueries", int, 64,
    "Finished queries /api/queries keeps beside the in-flight ones (a "
    "bounded ring, oldest evicted first).", validator=_positive)
UI_SIGNAL_DIAGNOSTICS = register(
    "spark.rapids.tpu.ui.signalDiagnostics", _to_bool, True,
    "Install a SIGUSR1 handler at session creation that dumps the flight "
    "recorder, every thread's stack and the in-flight queries' progress "
    "into the journal (kill -USR1 <pid>). Main-thread sessions only; an "
    "application's own SIGUSR1 handler is never replaced.")

# --- the nvcc compile cache and the pre-warm (obs/compilecache.py,
# serving/prewarm.py) --------------------------------------------------------
COMPILE_SHARED_CACHE_DIR = register(
    "spark.rapids.tpu.compile.sharedCache.dir", str, "",
    "Directory the CUDA libraries are built into and loaded from, shared "
    "by processes (obs/compilecache.py): each library builds under an "
    "flock of its own, so of two processes one runs nvcc and the other "
    "waits and loads its library; every nvcc run appends a record to "
    "<dir>/manifest.jsonl. Counters compileCache.* (nvcc runs and "
    "seconds, libraries found or not, the build seconds a found library "
    "saved, load seconds) and sharedCache.* (a steal is a library another "
    "process built). Empty (default): the package's own build directory.")
COMPILE_SHARED_CACHE_MIN_S = register(
    "spark.rapids.tpu.compile.sharedCache.minCompileSeconds", float, 0.0,
    "The JAX package's floor of compile seconds before an executable is "
    "kept; the port keeps every library it builds, so this key is read "
    "and has no effect.", validator=_non_negative)
COMPILE_AOT_MANIFEST = register(
    "spark.rapids.tpu.compile.aot.manifest", str, "",
    "Path of a pre-warm manifest (serving/prewarm.py; the fleet's warm "
    "manifest is one): the kernel wrappers' recorded first launches, each "
    "with its library and a replayable argument spec (utils/argspec.py). "
    "When set, the session starts a background pass that loads every "
    "manifested library (building it where missing) and replays each "
    "replayable launch once on zero-filled, all-invalid inputs, paying "
    "the first-launch costs (the nvcc build or load, CUDA's lazy module "
    "load, the caching allocator's first segments) before traffic. "
    "Cancellable, capped by compile.aot.budgetSeconds; warmed, skipped "
    "and pending at /api/status and as aot.* counters. Empty (default) "
    "disables.")
COMPILE_AOT_BUDGET = register(
    "spark.rapids.tpu.compile.aot.budgetSeconds", float, 120.0,
    "Wall budget of the pre-warm pass; what is left when it is spent "
    "stays pending and warms on first use. 0 disables the cap.",
    validator=_non_negative)

# --- concurrent serving (serving/) ------------------------------------------
SERVING_WORKERS = register(
    "spark.rapids.tpu.serving.workers", int, 4,
    "Worker threads of the admission scheduler (serving/scheduler.py): "
    "how many queries run at once. The device admission is bounded "
    "apart by spark.rapids.sql.concurrentTpuTasks and the tenant "
    "budgets.", validator=_positive)
SERVING_MAX_QUEUED = register(
    "spark.rapids.tpu.serving.maxQueuedQueries", int, 128,
    "Bound on the jobs queued over all tenant lanes; a submission past it "
    "is shed at once (status 'shed', a queryShed event, serving.shed).",
    validator=_positive)
SERVING_DEFAULT_DEADLINE = register(
    "spark.rapids.tpu.serving.defaultDeadlineSeconds", float, 0.0,
    "Default deadline of a scheduled job, counted from submission; 0 "
    "disables. A job still queued past it never starts; a running one "
    "stops at its next batch pull (a queryTimeout event with the flight "
    "recorder's tail). A job's deadline_s overrides it.",
    validator=_non_negative)
SERVING_TENANT_DEFAULT_PERMITS = register(
    "spark.rapids.tpu.serving.tenant.defaultPermits", int, 0,
    "Default per-tenant budget of task semaphore permits, so that one "
    "tenant cannot hold every concurrentTpuTasks slot; 0 = the global "
    "limit only. Per tenant: spark.rapids.tpu.serving.tenant.<name>"
    ".permits.", validator=_non_negative)
SERVING_TENANT_DEFAULT_WEIGHT = register(
    "spark.rapids.tpu.serving.tenant.defaultWeight", float, 1.0,
    "Default weighted-fair share of a tenant's lane: the scheduler serves "
    "the non-empty lane with the least virtual time and advances it by "
    "1/weight. Per tenant: spark.rapids.tpu.serving.tenant.<name>"
    ".weight.", validator=_positive)
SERVING_PLAN_CACHE = register(
    "spark.rapids.tpu.serving.planCache.enabled", _to_bool, True,
    "Cross-query plan cache (serving/caches.py): a repeat of the same CPU "
    "plan under the same explicit conf over the same source versions "
    "(file stamps, in-memory data ids) skips the tag and convert pass and "
    "runs a clone of the cached physical plan (a planCacheHit event). A "
    "conf change or a rewritten table misses. Adaptive queries are "
    "planned per stage and never cached (see exchangeReuse).")
SERVING_PLAN_CACHE_MAX = register(
    "spark.rapids.tpu.serving.planCache.maxEntries", int, 256,
    "LRU entry bound of the plan cache.", validator=_positive)
SERVING_RESULT_CACHE = register(
    "spark.rapids.tpu.serving.resultCache.enabled", _to_bool, False,
    "Opt-in cross-query result cache: a repeat under the same key "
    "answers from the cached host frames with no execution (a "
    "resultCacheHit event). Deterministic plans that write nothing only; "
    "hits return copies.")
SERVING_RESULT_CACHE_MAX = register(
    "spark.rapids.tpu.serving.resultCache.maxEntries", int, 64,
    "LRU entry bound of the result cache.", validator=_positive)
SERVING_RESULT_CACHE_MAX_BYTES = register(
    "spark.rapids.tpu.serving.resultCache.maxBytes", _to_bytes, 256 << 20,
    "Byte bound of the result cache (pandas deep memory of the frames).",
    validator=_positive)
SERVING_EXCHANGE_REUSE = register(
    "spark.rapids.tpu.serving.exchangeReuse.enabled", _to_bool, False,
    "Opt-in cross-query AQE exchange reuse: an adaptive query whose "
    "exchange subtree (structure, source versions, conf) matches a "
    "materialized stage adopts its map output and statistics (an "
    "aqeExchangeReuse event). Stages are reference-counted. Needs "
    "spark.rapids.sql.adaptive.enabled.")
SERVING_EXCHANGE_REUSE_MAX_BYTES = register(
    "spark.rapids.tpu.serving.exchangeReuse.maxBytes", _to_bytes,
    256 << 20,
    "Byte bound of the stage output kept for exchange reuse (oldest "
    "evicted first).", validator=_positive)

# --- the fleet (serving/fleet/) ---------------------------------------------
FLEET_WORKERS = register(
    "spark.rapids.tpu.fleet.workers", int, 0,
    "Worker processes of the fleet tier (serving/fleet/): a router "
    "spreads tenants over this many worker processes, each a whole "
    "session from the shared conf. 0 (default): no fleet; the fleet "
    "package is never imported.", validator=_non_negative)
FLEET_DIR = register(
    "spark.rapids.tpu.fleet.dir", str, "",
    "The fleet's shared directory: the nvcc build directory in "
    "<dir>/compilecache, the warm manifest (the pre-warm source of a "
    "rolling restart) in <dir>/warm.jsonl, per-replica journals in "
    "<dir>/events-<replica>.jsonl and the workers' spec files.")
FLEET_SPILLOVER_DEPTH = register(
    "spark.rapids.tpu.fleet.spillover.queueDepth", int, 4,
    "Queue depth at which the router sends a tenant's submission to the "
    "least-loaded replica instead of its sticky one (placement reason "
    "'spillover', a fleetPlacement event).", validator=_positive)
FLEET_PLACEMENT_OVERRIDES = register(
    "spark.rapids.tpu.fleet.placement.overrides", str, "",
    "Tenant -> replica pins over the consistent-hash ring, as "
    "'tenantA=r0,tenantB=r2'. A pinned tenant still spills over and is "
    "re-placed when its replica is lost or draining.")
FLEET_ROUTER_HOST = register(
    "spark.rapids.tpu.fleet.router.host", str, "127.0.0.1",
    "Bind host of the router's HTTP endpoint (/api/fleet, /metrics, "
    "/healthz).")
FLEET_ROUTER_PORT = register(
    "spark.rapids.tpu.fleet.router.port", int, 0,
    "TCP port of the router's HTTP endpoint; 0 (default) binds an "
    "ephemeral port (FleetMonitor.url).", validator=_non_negative)
FLEET_WARM_MANIFEST = register(
    "spark.rapids.tpu.fleet.warmManifest", str, "",
    "Path of the fleet's warm manifest: each kernel wrapper's first "
    "launch of a signature in a process appends one flock-serialized "
    "JSONL record (wrapper, library, argument spec; obs/compilecache.py). "
    "It is a spark.rapids.tpu.compile.aot.manifest as it stands, so a "
    "rolling restart's replacement replays it before taking traffic. "
    "Empty (default) disables the recording.")
FLEET_DRAIN_TIMEOUT = register(
    "spark.rapids.tpu.fleet.restart.drainTimeoutSeconds", float, 60.0,
    "Rolling restart: how long the quiesced worker's in-flight jobs may "
    "run before the swap goes on anyway.", validator=_non_negative)
FLEET_READY_TIMEOUT = register(
    "spark.rapids.tpu.fleet.prewarm.readyTimeoutSeconds", float, 120.0,
    "Rolling restart: how long to wait for the replacement's pre-warm "
    "before it takes traffic (the workerReady event records its state "
    "either way).", validator=_non_negative)
FLEET_WORKER_START_TIMEOUT = register(
    "spark.rapids.tpu.fleet.worker.startTimeoutSeconds", float, 120.0,
    "How long the router waits for a spawned worker's ready line (its "
    "session boot included).", validator=_positive)


# --- the rest of the JAX package's keys (A.11b) ----------------------------
# the JAX package's constant names for three keys registered above
AGG_FUSE_COUNT_DISTINCT = FUSE_COUNT_DISTINCT
ENABLE_CAST_STRING_TO_NUMERIC = CAST_STRING_TO_INTEGER
ENABLE_CAST_STRING_TO_DATE = CAST_STRING_TO_DATE

REUSE_SUBTREES = register(
    "spark.rapids.sql.reuseSubtrees.enabled", _to_bool, True,
    "Within-query reuse of identical deterministic subtrees (the "
    "ReuseExchange analogue, exec/reuse.py): branches referencing the "
    "same joined/aggregated intermediate (scalar-subquery thresholds, "
    "self-join views) materialize it once and replay the batches.")
AGG_RUNTIME_SKIP = register(
    "spark.rapids.sql.agg.runtimeSkip", _to_bool, True,
    "Runtime decision for the partial-aggregation skip: the partial pass "
    "measures output_groups/input_rows per batch and flips to passthrough "
    "mid-stream once the cumulative measured ratio exceeds "
    "spark.rapids.sql.agg.skipAggPassReductionRatio; each decision is "
    "journaled (aggSkipDecision) and seeds the session cache. false "
    "restores the first-batch-only heuristic.")
HBM_DEBUG = register(
    "spark.rapids.memory.tpu.debug", _to_bool, False,
    "If true, log every device-store allocation/free for leak hunting: "
    "the leak tracker (memory/leak.py) keeps each live buffer's creation "
    "stack.")
PINNED_POOL_SIZE = register(
    "spark.rapids.memory.pinnedPool.size", _to_bytes, 0,
    "Size of the aligned host staging pool used for device transfers. 0 "
    "disables pooling and allocates on demand. (Read nowhere, as in the "
    "JAX package: the pinned host memory is the spill arena of "
    "spark.rapids.memory.host.spillStorageSize.)")
MAX_READER_BATCH_SIZE_ROWS = register(
    "spark.rapids.sql.reader.batchSizeRows", int, 1 << 21,
    "Maximum rows a file reader materializes per batch. (Read nowhere, "
    "as in the JAX package: a file split is one row group or stripe.)",
    validator=_positive)
INCOMPATIBLE_OPS = register(
    "spark.rapids.sql.incompatibleOps.enabled", _to_bool, False,
    "Enable operators that produce results that differ from standard CPU "
    "semantics in corner cases (e.g. float aggregation ordering).")
IMPROVED_FLOAT_OPS = register(
    "spark.rapids.sql.improvedFloatOps.enabled", _to_bool, False,
    "Use device-optimized float operations that may not be bit-identical "
    "to the CPU implementations. (Read nowhere, as in the JAX package.)")
ALLOW_FLOAT32_EXEC = register(
    "spark.rapids.sql.fast32BitFloat.enabled", _to_bool, False,
    "Execute float64 expressions in float32 on the device for speed. "
    "Results are approximate; off by default. (Read nowhere, as in the "
    "JAX package.)")
HAS_NANS = register(
    "spark.rapids.sql.hasNans", _to_bool, True,
    "If float data may contain NaN; some ops tag themselves off the "
    "device when NaNs are possible and the kernel cannot match CPU NaN "
    "semantics. (Read nowhere, as in the JAX package: no operator of "
    "either package tags on it.)")
ENABLE_CAST_STRING_TO_FLOAT = register(
    "spark.rapids.sql.castStringToFloat.enabled", _to_bool, False,
    "Enable casting strings to floating point on the device. (Read "
    "nowhere, as in the JAX package: the cast stays on the CPU.)")
ENABLE_CAST_FLOAT_TO_STRING = register(
    "spark.rapids.sql.castFloatToString.enabled", _to_bool, False,
    "Enable casting floating point to strings on the device; formatting "
    "differs from Java's in corner cases. (Read nowhere, as in the JAX "
    "package: the cast stays on the CPU.)")
SCAN_PREFETCH_DEPTH = register(
    "spark.rapids.sql.scan.prefetchDepth", int, 2,
    "How many scan splits (Parquet row groups, ORC stripes, CSV files) "
    "may be planned on the shared host pool ahead of the consuming task, "
    "overlapping host planning with the device decode "
    "(sql/scan_pipeline.py). 0 selects the serial reader: each split is "
    "planned on the consuming thread when it is pulled.",
    validator=_non_negative)
SCAN_DECODE_THREADS = register(
    "spark.rapids.sql.scan.decodeThreads", int, 0,
    "Worker threads in the process-wide scan planning pool. 0 = auto: "
    "min(4, max(2, cpu_count - 1)), leaving a core for the consuming "
    "task thread.",
    validator=_non_negative)
SCAN_PREFETCH_MAX_BYTES = register(
    "spark.rapids.sql.scan.prefetchMaxBytes", _to_bytes, 256 << 20,
    "Host-memory budget for planned-but-unconsumed prefetched splits "
    "across one scan; submission stalls past it (clamped to "
    "spark.rapids.memory.host.spillStorageSize).")
DICT_ENABLED = register(
    "spark.rapids.sql.dict.enabled", _to_bool, True,
    "Dictionary-encode low-cardinality columns at a pandas upload and "
    "carry the codes through filter/join/agg/sort/exchange, decoding to "
    "chars only at collect()/write. false uploads no dictionary and no "
    "char slab: every string column goes as plain offsets and chars. "
    "(The device Parquet decode keeps its dictionary pages' codes, as "
    "the JAX package's deviceDecode does.)")
DICT_MERGE_EXCHANGE = register(
    "spark.rapids.sql.dict.mergeOnExchange", _to_bool, True,
    "When batches with DIFFERENT dictionaries for the same column meet at "
    "an exchange/concat boundary, union the (static, host-side) "
    "dictionaries and remap each part's codes through an O(cardinality) "
    "table instead of decoding. false decodes at the boundary.")
DICT_HASH_VALUES = register(
    "spark.rapids.sql.dict.hashValues", _to_bool, True,
    "Hash dictionary-encoded string columns for exchange partitioning and "
    "join keys through per-VALUE hash tables (the dictionary's values "
    "hashed once, rows gather by code) instead of the char-scanning "
    "polynomial hashes. Bit-identical hash values by construction. false "
    "recomputes hashes from chars.")
HASH_AGG_REPLACE_MODE = register(
    "spark.rapids.sql.hashAgg.replaceMode", str, "all",
    "Which aggregation modes to replace: 'all', 'partial', or 'final'.")
NUM_TASK_THREADS = register(
    "spark.rapids.sql.taskThreads", int, 4,
    "Host-side worker threads executing partitions (Spark task "
    "equivalent). (Read nowhere, as in the JAX package: partitions drain "
    "on the query's thread.)",
    validator=_positive)
STAGE_FUSION = register(
    "spark.rapids.sql.stageFusion.enabled", _to_bool, True,
    "Trace chains of narrow operators into one compiled unit. (Read "
    "nowhere, as in the JAX package: whole-stage fusion is "
    "spark.rapids.sql.fusion.stageEnabled.)")
EXPORT_COLUMNAR_RDD = register(
    "spark.rapids.sql.exportColumnarRdd", _to_bool, False,
    "Expose query output as device-resident columnar data for ML "
    "frameworks (ml/columnar_rdd.py; the reference's ColumnarRdd "
    "zero-copy export, ColumnarRdd.scala:41-50).")

# Keys the JAX package registers that have no meaning in the port: set,
# they are accepted (TpuConf.set keeps unregistered keys as given) and
# change nothing. Key -> why.
IGNORED_KEYS: Dict[str, str] = {
    "spark.rapids.sql.scan.deviceDecode":
        "the port always decodes Parquet on the card (B5-B8); the host "
        "decode is the CPU scan under spark.rapids.sql.enabled=false",
    "spark.rapids.sql.scan.dictEncodeNumerics":
        "a device-decoded Parquet column keeps its dictionary pages' "
        "codes; the CSV and ORC uploads probe every column, as the JAX "
        "package's serial reader does",
    "spark.rapids.sql.scan.directDecode":
        "a value-identical shortcut of the JAX package's host arrow->"
        "pandas decode; the port's CSV and ORC readers convert through "
        "pyarrow, and Parquet decodes on the card",
    "spark.rapids.sql.smallQuery.enabled":
        "the small-query fast path is left out on purpose (ROADMAP, "
        "A.10): the port's exchanges shrink on every query",
    "spark.rapids.sql.smallQuery.maxRows":
        "the small-query fast path is left out on purpose (ROADMAP, "
        "A.10)",
    "spark.rapids.sql.smallQuery.liteBookkeeping":
        "the small-query fast path is left out on purpose (ROADMAP, "
        "A.10)",
    "spark.rapids.sql.fusion.hashKernels":
        "it chooses between Pallas hash kernels and sort spellings; the "
        "port's joins and fused count distinct always run their hand "
        "kernels (B3, B4) where the key allows, and the union lexsort "
        "for string keys",
    "spark.rapids.sql.collect.fusedFetchBytes":
        "the port's collect reads each batch's row count, then copies "
        "only its live rows; no result is fetched at full capacity",
    "spark.rapids.sql.join.exactLongStrings":
        "the port's string join keys always compare in full (exact "
        "images past 64 bytes, ops/sortops.string_images); false selects "
        "the JAX package's hash tiebreak, which approximates that answer",
    "spark.rapids.tpu.trace.jaxAnnotations":
        "jax.profiler annotations; spark.rapids.tpu.trace.nvtx mirrors "
        "the spans into NVTX ranges instead",
    "spark.rapids.tpu.compileLedger.enabled":
        "the port compiles no XLA program; its one compile is the nvcc "
        "build, which obs/compilecache records",
    "spark.rapids.tpu.compileLedger.maxEntries":
        "the compile ledger is left out (obs/compilecache records the "
        "nvcc build)",
    "spark.rapids.tpu.compileLedger.costAnalysis":
        "XLA cost_analysis has no counterpart; the kernels' bounds are "
        "computed by chip_smoke.py",
}


def conf_entries() -> Dict[str, ConfEntry]:
    """Every registered key's entry."""
    return dict(_REGISTRY)


def help_text() -> str:
    """The configs doc table, as the JAX package's ``help_text`` writes it
    (name | description | default, sorted by key), then the keys of the
    JAX package the port accepts and ignores, with the reason."""
    lines = ["Name | Description | Default", "-----|-------------|--------"]
    for key in sorted(_REGISTRY):
        e = _REGISTRY[key]
        lines.append(f"{e.key} | {e.doc} | {e.default}")
    lines += ["", "Accepted and ignored | Why", "-----|-----"]
    for key in sorted(IGNORED_KEYS):
        lines.append(f"{key} | {IGNORED_KEYS[key]}")
    return "\n".join(lines)


class TpuConf:
    """Settings with typed accessors."""

    def __init__(self, settings: Optional[Dict[str, Any]] = None):
        self._settings: Dict[str, Any] = {}
        for k, v in (settings or {}).items():
            self.set(k, v)

    def set(self, key: str, value: Any) -> "TpuConf":
        entry = _REGISTRY.get(key)
        self._settings[key] = (entry.convert(value) if entry is not None
                               else value)
        return self

    def get(self, key: str, default: Any = None) -> Any:
        if key in self._settings:
            return self._settings[key]
        entry = _REGISTRY.get(key)
        return entry.default if entry is not None else default

    def get_bool(self, key: str, default: bool) -> bool:
        v = self.get(key, default)
        return _to_bool(v) if isinstance(v, str) else bool(v)

    def get_int(self, key: str, default: int) -> int:
        return int(self.get(key, default))

    @property
    def sql_enabled(self) -> bool:
        return self.get(SQL_ENABLED.key)

    @property
    def explain(self) -> str:
        return str(self.get(EXPLAIN.key)).upper()

    @property
    def test_enabled(self) -> bool:
        return self.get(TEST_ENABLED.key)

    @property
    def test_allowed_nontpu(self) -> List[str]:
        raw = str(self.get(TEST_ALLOWED_NONTPU.key) or "")
        return [s.strip() for s in raw.split(",") if s.strip()]

    @property
    def batch_size_rows(self) -> int:
        return self.get(BATCH_SIZE_ROWS.key)

    @property
    def capacity_growth(self) -> float:
        return self.get(CAPACITY_GROWTH.key)

    @property
    def shuffle_partitions(self) -> int:
        return self.get(SHUFFLE_PARTITIONS.key)

    @property
    def alloc_fraction(self) -> float:
        return float(self.get(ALLOC_FRACTION.key))

    @property
    def host_spill_storage_size(self) -> int:
        return int(self.get(HOST_SPILL_STORAGE_SIZE.key))

    @property
    def concurrent_tpu_tasks(self) -> int:
        return int(self.get(CONCURRENT_TPU_TASKS.key))

    @property
    def broadcast_threshold(self) -> int:
        return self.get(BROADCAST_THRESHOLD.key)

    @property
    def adaptive_enabled(self) -> bool:
        return self.get(ADAPTIVE_ENABLED.key)

    @property
    def adaptive_coalesce_enabled(self) -> bool:
        return self.get(ADAPTIVE_COALESCE_ENABLED.key)

    @property
    def adaptive_coalesce_min_size(self) -> int:
        return int(self.get(ADAPTIVE_COALESCE_MIN_SIZE.key))

    @property
    def adaptive_broadcast_enabled(self) -> bool:
        return self.get(ADAPTIVE_BROADCAST_ENABLED.key)

    @property
    def adaptive_skew_enabled(self) -> bool:
        return self.get(ADAPTIVE_SKEW_ENABLED.key)

    @property
    def adaptive_skew_factor(self) -> float:
        return float(self.get(ADAPTIVE_SKEW_FACTOR.key))

    @property
    def adaptive_skew_threshold(self) -> int:
        return int(self.get(ADAPTIVE_SKEW_THRESHOLD.key))

    @property
    def incompatible_ops_enabled(self) -> bool:
        return self.get_bool(INCOMPATIBLE_OPS.key, False)

    @property
    def hash_agg_replace_mode(self) -> str:
        return str(self.get(HASH_AGG_REPLACE_MODE.key))

    def is_operator_enabled(self, key: str, incompat: bool = False,
                            disabled_by_default: bool = False) -> bool:
        """Per-operator enable check with the JAX package's taxonomy
        (spark.rapids.sql.exec.<Name>): a key set wins; else a rule
        disabled by default is off, and an incompatible one is off unless
        spark.rapids.sql.incompatibleOps.enabled."""
        if key in self._settings:
            return self.get_bool(key, True)
        if disabled_by_default:
            return False
        if incompat and not self.incompatible_ops_enabled:
            return False
        return True

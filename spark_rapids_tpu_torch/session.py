"""The session and DataFrame API (counterpart of the JAX package's
``session.py``).

``TpuSparkSession`` plans a DataFrame's logical plan into a CPU physical
plan (``sql/planner.py``), tags and converts it to device operators
(``sql/overrides.py``), runs it and collects the result to pandas:

    s = TpuSparkSession.builder().config("spark.rapids.sql.test.enabled",
                                         True).get_or_create()
    df = s.create_dataframe(frame)
    df.filter(F.col("x") > 1).group_by("k").agg(F.sum("v").alias("sv"))
    ...collect()    # a pandas DataFrame

Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU (``device="cpu"``, as the tests do): the device path then runs
the kernels' plain versions. ``spark.rapids.sql.enabled=false`` runs the
CPU operators on pandas instead. Files come in through ``s.read.parquet``
(files or directories, hive ``key=value`` layouts as partition columns;
decoded on the device, kernels B5-B8, through the session's encoded-page
cache ``page_cache``, ``spark.rapids.sql.scan.pageCache.*``; by pyarrow
on the host where ``spark.rapids.sql.enabled=false``), a filter above a
scan pruning its row groups and directories by the footers' statistics
and the partition values; ``s.read.csv`` and ``s.read.orc`` decode on
the host with pyarrow (``s.read.schema(...).option("header", ...)``). A
DataFrame goes out through ``df.write.mode("overwrite")
.partition_by(...).parquet(path)`` (also ``.orc``, ``.csv``; mode
``error`` by default): device batches copied to the host and encoded by
pyarrow under a commit protocol (``exec/write.py``); a query's metrics
(``last_query_metrics``) hold each scan's pruned row groups and each
write's files, rows, bytes and partitions. ``DataFrame.join`` plans an
equi-join, broadcast under ``spark.rapids.sql.autoBroadcastJoinThreshold``,
a cross join (``on=None``) and a join on a boolean condition
(``on=<Column>``, the broadcast nested-loop join, on the device only where
``spark.rapids.sql.exec.BroadcastNestedLoopJoinExec`` is set true).

The memory runtime (``memory/``) is the JAX package's: each session holds
a device budget meter (``device_manager``, ``allocFraction`` of the card's
memory), the task semaphore (``concurrentTpuTasks``), the spill catalog
(``buffer_catalog``: device -> host arena of ``spillStorageSize`` -> disk)
and the handler that spills it when an allocation passes the budget
(``memory_event_handler``). Cached scan batches, broadcast tables, reused
subtrees and out-of-core buckets live in the catalog; the per-query ones
(``add_transient_batch``) are freed when the query ends, and
``last_query_metrics["memory"]`` holds the query's spills by direction.
``stop()`` closes the catalog. Under ``spark.rapids.tpu.outOfCore.enabled``
the join, aggregate and sort run out of core past
``outOfCore.partitionBytes`` (``exec/outofcore.py``).

Observability is the JAX package's (``obs/``): every query runs in a
journal window (``spark.rapids.tpu.eventLog.*``: queryStart, queryPlan,
cpuFallback, queryEnd, and the flight recorder dumped on a failure;
``dump_flight_recorder()``), a tracer window exported as Chrome JSON
under ``spark.rapids.tpu.trace.path``, the host-sync ledger and the
transfer guard (``spark.rapids.tpu.debug.transferGuard``), a progress
record while ``obs/progress.PROGRESS`` is on, and with metrics on (the
default) a profile report (``profile_report()``, ``profile_json()``;
``spark.rapids.sql.profile.syncEachOp`` for device time per operator);
``set_job_group`` tags queries with a tenant.

The accelerated shuffle manager is the JAX package's: with
``spark.rapids.shuffle.transport.enabled`` the exchanges of a query write
their slices into ``shuffle_envs`` (``spark.rapids.shuffle.executors``
simulated executors, each a transport endpoint, ``inprocess``, ``socket``
or a ``module:Class`` path under ``spark.rapids.shuffle.transport.class``,
and a server, all over the session's ``buffer_catalog``); a query's
shuffles are unregistered when it ends (failed ones too) and ``stop()``
closes the environments (transports shut down, sockets closed).

Adaptive execution is the JAX package's (A.10): capacity speculation
(``spark.rapids.sql.adaptiveCapacity.enabled``, on by default) lets a warm
run of a plan expand its joins into the sizes ``capacity_cache`` holds
from earlier runs, take the exchange's shrink counts from it and group
bounded integer keys densely (``agg.denseKeys``), deferring every check
to ONE counted ``speculation.verify`` fetch at the query's end; a miss
drops and blocklists the entries at fault and re-runs the same physical
plan without speculation (``capacity_spec_reruns``; hits in
``capacity_spec_hits``). ``spark.rapids.sql.adaptive.enabled`` runs the
query stage by stage (``sql/adaptive/executor.py``: coalesced reads,
broadcast demotion, skew splits; ``last_aqe`` holds the last record);
``spark.rapids.sql.fusion.stageEnabled`` fuses project/filter chains
(``exec/stagecompiler``).

Serving is the JAX package's (A.11's serving half, ``serving/``):
``serving_scheduler()`` builds an admission scheduler over the session
(jobs on worker threads, per-tenant weighted-fair lanes, load shed,
deadlines and cooperative cancellation: a cancelled or late query ends
``cancelled``/``timeout`` with a ``queryCancelled``/``queryTimeout``
event carrying the flight recorder's tail); the plan cache
(``spark.rapids.tpu.serving.planCache.enabled``, on by default) skips the
tag and convert pass on a repeat and runs a clone of the cached plan, the
result cache (``...resultCache.enabled``) answers a repeat from its
frames with no launch and no sync, and ``...exchangeReuse.enabled`` lets
an adaptive query adopt another's materialized stage
(``clear_serving_caches()``). At each query start the session points the
nvcc build at ``spark.rapids.tpu.compile.sharedCache.dir``
(``obs/compilecache.py``), starts the pre-warm of
``spark.rapids.tpu.compile.aot.manifest`` (``serving/prewarm.py``) and
the live monitor of ``spark.rapids.tpu.ui.enabled`` (``obs/monitor.py``).

Left out of the JAX package's session, each a later ROADMAP item: the
device mesh (A.9); the small-query fast path; the compile ledger proper.
Unlike the JAX
package's, ``get_or_create`` makes a new session each call (sessions of
the port are independent, each with its own confs, device and memory
runtime); the newest is ``TpuSparkSession.active()``. ``with_column``
and ``select`` take window expressions
(``F.row_number().over(Window.partition_by(...))``); ``with_column``
also takes ``F.explode``/``F.posexplode`` of ``F.split``
(a Generate), and ``rollup``/``cube`` group by grouping sets (an Expand
under the aggregate).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence

import pandas as pd
import torch

from spark_rapids_tpu_torch.columnar.batch import DeviceBatch, Schema
from spark_rapids_tpu_torch.config.conf import (
    DEBUG_TRANSFER_GUARD, FUSE_COUNT_DISTINCT, SPILL_DIR, TRACE_ENABLED,
    TRACE_NVTX, TRACE_PATH, TpuConf,
)
from spark_rapids_tpu_torch.exec.base import ExecContext
from spark_rapids_tpu_torch.exec.cpu import concat_host_frames
from spark_rapids_tpu_torch.sql import plan as lp
from spark_rapids_tpu_torch.sql.exprs.aggregates import find_aggregates
from spark_rapids_tpu_torch.sql.exprs.core import Alias, Col, Expression
from spark_rapids_tpu_torch.sql.functions import Column, SortOrder, _c, _expr
from spark_rapids_tpu_torch.sql.functions import col as col_fn
from spark_rapids_tpu_torch.sql.planner import Planner
from spark_rapids_tpu_torch.sql.sources import (
    CsvSource, InMemorySource, OrcSource, ParquetSource,
)

_SPILL_DIRECTIONS = ("device_to_host", "host_to_disk")


class OrderedSet:
    """Insertion-ordered set (dict-backed), so the size sweep evicts
    oldest first: an arbitrary ``set.pop()`` could drop a hot entry or
    re-enable a blocklisted speculation key."""

    def __init__(self):
        self._d: dict = {}

    def add(self, k) -> None:
        self._d[k] = True

    def __contains__(self, k) -> bool:
        return k in self._d

    def __len__(self) -> int:
        return len(self._d)

    def pop_oldest(self) -> None:
        del self._d[next(iter(self._d))]


class LruDict(dict):
    """dict whose reads move the key to the end, so the size sweep's
    oldest-first eviction approximates LRU instead of FIFO (a stable hot
    query set inserted early outlives churned dead keys)."""

    def get(self, k, default=None):
        try:
            return self[k]
        except KeyError:
            return default

    def __getitem__(self, k):
        v = super().__getitem__(k)
        if next(reversed(self)) != k:
            super().__delitem__(k)
            super().__setitem__(k, v)
        return v

# join type aliases of DataFrame.join
_JOIN_ALIASES = {"outer": "full", "full_outer": "full", "left_outer": "left",
                 "right_outer": "right", "semi": "leftsemi",
                 "anti": "leftanti"}


class TpuSparkSession:
    """Entry point: confs, data sources and query execution."""

    _active: Optional["TpuSparkSession"] = None

    def __init__(self, conf: TpuConf, device="cuda"):
        self.conf = conf
        self._base_settings = dict(conf._settings)
        self.device = device
        # the device scan cache (spark.rapids.sql.cacheDeviceScans)
        self.device_scan_cache: Dict = {}
        # each partial aggregate's measured reduction ratio, by plan
        # fingerprint (the runtime partial-aggregation skip)
        self.agg_ratio_cache: LruDict = LruDict()
        # adaptive capacity speculation (spark.rapids.sql.adaptiveCapacity
        # .enabled): data-stamped plan fingerprint -> the join expansion
        # sizes and exchange shrink counts an execution observed; later
        # executions skip those syncs and verify in one deferred fetch
        # (_verify_speculation). Reruns count verification misses (each
        # re-executed without speculation), hits the speculated sites.
        self.capacity_cache: LruDict = LruDict()
        self.capacity_spec_reruns = 0
        self.capacity_spec_hits = 0
        # speculation keys that failed verification and must not retry
        # ("nocache|" prefix: dense grouping keys, whose chronically stale
        # stats would otherwise re-execute every run)
        self.capacity_spec_blocklist: OrderedSet = OrderedSet()
        # plan fingerprints that have executed once: dense grouping only
        # engages from a plan's second execution
        self.dense_plans_seen: OrderedSet = OrderedSet()
        # the last adaptive (AQE) query's record: stage count, rule
        # decisions, final plan tree (sql/adaptive/executor.py)
        self.last_aqe: Optional[dict] = None
        # scanned integer columns' (min, max), unioned over every scanned
        # batch of that name: advisory bounds the dense join sizes its
        # table from and verifies on the device (exec/tpujoin.py)
        self.column_stats: Dict[str, tuple] = {}
        # alias -> {source column names} of rename-only projections, so
        # the statistics resolve through ``.alias(...)``
        self.column_aliases: Dict[str, set] = {}
        # the memory runtime: cached scan batches register in the catalog,
        # and a metered allocation past the budget spills them device ->
        # host -> disk (GpuShuffleEnv.initStorage +
        # DeviceMemoryEventHandler.scala:65-89)
        from spark_rapids_tpu_torch.memory.device import TpuDeviceManager
        from spark_rapids_tpu_torch.memory.semaphore import TpuSemaphore
        from spark_rapids_tpu_torch.memory.spill import (
            BufferCatalog, MemoryEventHandler,
        )
        from spark_rapids_tpu_torch.config.conf import (
            SCAN_PAGE_CACHE, SCAN_PAGE_CACHE_BYTES,
            SCAN_PAGE_CACHE_DEVICE_BYTES,
        )
        from spark_rapids_tpu_torch.memory.spill import EncodedPageCache
        self.device_manager = TpuDeviceManager(conf, device)
        # the encoded-page cache of the device Parquet scan
        # (spark.rapids.sql.scan.pageCache.*): its device tier is metered
        # by the budget and, its handler registered before the spill
        # handler, dropped first under pressure
        self.page_cache = EncodedPageCache(
            int(conf.get(SCAN_PAGE_CACHE_BYTES.key) or 0),
            int(conf.get(SCAN_PAGE_CACHE_DEVICE_BYTES.key) or 0),
            self.device_manager) \
            if conf.get_bool(SCAN_PAGE_CACHE.key, True) else None
        if self.page_cache is not None:
            self.device_manager.register_oom_handler(self.page_cache)
        self.semaphore = TpuSemaphore(conf.concurrent_tpu_tasks)
        self.buffer_catalog = BufferCatalog(
            conf.host_spill_storage_size,
            disk_dir=str(conf.get(SPILL_DIR.key) or "") or None,
            device_manager=self.device_manager, device=device)
        self.memory_event_handler = MemoryEventHandler(
            self.buffer_catalog.device_store)
        self.device_manager.register_oom_handler(self.memory_event_handler)
        # transient spillables registered outside any query
        self._transient_bids: set = set()
        # the accelerated shuffle manager's executor pool, built lazily
        # (shuffle_envs), and the shuffles registered in it
        self._shuffle_env = None
        self._shuffle_id_counter = 0
        self._active_shuffles: List[int] = []
        self._shuffle_lock = threading.Lock()
        # the ExecContext of the query executing on this thread
        self._exec_scope = threading.local()
        self.last_query_metrics: dict = {}
        # the last query's plan, profile (obs/profile.py) and syncEachOp
        # node times
        self.last_plan = None
        self.last_profile = None
        self.last_node_times: dict = {}
        # the tenant tag (set_job_group): the session's, or this thread's
        self._job_group_default: tuple = (None, "")
        self._job_group_tls = threading.local()
        # the serving caches (serving/caches.py), built at first use
        self._serving_caches = None
        self._serving_lock = threading.Lock()
        # every executed physical plan, while capture_plans is on (tests)
        self.captured_plans: List = []
        self.capture_plans = False
        # the shared nvcc build directory and the pre-warm pass of the
        # conf (obs/compilecache.py, serving/prewarm.py); SIGUSR1 dumps
        # the diagnostics into the journal (obs/monitor.py)
        from spark_rapids_tpu_torch.obs import compilecache
        from spark_rapids_tpu_torch.serving import prewarm
        compilecache.SHARED.configure_from_conf(conf)
        prewarm.maybe_start_from_conf(conf, device)
        if conf.get_bool("spark.rapids.tpu.ui.signalDiagnostics", True):
            from spark_rapids_tpu_torch.obs.monitor import (
                install_signal_diagnostics,
            )
            install_signal_diagnostics()

    class Builder:
        def __init__(self):
            self._settings: Dict = {}
            self._device = "cuda"

        def config(self, key: str, value) -> "TpuSparkSession.Builder":
            self._settings[key] = value
            return self

        def device(self, device) -> "TpuSparkSession.Builder":
            self._device = device
            return self

        def get_or_create(self) -> "TpuSparkSession":
            """A new session of these settings; it becomes the active
            one."""
            session = TpuSparkSession(TpuConf(self._settings), self._device)
            TpuSparkSession._active = session
            return session

    @staticmethod
    def builder() -> "TpuSparkSession.Builder":
        return TpuSparkSession.Builder()

    @staticmethod
    def active() -> "TpuSparkSession":
        """The session ``get_or_create`` made last, or a new one at the
        default settings (on the card)."""
        s = TpuSparkSession._active
        if s is None:
            s = TpuSparkSession.builder().get_or_create()
        return s

    # --- conf --------------------------------------------------------------
    def set_conf(self, key: str, value) -> None:
        self.conf.set(key, value)

    def get_conf(self, key: str, default=None):
        return self.conf.get(key, default)

    def reset_conf(self) -> None:
        """Back to the settings the session was built with."""
        self.conf._settings = dict(self._base_settings)

    def clear_device_cache(self) -> None:
        for _source, parts in self.device_scan_cache.values():
            for bids in parts.values():
                for bid in bids:
                    self.buffer_catalog.remove(bid)
        self.device_scan_cache.clear()

    def stop(self) -> None:
        """Tear the session down: free cached and spilled buffers, detach
        the spill handler and close the catalog (its arena and spill
        files)."""
        self.clear_device_cache()
        self.clear_serving_caches()
        from spark_rapids_tpu_torch.serving import prewarm
        prewarm.cancel_active()
        self.release_transient_buffers()
        self.release_active_shuffles()
        if self._shuffle_env is not None:
            for env in self._shuffle_env:
                env.close()
            self._shuffle_env = None
        self.device_manager.unregister_oom_handler(self.memory_event_handler)
        if self.page_cache is not None:
            self.device_manager.unregister_oom_handler(self.page_cache)
            self.page_cache.clear()
        self.buffer_catalog.close()
        if TpuSparkSession._active is self:
            TpuSparkSession._active = None

    # --- the accelerated shuffle manager ----------------------------------
    def _make_transport(self, executor_id: str):
        kind = self.conf.get("spark.rapids.shuffle.transport.class",
                             "inprocess")
        if kind == "socket":
            from spark_rapids_tpu_torch.shuffle.socket_transport import (
                SocketTransport,
            )
            return SocketTransport(executor_id)
        if kind == "inprocess":
            from spark_rapids_tpu_torch.shuffle.transport import (
                InProcessTransport,
            )
            return InProcessTransport(executor_id)
        # SPI: dotted path "module:Class" taking (executor_id)
        import importlib
        mod, _, cls = kind.partition(":")
        return getattr(importlib.import_module(mod), cls)(executor_id)

    @property
    def shuffle_envs(self):
        """The executor pool of the accelerated shuffle manager. With
        spark.rapids.shuffle.executors > 1, map tasks stripe across the
        pool and cross-executor fetches ride the configured transport
        (socket = real TCP loopback) through serializer -> server ->
        client -> received catalog, in one process."""
        if self._shuffle_env is None:
            from spark_rapids_tpu_torch.shuffle.manager import ShuffleEnv
            bsize = int(self.conf.get(
                "spark.rapids.shuffle.bounceBuffers.size", 4 << 20))
            bcount = int(self.conf.get(
                "spark.rapids.shuffle.bounceBuffers.count", 16))
            nexec = int(self.conf.get("spark.rapids.shuffle.executors", 1))
            # executor ids unique to this session: sessions of the port
            # are independent, and the transports' registries are
            # process-wide
            tag = f"{id(self):x}"
            self._shuffle_env = [
                ShuffleEnv(f"local-exec-{i}-{tag}",
                           self._make_transport(f"local-exec-{i}-{tag}"),
                           bounce_buffer_size=bsize,
                           bounce_buffer_count=bcount,
                           buffer_catalog=self.buffer_catalog,
                           device=self.device)
                for i in range(max(1, nexec))]
        return self._shuffle_env

    @property
    def shuffle_env(self):
        return self.shuffle_envs[0]

    def next_shuffle_id(self) -> int:
        with self._shuffle_lock:
            self._shuffle_id_counter += 1
            sid = self._shuffle_id_counter
            self._active_shuffles.append(sid)
        ctx = self._current_ctx()
        if ctx is not None:
            ctx.active_shuffles.append(sid)
        return sid

    def release_active_shuffles(self, ctx=None) -> None:
        """Unregister every shuffle a query registered (the reference's
        unregisterShuffle path). With a context, only that query's
        shuffles; without one (stop), everything outstanding."""
        if self._shuffle_env is None:
            if ctx is not None:
                ctx.active_shuffles.clear()
            return
        with self._shuffle_lock:
            if ctx is not None:
                sids, ctx.active_shuffles = list(ctx.active_shuffles), []
                self._active_shuffles = [
                    s for s in self._active_shuffles if s not in set(sids)]
            else:
                sids, self._active_shuffles = self._active_shuffles, []
        for env in self._shuffle_env:
            for sid in sids:
                env.shuffle_catalog.remove_shuffle(sid)

    # --- per-query spillables ------------------------------------------------
    def _current_ctx(self):
        """The ExecContext of the query executing on this thread, or
        None."""
        return getattr(self._exec_scope, "ctx", None)

    def register_transient(self, bid: int) -> int:
        ctx = self._current_ctx()
        if ctx is not None:
            ctx.transient_bids.add(bid)
        else:
            self._transient_bids.add(bid)
        return bid

    def add_transient_batch(self, batch, priority: int) -> int:
        """Register a per-query spillable in the catalog and in the query's
        transient set in one step (an add_batch alone would pin the buffer
        in the catalog past the query's end)."""
        return self.register_transient(
            self.buffer_catalog.add_batch(batch, priority))

    def consume_transient(self, bid: int) -> None:
        ctx = self._current_ctx()
        if ctx is not None:
            ctx.transient_bids.discard(bid)
        self._transient_bids.discard(bid)
        self.buffer_catalog.remove(bid)

    def release_transient_buffers(self, ctx=None) -> None:
        """Free the per-query spillables a query did not consume: with a
        context, that query's; without one, those registered outside any
        query."""
        if ctx is not None:
            bids, ctx.transient_bids = set(ctx.transient_bids), set()
        else:
            bids, self._transient_bids = set(self._transient_bids), set()
        for bid in bids:
            self.buffer_catalog.remove(bid)

    # --- data --------------------------------------------------------------
    def create_dataframe(self, df: pd.DataFrame,
                         num_partitions: int = 1) -> "DataFrame":
        return DataFrame(self, lp.LogicalScan(InMemorySource(
            df, num_partitions)))

    def range(self, start: int, end: Optional[int] = None, step: int = 1,
              num_partitions: int = 2) -> "DataFrame":
        if end is None:
            start, end = 0, start
        return DataFrame(self, lp.LogicalRange(start, end, step,
                                               num_partitions))

    @property
    def read(self) -> "DataFrameReader":
        return DataFrameReader(self)

    # --- execution ---------------------------------------------------------
    def physical_plan(self, logical: lp.LogicalPlan):
        """logical -> pruned -> CPU physical -> device rewrite."""
        return self._convert(logical)[0]

    def _convert(self, logical: lp.LogicalPlan):
        """(physical plan, the tag pass's TpuOverrides or None where the
        device path is off)."""
        return self._convert_cpu(self._cpu_plan(logical))

    def _cpu_plan(self, logical: lp.LogicalPlan):
        """logical -> pruned -> the CPU physical plan."""
        from spark_rapids_tpu_torch.sql.pushdown import (
            annotate_scan_pruning, prune_filter_columns,
        )
        self._note_rename_aliases(logical)
        logical = prune_filter_columns(logical)
        annotate_scan_pruning(logical)
        planner = Planner(self.conf)
        if isinstance(logical, lp.LogicalLimit):
            return planner.plan_collect_limit(logical)
        return planner.plan(logical)

    def _convert_cpu(self, plan):
        """A CPU physical plan's device rewrite: (plan, TpuOverrides or
        None)."""
        from spark_rapids_tpu_torch.sql.overrides import (
            TpuOverrides, TransitionOverrides, assert_is_on_tpu,
        )
        conf = self.conf
        overrides = None
        if conf.sql_enabled:
            overrides = TpuOverrides(conf)
            plan = TransitionOverrides(conf, self).apply(
                overrides.apply(plan))
            if conf.get_bool(FUSE_COUNT_DISTINCT.key,
                             FUSE_COUNT_DISTINCT.default):
                from spark_rapids_tpu_torch.exec.aggfuse import (
                    fuse_count_distinct,
                )
                plan = fuse_count_distinct(plan)
            from spark_rapids_tpu_torch.exec.reuse import (
                reuse_common_subtrees,
            )
            plan = reuse_common_subtrees(plan)
            if conf.test_enabled:
                assert_is_on_tpu(plan, conf,
                                 overrides.explain_text("NOT_ON_TPU"))
        return plan, overrides

    def _note_rename_aliases(self, logical: lp.LogicalPlan) -> None:
        for node in logical.walk():
            if isinstance(node, lp.LogicalProject):
                for out_name, e in node.exprs:
                    while isinstance(e, Alias):
                        e = e.children[0]
                    if isinstance(e, Col) and e.name != out_name:
                        self.column_aliases.setdefault(out_name, set()).add(
                            e.name)

    def _execute(self, logical: lp.LogicalPlan, collect: bool = True):
        """Plan and run ``logical``: the output pandas frames, or with
        ``collect=False`` the output partitions' DeviceBatches (for a
        device plan), the query up to its collect. Around it, the JAX
        package's bookkeeping: the query's trace window and export, its
        journal window (queryStart, queryPlan, cpuFallback, queryEnd; the
        flight recorder dumped on failure), the sync ledger and transfer
        guard from the conf, its progress record and ``last_profile``."""
        import time

        from spark_rapids_tpu_torch.obs import syncledger
        from spark_rapids_tpu_torch.obs.events import EVENTS, conf_fingerprint
        from spark_rapids_tpu_torch.obs.metrics import REGISTRY
        from spark_rapids_tpu_torch.obs.progress import PROGRESS
        from spark_rapids_tpu_torch.obs.trace import TRACER
        conf = self.conf
        ctx = ExecContext(conf, self, self.device)
        # the tracer's window: configured from the conf and cleared, so an
        # exported file holds exactly this query
        trace_path = str(conf.get(TRACE_PATH.key) or "")
        trace_on = conf.get_bool(TRACE_ENABLED.key, False) or bool(trace_path)
        nvtx = conf.get_bool(TRACE_NVTX.key, False)
        if nvtx and trace_on and torch.device(self.device).type != "cuda":
            raise RuntimeError(f"{TRACE_NVTX.key} needs a CUDA device; this "
                               f"session's device is {self.device}")
        TRACER.configure(trace_on, nvtx=nvtx)
        if trace_on:
            TRACER.clear()
        guard = str(conf.get(DEBUG_TRANSFER_GUARD.key) or "off")
        if guard not in ("off", "log", "disallow"):
            raise ValueError(f"{DEBUG_TRANSFER_GUARD.key} must be off, log "
                             f"or disallow, got {guard!r}")
        self.last_profile = None
        self.last_plan = None
        self.last_node_times = {}
        # the process-wide registry's flow snapshot (the profile reports
        # the query's delta) and the truncation counters and sync ledger
        # watermark the profile's observability and syncs sections start
        # from
        global_before = obs_before = None
        if ctx.metrics_enabled:
            global_before = REGISTRY.flow_values()
            obs_before = (TRACER.dropped, EVENTS.dropped, EVENTS.rotations,
                          EVENTS.rotate_failures,
                          syncledger.SYNC_LEDGER.seq)
            # a peak gauge is state: reset per query so the profile's
            # queueDepthPeak is this query's
            REGISTRY.gauge("scan.prefetch.queueDepthPeak").set(0)
        t_query0 = time.perf_counter()
        from spark_rapids_tpu_torch.columnar import dictionary
        dictionary.configure_from_conf(conf)
        EVENTS.configure_from_conf(conf)
        syncledger.SYNC_LEDGER.configure_from_conf(conf)
        # the shared nvcc build directory, the pre-warm pass and the live
        # monitor (which keeps PROGRESS in step) follow the conf: a few
        # conf reads each when nothing changed
        from spark_rapids_tpu_torch.obs import compilecache, monitor
        from spark_rapids_tpu_torch.serving import prewarm
        compilecache.SHARED.configure_from_conf(conf)
        prewarm.maybe_start_from_conf(conf, self.device)
        monitor.maybe_serve(conf)
        tenant, job_desc = self._job_group
        EVENTS.query_start(tenant=tenant,
                           confFingerprint=conf_fingerprint(conf._settings))
        qp = None
        if PROGRESS.enabled:
            qp = PROGRESS.begin(EVENTS.current_query, tenant=tenant,
                                description=job_desc)
            ctx.progress = qp
        prev = self._current_ctx()
        self._exec_scope.ctx = ctx
        before = {d: (REGISTRY.value("spill.events", direction=d),
                      REGISTRY.value("spill.bytes", direction=d))
                  for d in _SPILL_DIRECTIONS}
        from spark_rapids_tpu_torch.utils import kernelcache
        kernelcache.configure_shape_buckets_from_conf(conf)
        self.last_aqe = None
        try:
            # the transfer guard: on a CUDA device a host wait outside a
            # sync_scope warns or raises while the query body runs
            with syncledger.guard_context(guard, self.device):
                cpu_plan = self._cpu_plan(logical)
                if self._adaptive_applies(cpu_plan):
                    plan, outs = self._run_adaptive(cpu_plan, ctx, collect)
                else:
                    plan, outs, ctx = self._run_plan(cpu_plan, ctx, collect,
                                                     logical)
        except BaseException as e:
            wall_s = round(time.perf_counter() - t_query0, 6)
            err = f"{type(e).__name__}: {e}"[:300]
            # a cancel or a deadline is a terminal state of its own, not a
            # failure: its event carries the flight recorder's and the
            # sync ledger's tails, so a stopped query leaves its last
            # moments on record
            from spark_rapids_tpu_torch.serving.cancellation import (
                QueryCancelled, QueryTimeout,
            )
            if isinstance(e, QueryTimeout):
                status, kind = "timeout", "queryTimeout"
            elif isinstance(e, QueryCancelled):
                status, kind = "cancelled", "queryCancelled"
            else:
                status, kind = "failed", None
            if kind is not None:
                extra = {}
                if status == "timeout" and ctx.cancel is not None:
                    extra["deadlineSeconds"] = ctx.cancel.deadline_s
                EVENTS.emit(kind, reason=err, wall_s=wall_s,
                            events=EVENTS.flight_events(), compiles=[],
                            syncs=syncledger.SYNC_LEDGER.tail(), **extra)
            EVENTS.query_end(status=status, flight_dump=kind is None,
                             error=err, wall_s=wall_s)
            self._note_tenant(tenant, status, wall_s)
            if qp is not None:
                PROGRESS.finish(qp, status, error=err)
            raise
        finally:
            # a speculation re-run swapped in its own context
            ctx = self._current_ctx() or ctx
            self.release_active_shuffles(ctx)
            self.release_transient_buffers(ctx)
            self.semaphore.release()
            self._exec_scope.ctx = prev
            ctx.metrics["memory"] = self._memory_metrics(before)
            self.last_query_metrics = ctx.op_metrics()
        self._finish_query(plan, ctx, global_before, t_query0, trace_on,
                           trace_path, obs_before)
        wall_s = round(time.perf_counter() - t_query0, 6)
        rows_out = self._count_rows(outs)
        EVENTS.query_end(status="success", wall_s=wall_s,
                         rowsReturned=rows_out,
                         **self._coverage_fields(plan, ctx))
        self._note_tenant(tenant, "success", wall_s, rows_out)
        if qp is not None:
            PROGRESS.finish(qp, "success")
        self._sweep_adaptive_caches()
        return outs

    def _run_plan(self, cpu_plan, ctx: ExecContext, collect: bool,
                  logical: Optional[lp.LogicalPlan] = None):
        """The single-shot path: convert (or take the plan cache's clone),
        drain and verify the query's speculation
        (``_verify_speculation``). On a miss the same physical plan re-runs
        with a fresh context and ``speculate=False``, after the speculative
        run's shuffles and transient buffers are released and its
        ratio-cache writes dropped. A collected query may be answered by
        the result cache instead, and offers its frames to it. Returns
        (plan, outputs, the context that produced them)."""
        from spark_rapids_tpu_torch.obs.events import EVENTS
        from spark_rapids_tpu_torch.obs.trace import TRACER
        caches = self._serving() if logical is not None else None
        key = caches.key_for(cpu_plan, self.conf, logical) \
            if caches is not None else None
        tenant = self._job_group[0]
        if key is not None and collect:
            hit = caches.result_cache.get(key, self.conf, tenant)
            if hit is not None:
                plan, outs = hit
                EVENTS.emit("resultCacheHit", planDigest=key[0],
                            rows=self._count_rows(outs))
                if self.capture_plans:
                    self.captured_plans.append(plan)
                return plan, outs, ctx
        plan = self._plan_query(cpu_plan, ctx, caches, key)
        if ctx.speculate and any(
                type(n).__name__ in ("TpuWriteExec", "CpuWriteExec")
                for n in plan.walk()):
            # a write commits files DURING the drain: a miss found after
            # it would have committed truncated output, and the re-run
            # would collide with the committed path. Capacity syncs stay
            # exact under a write.
            ctx.speculate = False
        with TRACER.span("Query", speculative=bool(ctx.speculate)):
            outs = self._drain(plan, ctx, collect)
        if ctx.spec_pending and not self._verify_speculation(ctx):
            self.capacity_spec_reruns += 1
            # ratios learned from a misspeculated run may be wrong (a
            # dense-group miss collapses group counts)
            for sig in ctx.ratio_writes:
                self.agg_ratio_cache.pop(sig, None)
            self.release_active_shuffles(ctx)
            self.release_transient_buffers(ctx)
            prev_progress = ctx.progress
            ctx = ExecContext(self.conf, self, self.device, speculate=False)
            ctx.progress = prev_progress  # same query, same record
            # this thread's execution scope points at the fresh context,
            # so the re-run's registrations release with it
            self._exec_scope.ctx = ctx
            with TRACER.span("Query", speculative=False, rerun=True):
                outs = self._drain(plan, ctx, collect)
        if key is not None and collect:
            caches.result_cache.maybe_put(key, cpu_plan, plan, outs,
                                          self.conf, tenant)
        return plan, outs, ctx

    def _adaptive_applies(self, cpu_plan) -> bool:
        if not (self.conf.sql_enabled and self.conf.adaptive_enabled):
            return False
        from spark_rapids_tpu_torch.sql.adaptive.executor import (
            has_adaptive_stages,
        )
        return has_adaptive_stages(cpu_plan)

    def _run_adaptive(self, cpu_plan, ctx: ExecContext, collect: bool):
        """The adaptive path (``spark.rapids.sql.adaptive.enabled``): the
        executor converts and materializes stage by stage and re-plans
        from the observed sizes. Capacity speculation is off: AQE's stage
        barriers are the syncs speculation avoids, and a speculative
        re-execution would invalidate the statistics its own re-planning
        read. The static and the final plans each get a ``queryPlan``
        event (``phase``)."""
        from spark_rapids_tpu_torch.obs.events import EVENTS, plan_digest
        from spark_rapids_tpu_torch.obs.trace import TRACER
        from spark_rapids_tpu_torch.sql.adaptive.executor import (
            AdaptiveExecutor,
        )
        ctx.speculate = False
        adaptive = AdaptiveExecutor(self, self.conf, ctx)
        # the static shape first, so a query that dies mid-stage still
        # leaves a plan record
        EVENTS.emit("queryPlan", planDigest=plan_digest(cpu_plan),
                    adaptive=True, phase="static")
        if ctx.progress is not None:
            ctx.progress.set_plan(cpu_plan)
        with TRACER.span("Query", adaptive=True):
            plan, outs = adaptive.execute(cpu_plan, collect)
        if self.capture_plans:
            self.captured_plans.append(plan)
        # the digest of the runtime-re-planned FINAL plan: it differs from
        # the static shape exactly when a rule fired
        EVENTS.emit("queryPlan", planDigest=plan_digest(plan),
                    planTree=plan.tree_string()[:20000],
                    adaptive=True, phase="final",
                    aqeStages=len(adaptive.stages),
                    aqeDecisions=len(adaptive.decisions),
                    **self._coverage_fields(plan))
        if ctx.progress is not None:
            ctx.progress.set_plan(plan)
        return plan, outs

    # adaptive-state size cap: fingerprints embed per-upload data uids, so
    # a workload that keeps creating DataFrames mints fresh keys every
    # query. The LruDict caches touch keys on read, so oldest-first
    # half-eviction approximates LRU; the ordered sets evict oldest first
    # (never arbitrarily: a random blocklist eviction would re-enable a
    # known-bad speculation).
    ADAPTIVE_CACHE_CAP = 4096

    def _sweep_adaptive_caches(self) -> None:
        cap = self.ADAPTIVE_CACHE_CAP
        for d in (self.capacity_cache, self.agg_ratio_cache,
                  self.column_stats, self.column_aliases):
            if len(d) > cap:
                for k in list(d.keys())[:len(d) - cap // 2]:
                    del d[k]
        for st in (self.capacity_spec_blocklist, self.dense_plans_seen):
            if len(st) > cap:
                while len(st) > cap // 2:
                    st.pop_oldest()

    def _verify_speculation(self, ctx: ExecContext) -> bool:
        """ONE deferred fetch validating every capacity the query
        speculated (``exec/tpujoin.py``, the exchange shrink, the dense
        grouping key): the host copies started at each site are waited
        for inside one counted ``speculation.verify`` scope. A covered
        join speculation is exact (capacities only pad), so success means
        the speculative output stands; a shortfall, a dense ok flag gone
        false or a shrink count that drifted drops the entry at fault
        (blocklisting a ``nocache|`` key) and returns False, and the
        caller re-runs the plan without speculation. When every entry
        held, the join entries are refreshed with the actual sizes, so
        the cache follows data drift while it stays inside the buckets
        (the JAX package refreshes the covered entries of a failed run
        too, from sizes a truncated input below them produced, which
        undersizes the next run and costs it a second re-execution)."""
        from spark_rapids_tpu_torch.obs.syncledger import sync_scope
        copies = [c for _k, tot, _w, _caps, oks, _ex in ctx.spec_pending
                  for c in ([tot] if tot is not None else []) + list(oks)]
        fetched = {}
        if copies:
            with sync_scope("speculation.verify",
                            nbytes=sum(c.nbytes for c in copies),
                            detail=f"arrays={len(copies)}"):
                for c in copies:
                    c.wait()
                    fetched[id(c)] = c.tolist()
        all_good = True
        refresh = []
        for key, tot, width, caps, oks, exact in ctx.spec_pending:
            flat = fetched[id(tot)] if tot is not None else []
            good = all(bool(fetched[id(o)]) for o in oks)
            if good and exact is not None:
                # the shrink's counts were used as EXACT host metadata, so
                # any drift (not only an overflow) invalidates
                good = [int(v) for v in flat] == [int(v) for v in exact]
            elif good:
                # join expansion: the entry stands while the actual sizes
                # stay covered; the CONSUMED prefix is checked (a
                # CollectLimit may stop the expansion early)
                sizes = [flat[i * width:(i + 1) * width]
                         for i in range(len(flat) // width)] if width else []
                for cap, sz in zip(caps, sizes):
                    if cap is None:  # speculated-empty batch
                        if sz[0] != 0:
                            good = False
                            break
                        continue
                    out_cap, char_caps = cap
                    if (sz[0] > out_cap or len(sz) - 1 != len(char_caps)
                            or any(c > cc for c, cc in zip(sz[1:],
                                                           char_caps))):
                        good = False
                        break
                if good:
                    refresh.append((key, sizes))
            if not good:
                self.capacity_cache.pop(key, None)
                if key.startswith("nocache|"):
                    self.capacity_spec_blocklist.add(key)
                all_good = False
        # refresh only from a run that stood whole: a join below a missed
        # one saw truncated input, and its sizes would undersize the next
        # run
        for key, sizes in (refresh if all_good else ()):
            ent = self.capacity_cache.get(key)
            if ent is not None and len(sizes) == ent.get("n"):
                ent["sizes"] = [[int(x) for x in sz] for sz in sizes]
        return all_good

    def _plan_query(self, cpu_plan, ctx: ExecContext, caches=None,
                    key=None):
        """The physical plan, with its journal facts: the queryPlan event
        (digest, tree, operator coverage, planCacheHit) and one
        cpuFallback event per operator the tag pass left on the CPU. With
        the serving caches, a plan-cache hit is a clone of the cached plan
        (no tag and convert, a ``planCacheHit`` event) and a miss puts
        its conversion in the cache."""
        from spark_rapids_tpu_torch.obs.events import EVENTS, plan_digest
        plan = overrides = None
        if key is not None:
            plan = caches.plan_cache.get(key, self.conf, self._job_group[0])
        hit = plan is not None
        if hit:
            EVENTS.emit("planCacheHit", planDigest=plan_digest(plan))
        else:
            plan, overrides = self._convert_cpu(cpu_plan)
            if key is not None:
                caches.plan_cache.put(key, plan, self.conf)
        if self.capture_plans:
            self.captured_plans.append(plan)
        EVENTS.emit("queryPlan", planDigest=plan_digest(plan),
                    planCacheHit=hit, planTree=plan.tree_string()[:20000],
                    **self._coverage_fields(plan))
        if ctx.progress is not None:
            ctx.progress.set_plan(plan)
        if overrides is not None:
            for meta in overrides.fallback_metas():
                EVENTS.emit("cpuFallback", op=meta.plan.name,
                            describe=meta.plan.describe()[:200],
                            reasons=list(meta.reasons))
        return plan

    def _finish_query(self, plan, ctx: ExecContext, global_before,
                      t_query0: float, trace_on: bool, trace_path: str,
                      obs_before) -> None:
        """After a query ran: the last plan and its syncEachOp node
        times, the profile report (metrics on) and the trace export."""
        import time

        from spark_rapids_tpu_torch.obs.metrics import (
            REGISTRY, registry_delta,
        )
        from spark_rapids_tpu_torch.obs.trace import TRACER
        self.last_plan = plan
        self.last_node_times = ctx.node_times
        if ctx.metrics_enabled:
            from spark_rapids_tpu_torch.obs.profile import build_profile
            self.last_profile = build_profile(
                plan, ctx, registry_delta(global_before,
                                          REGISTRY.flow_values()),
                wall_s=time.perf_counter() - t_query0,
                obs_before=obs_before)
        if trace_on and trace_path:
            TRACER.export_chrome(trace_path)

    @staticmethod
    def _count_rows(outs) -> int:
        try:
            return sum(len(df) for df in outs) if outs else 0
        except TypeError:
            return 0

    @staticmethod
    def _note_tenant(tenant, status: str, wall_s: float,
                     rows: int = 0) -> None:
        """Per-tenant accounting at each query's end: ``tenant.queries``
        by status, ``tenant.wallSeconds`` and ``tenant.rowsReturned``."""
        from spark_rapids_tpu_torch.obs.metrics import REGISTRY
        t = tenant or "default"
        REGISTRY.counter("tenant.queries", tenant=t, status=status).add(1)
        REGISTRY.counter("tenant.wallSeconds", tenant=t).add(
            round(wall_s, 6))
        if rows:
            REGISTRY.counter("tenant.rowsReturned", tenant=t).add(rows)

    # --- observability ------------------------------------------------------
    def _coverage_fields(self, plan, ctx: Optional[ExecContext] = None
                         ) -> dict:
        """Device-vs-CPU operator census of a converted plan (transitions
        excluded: they are the boundary), plus, given the executed
        context, each CPU operator's observed inclusive seconds."""
        tpu = cpu = 0
        cpu_time: dict = {}
        for node in plan.walk():
            if node.name in ("HostToDeviceExec", "DeviceToHostExec"):
                continue
            if node.columnar_output or getattr(node, "columnar_input",
                                               False):
                tpu += 1
                continue
            cpu += 1
            if ctx is not None:
                st = ctx.node_stats.get(id(node))
                if st is not None:
                    d = node.describe()[:200]
                    cpu_time[d] = round(
                        cpu_time.get(d, 0.0) + st["time"], 6)
        total = tpu + cpu
        out = {"tpuOps": tpu, "cpuOps": cpu,
               "coveragePct": round(100.0 * tpu / total, 2)
               if total else 100.0}
        if cpu_time:
            out["cpuOpTime"] = cpu_time
        return out

    def set_job_group(self, tenant, description: str = "") -> None:
        """Tag this session's next queries with a tenant (job group): the
        tag rides every journal event of those queries, their progress
        records and the ``tenant.*`` counters. ``set_job_group(None)``
        clears it."""
        group = (str(tenant) if tenant else None, str(description or ""))
        self._job_group_default = group
        self._job_group_tls.value = group

    def clear_job_group(self) -> None:
        self.set_job_group(None)

    def _set_thread_job_group(self, tenant, description: str = "") -> None:
        """Tag THIS THREAD's queries only (the serving workers' form: each
        runs another tenant's job at once, and a session-wide tag would
        cross-attribute them)."""
        self._job_group_tls.value = (str(tenant) if tenant else None,
                                     str(description or ""))

    @property
    def _job_group(self) -> tuple:
        return getattr(self._job_group_tls, "value",
                       self._job_group_default)

    # --- serving ------------------------------------------------------------
    def _serving(self):
        """The serving caches (serving/caches.py), or None while the plan
        and the result cache are both off (then planning does no extra
        work per query)."""
        from spark_rapids_tpu_torch.serving import caches as sc
        conf = self.conf
        if not (conf.get_bool(sc.PLAN_CACHE_ENABLED, True)
                or conf.get_bool(sc.RESULT_CACHE_ENABLED, False)):
            return None
        return self._serving_bundle()

    def _serving_bundle(self):
        if self._serving_caches is None:
            with self._serving_lock:
                if self._serving_caches is None:
                    from spark_rapids_tpu_torch.serving.caches import (
                        ServingCaches,
                    )
                    self._serving_caches = ServingCaches()
        return self._serving_caches

    def serving_scheduler(self, **kwargs):
        """An admission scheduler over this session
        (serving/scheduler.py): submit/status/cancel with per-tenant
        weighted-fair lanes, load shed, deadlines and tenant budgets. The
        caller owns it (``close()``)."""
        from spark_rapids_tpu_torch.serving.scheduler import QueryScheduler
        return QueryScheduler(self, **kwargs)

    def clear_serving_caches(self) -> None:
        if self._serving_caches is not None:
            self._serving_caches.clear()

    def dump_flight_recorder(self) -> List[dict]:
        """The always-on flight recorder's snapshot (the last N events,
        and spans while tracing is on), also written into the journal as
        a ``flightRecorder`` event where the journal is on."""
        from spark_rapids_tpu_torch.obs.events import EVENTS
        return EVENTS.dump_flight(reason="manual")["events"]

    def profile_report(self) -> str:
        """The last query's profile, rendered (obs/profile.py): its plan
        tree with inclusive and exclusive time, rows and batches, and its
        scan, spill, sync and truncation counters. Empty where no
        profiled query has run (metrics off)."""
        return "" if self.last_profile is None else \
            self.last_profile.render()

    def profile_json(self) -> Optional[dict]:
        """The last query's profile as JSON (None where no profiled query
        has run), the shape ``tools/trace_summary.py`` reads."""
        return None if self.last_profile is None else \
            self.last_profile.to_json()

    def _memory_metrics(self, before: dict) -> dict:
        """The memory runtime's state after a query and the spills it
        made by direction (events and bytes)."""
        from spark_rapids_tpu_torch.obs.metrics import REGISTRY
        cat = self.buffer_catalog
        mem = {
            "allocatedBytes": self.device_manager.allocated,
            "spillCount": self.memory_event_handler.spill_count,
            "deviceStoreBytes": cat.device_store.total_size,
            "hostStoreBytes": cat.host_store.total_size,
            "diskStoreBytes": cat.disk_store.total_size,
        }
        for d in _SPILL_DIRECTIONS:
            ev0, by0 = before[d]
            mem[f"spillEvents.{d}"] = (
                REGISTRY.value("spill.events", direction=d) - ev0)
            mem[f"spillBytes.{d}"] = (
                REGISTRY.value("spill.bytes", direction=d) - by0)
        cat.publish_metrics()
        return mem

    def _drain(self, plan, ctx: ExecContext, collect: bool = True) -> list:
        outs = [x for part in plan.executed_partitions(ctx) for x in part()]
        if plan.columnar_output and collect:
            # the result fetch under a "Collect" scope: its syncs
            # attribute to it, and its seconds are the Collect fetchTime
            # metric (not a node's transfer: the fetch runs after the
            # root's pulls)
            import time

            from spark_rapids_tpu_torch.obs.compileledger import op_context
            with op_context("Collect"):
                t0 = time.perf_counter()
                frames = [b.to_pandas() for b in outs]
            if ctx.metrics_enabled:
                ctx.metric_add("Collect", "fetchTime",
                               time.perf_counter() - t0)
            return frames
        return outs


class DataFrameWriter:
    """``df.write.mode("overwrite").parquet(path)``: the DataFrameWriter
    surface over LogicalWrite (reference: the GpuDataWritingCommandExec
    path)."""

    def __init__(self, df: "DataFrame"):
        self._df = df
        self._mode = "error"
        self._partition_cols: List[str] = []

    def mode(self, m: str) -> "DataFrameWriter":
        m = {"errorifexists": "error"}.get(m, m)
        if m not in ("error", "overwrite"):
            raise ValueError(f"write mode {m!r}: error or overwrite")
        self._mode = m
        return self

    def partition_by(self, *cols: str) -> "DataFrameWriter":
        """Hive-style dynamic partitioning: one key=value directory level
        per column (reference: GpuInsertIntoHadoopFsRelationCommand's
        dynamic-partition write)."""
        missing = [c for c in cols if c not in self._df.schema.names]
        if missing:
            raise ValueError(f"partition_by columns not in schema: {missing}")
        self._partition_cols = list(cols)
        return self

    partitionBy = partition_by

    def _run(self, path: str, fmt: str) -> None:
        self._df.session._execute(lp.LogicalWrite(
            self._df._plan, path, fmt, self._mode, self._partition_cols))

    def parquet(self, path: str) -> None:
        self._run(path, "parquet")

    def csv(self, path: str) -> None:
        self._run(path, "csv")

    def orc(self, path: str) -> None:
        self._run(path, "orc")


class DataFrameReader:
    """``session.read``: file sources. ``schema`` and ``option("header",
    ...)`` apply to CSV."""

    def __init__(self, session: TpuSparkSession):
        self.session = session
        self._schema: Optional[Schema] = None
        self._options: Dict[str, str] = {}

    def schema(self, schema: Schema) -> "DataFrameReader":
        self._schema = schema
        return self

    def option(self, key: str, value) -> "DataFrameReader":
        self._options[key] = value
        return self

    def parquet(self, *paths: str) -> "DataFrame":
        return DataFrame(self.session,
                         lp.LogicalScan(ParquetSource(list(paths))))

    def csv(self, *paths: str) -> "DataFrame":
        header = str(self._options.get("header", "true")).lower() == "true"
        return DataFrame(self.session, lp.LogicalScan(CsvSource(
            list(paths), schema=self._schema, header=header)))

    def orc(self, *paths: str) -> "DataFrame":
        return DataFrame(self.session,
                         lp.LogicalScan(OrcSource(list(paths))))


class GroupedData:
    def __init__(self, df: "DataFrame", grouping_cols: Sequence):
        self.df = df
        self.grouping = grouping_cols

    def agg(self, *agg_cols: Column) -> "DataFrame":
        schema = self.df._plan.schema()
        child = self.df._plan
        grouping, computed = [], []
        for i, g in enumerate(self.grouping):
            e = _c(g)
            name = _name_of(e)
            base = e.children[0] if isinstance(e, Alias) else e
            if not isinstance(base, Col):
                # a computed key: pre-projected under an internal name when
                # its alias would shadow an input column
                iname = f"__grp{i}" if name in schema.names else name
                computed.append((iname, e))
                e = Col(iname)
            grouping.append((name, e))
        if computed:
            child = lp.LogicalProject(
                child, [(n, Col(n)) for n in schema.names] + computed)
        result_exprs = [(_name_of(_expr(c)), _expr(c)) for c in agg_cols]
        if any(getattr(fn, "is_distinct", False)
               for _, e in result_exprs for fn in find_aggregates(e)):
            return self._agg_with_distinct(child, grouping, result_exprs)
        results = [(n, Col(n)) for n, _ in grouping] + result_exprs
        return DataFrame(self.df.session,
                         lp.LogicalAggregate(child, grouping, results))

    def _agg_with_distinct(self, child, grouping, result_exprs
                           ) -> "DataFrame":
        """count(DISTINCT d) as two aggregations (the JAX package's
        rewrite): level 1 groups by keys + d, reducing every other
        aggregate to its update intermediates; level 2 groups by the keys,
        merging the intermediates and counting the now-unique d values."""
        from spark_rapids_tpu_torch.sql.exprs import aggregates as am
        fns, seen = [], set()
        for _, e in result_exprs:
            for fn in am.find_aggregates(e):
                if id(fn) not in seen:
                    seen.add(id(fn))
                    fns.append(fn)
        dist = [fn for fn in fns if getattr(fn, "is_distinct", False)]
        dist_names = {repr(fn.children[0]) for fn in dist}
        if len(dist_names) > 1:
            raise NotImplementedError(
                "multiple DISTINCT aggregate column sets in one aggregation "
                f"are not supported: {sorted(dist_names)}")
        # both levels key columns by name: d is materialized as __dist
        names = child.schema().names
        child = lp.LogicalProject(
            child, [(n, Col(n)) for n in names]
            + [("__dist", dist[0].children[0])])
        l1_grouping = list(grouping) + [("__dist", Col("__dist"))]
        # reduction kind -> aggregate, for level 1 (update) and level 2
        # (merge); count_valid appears only on the update side
        kind_ctor = {
            "sum": am.Sum, "min": am.Min, "max": am.Max,
            "first": lambda e: am.First(e, False),
            "first_valid": lambda e: am.First(e, True),
            "last": lambda e: am.Last(e, False),
            "last_valid": lambda e: am.Last(e, True),
        }
        l1_results = [(n, Col(n)) for n, _ in l1_grouping]
        fn_level2 = {}
        pi = 0
        for fn in fns:
            if getattr(fn, "is_distinct", False):
                # d is unique within a level-2 group now: counting its
                # non-NULL rows is count(DISTINCT d)
                fn_level2[id(fn)] = am.Count(Col("__dist"))
                continue
            refs = []
            for (ukind, cidx), mkind in zip(fn.update_ops(), fn.merge_ops()):
                pname = f"__p{pi}"
                pi += 1
                arg = fn.children[cidx]
                l1_results.append((pname, am.Count(arg)
                                   if ukind == "count_valid"
                                   else kind_ctor[ukind](arg)))
                refs.append(kind_ctor[mkind](Col(pname)))
            fn_level2[id(fn)] = fn.finalize(refs, child.schema())
        level1 = lp.LogicalAggregate(child, l1_grouping, l1_results)

        def rewrite(e):
            if isinstance(e, am.AggregateFunction):
                return fn_level2[id(e)]
            return e.map_children(rewrite)

        l2_grouping = [(n, Col(n)) for n, _ in grouping]
        l2_results = list(l2_grouping) + [(n, rewrite(e))
                                          for n, e in result_exprs]
        return DataFrame(self.df.session,
                         lp.LogicalAggregate(level1, l2_grouping, l2_results))

    def count(self) -> "DataFrame":
        from spark_rapids_tpu_torch.sql import functions as F
        return self.agg(F.count("*").alias("count"))


class RollupData:
    """rollup/cube grouping (Spark's Expand + Aggregate lowering): an
    Expand with one projection per grouping set, whose rolled-up keys are
    typed NULL literals and whose ``_gid`` literal numbers the set, then an
    aggregate over the keys and ``_gid``. The other child columns pass
    through the Expand."""

    def __init__(self, df: "DataFrame", grouping_cols: Sequence,
                 kind: str):
        self.df = df
        self.grouping = grouping_cols
        self.kind = kind  # 'rollup' | 'cube'

    def _grouping_sets(self, nkeys: int):
        if self.kind == "rollup":
            return [list(range(k)) for k in range(nkeys, -1, -1)]
        import itertools
        sets = []
        for r in range(nkeys, -1, -1):
            sets.extend(list(c) for c in
                        itertools.combinations(range(nkeys), r))
        return sets

    def agg(self, *agg_cols: Column) -> "DataFrame":
        from spark_rapids_tpu_torch.sql.exprs.core import Literal
        schema = self.df._plan.schema()
        keys = [(_name_of(_c(g)), _c(g)) for g in self.grouping]
        key_dtypes = [e.dtype(schema) for _, e in keys]
        key_names = {n for n, _ in keys}
        # the key columns are emitted again by every grouping set (NULL
        # where rolled up), so they do not pass through
        base = [(n, col_fn(n).expr) for n in schema.names
                if n not in key_names]
        projections = []
        for gid, kept in enumerate(self._grouping_sets(len(keys))):
            proj = list(base)
            for j, (name, e) in enumerate(keys):
                proj.append((name, e if j in kept
                             else Literal(None, key_dtypes[j])))
            proj.append(("_gid", Literal(gid)))
            projections.append(proj)
        expand = lp.LogicalExpand(self.df._plan, projections)
        grouping = [(n, col_fn(n).expr) for n, _ in keys]
        grouping.append(("_gid", col_fn("_gid").expr))
        results = [(n, col_fn(n).expr) for n, _ in keys]
        results += [(_name_of(_expr(c)), _expr(c)) for c in agg_cols]
        return DataFrame(self.df.session,
                         lp.LogicalAggregate(expand, grouping, results))


def _name_of(e: Expression) -> str:
    if isinstance(e, (Alias, Col)):
        return e.name
    return repr(e)


class DataFrame:
    def __init__(self, session: TpuSparkSession, plan: lp.LogicalPlan):
        self.session = session
        self._plan = plan

    @property
    def schema(self) -> Schema:
        return self._plan.schema()

    @property
    def columns(self) -> List[str]:
        return list(self.schema.names)

    def select(self, *cols) -> "DataFrame":
        """Project ``cols``. Window expressions among them are computed
        first, by window operators under the projection (Spark's
        WindowExec shape), one per distinct partition and order spec."""
        from spark_rapids_tpu_torch.sql.window import WindowExpression
        exprs = [(_name_of(_c(c)), _c(c)) for c in cols]
        win_items = []

        def extract(e):
            if isinstance(e, WindowExpression):
                name = f"__w{len(win_items)}"
                win_items.append((name, e))
                return Col(name)
            return e.map_children(extract)

        exprs = [(n, extract(e)) for n, e in exprs]
        child = self._plan
        by_spec: Dict[str, list] = {}
        for name, w in win_items:
            key = repr((w.spec.partition_cols, w.spec.orders))
            by_spec.setdefault(key, []).append((name, w))
        for items in by_spec.values():
            child = lp.LogicalWindow(child, items)
        return DataFrame(self.session, lp.LogicalProject(child, exprs))

    def filter(self, condition: Column) -> "DataFrame":
        return DataFrame(self.session,
                         lp.LogicalFilter(self._plan, _expr(condition)))

    def group_by(self, *cols) -> GroupedData:
        return GroupedData(self, cols)

    def rollup(self, *cols) -> RollupData:
        return RollupData(self, cols, "rollup")

    def cube(self, *cols) -> RollupData:
        return RollupData(self, cols, "cube")

    def agg(self, *agg_cols: Column) -> "DataFrame":
        return GroupedData(self, []).agg(*agg_cols)

    def order_by(self, *cols) -> "DataFrame":
        orders = [c if isinstance(c, SortOrder) else SortOrder(_c(c))
                  for c in cols]
        return DataFrame(self.session, lp.LogicalSort(self._plan, orders))

    def limit(self, n: int) -> "DataFrame":
        return DataFrame(self.session, lp.LogicalLimit(self._plan, n))

    def union(self, other: "DataFrame") -> "DataFrame":
        return DataFrame(self.session,
                         lp.LogicalUnion([self._plan, other._plan]))

    def join(self, other: "DataFrame", on=None, how: str = "inner",
             left_on=None, right_on=None) -> "DataFrame":
        """Join. ``on`` names columns present on both sides (Spark's USING
        join: one output column per key); ``left_on``/``right_on`` pair
        differently named keys by position (the TPC-H shape: l_orderkey =
        o_orderkey). ``on=None`` with no keys is a cross join; a boolean
        ``Column`` ``on`` is a condition join over the combined columns
        (inner/cross). ``how``: inner, left, right, full, leftsemi,
        leftanti, cross, or their aliases."""
        how = _JOIN_ALIASES.get(how, how)

        def keyify(spec):
            if isinstance(spec, str):
                spec = [spec]
            return [col_fn(c).expr if isinstance(c, str) else _expr(c)
                    for c in spec]
        if left_on is not None or right_on is not None:
            if left_on is None or right_on is None:
                raise ValueError("join: left_on and right_on go together")
            lkeys, rkeys = keyify(left_on), keyify(right_on)
            if len(lkeys) != len(rkeys):
                raise ValueError("join: left_on/right_on length mismatch")
        elif on is None:
            lkeys, rkeys = [], []
            how = "cross"
        elif isinstance(on, Column):
            # an arbitrary boolean condition: the broadcast nested-loop
            # join
            return DataFrame(self.session, lp.LogicalJoin(
                self._plan, other._plan, how, [], [], condition=_expr(on)))
        elif isinstance(on, (str, list, tuple)):
            names = [on] if isinstance(on, str) else list(on)
            if how not in ("leftsemi", "leftanti"):
                return self._join_using(other, names, how)
            lkeys, rkeys = keyify(names), keyify(names)
        else:
            raise TypeError("join on must be a column name, a list of "
                            "names, or a boolean Column condition")
        return DataFrame(self.session, lp.LogicalJoin(
            self._plan, other._plan, how, lkeys, rkeys))

    def _join_using(self, other: "DataFrame", names, how: str
                    ) -> "DataFrame":
        """join(on=[k]) keeps ONE output column per key: the right side's
        keys are renamed, the join is positional, then one key column is
        re-emitted (the left value; the right one for a right join), as
        Spark resolves USING; a full join coalesces the two)."""
        from spark_rapids_tpu_torch.sql.exprs.conditional import Coalesce
        shared = (set(self.schema.names) & set(other.schema.names)) \
            - set(names)
        if shared:
            raise ValueError(
                "join(on=...) with non-key columns present on both sides is "
                f"ambiguous: {sorted(shared)}; alias or drop them first")
        rmap = {n: f"__rk_{n}" for n in names}
        right = other.select(*[
            col_fn(n).alias(rmap[n]) if n in rmap else col_fn(n)
            for n in other.schema.names])
        joined = DataFrame(self.session, lp.LogicalJoin(
            self._plan, right._plan, how, [col_fn(n).expr for n in names],
            [col_fn(rmap[n]).expr for n in names]))
        out = []
        for n in names:
            if how == "right":
                out.append(col_fn(rmap[n]).alias(n))
            elif how == "full":
                out.append(Column(Coalesce([col_fn(n).expr,
                                            col_fn(rmap[n]).expr])).alias(n))
            else:
                out.append(col_fn(n))
        out += [col_fn(n) for n in self.schema.names if n not in names]
        out += [col_fn(n) for n in other.schema.names if n not in names]
        return joined.select(*out)

    def with_column(self, name: str, c: Column) -> "DataFrame":
        """Add (or replace) the column ``name``, computed by ``c``; the
        other columns keep their order, and the new one goes last. A
        window expression appends its column through a window operator,
        and may not shadow an existing column; so does ``explode`` or
        ``posexplode`` of ``split``, through a Generate (whose ``pos``
        column may not shadow one either)."""
        from spark_rapids_tpu_torch.sql.exprs.generators import ExplodeSplit
        from spark_rapids_tpu_torch.sql.window import WindowExpression
        e = _expr(c)
        if isinstance(e, ExplodeSplit):
            if name in self.schema.names:
                raise ValueError(f"generated column {name!r} would shadow "
                                 "an existing column")
            if e.with_pos and "pos" in self.schema.names:
                raise ValueError("posexplode's 'pos' column would shadow an "
                                 "existing column; rename it first")
            return DataFrame(self.session, lp.LogicalGenerate(
                self._plan, e.split.children[0], e.split.delim, name,
                e.with_pos))
        if isinstance(e, WindowExpression):
            if name in self.schema.names:
                raise ValueError(f"window column {name!r} would shadow an "
                                 "existing column")
            return DataFrame(self.session,
                             lp.LogicalWindow(self._plan, [(name, e)]))
        exprs = [(n, col_fn(n).expr) for n in self.schema.names if n != name]
        exprs.append((name, e))
        return DataFrame(self.session, lp.LogicalProject(self._plan, exprs))

    withColumn = with_column

    def drop(self, *names: str) -> "DataFrame":
        dropped = set(names)
        return self.select(*[n for n in self.schema.names
                             if n not in dropped])

    def with_column_renamed(self, old: str, new: str) -> "DataFrame":
        return self.select(*[
            col_fn(n).alias(new) if n == old else col_fn(n)
            for n in self.schema.names])

    withColumnRenamed = with_column_renamed

    def distinct(self) -> "DataFrame":
        """Deduplicate rows (planned as a group-by over every column)."""
        exprs = [(n, col_fn(n).expr) for n in self.schema.names]
        return DataFrame(self.session,
                         lp.LogicalAggregate(self._plan, exprs, [
                             (n, col_fn(n).expr) for n in self.schema.names]))

    @property
    def write(self) -> DataFrameWriter:
        return DataFrameWriter(self)

    def repartition(self, n: int) -> "DataFrame":
        return DataFrame(self.session, lp.LogicalRepartition(self._plan, n))

    def coalesce(self, n: int) -> "DataFrame":
        return DataFrame(self.session, lp.LogicalCoalesce(self._plan, n))

    # --- actions -----------------------------------------------------------
    def collect(self) -> pd.DataFrame:
        return concat_host_frames(self.session._execute(self._plan),
                                  self.schema)

    to_pandas = collect

    def count_rows(self) -> int:
        return int(len(self.collect()))

    def collect_batches(self) -> List[DeviceBatch]:
        """The query up to its collect: the output DeviceBatches, still on
        the device (a plan whose root runs on the CPU gives frames)."""
        return self.session._execute(self._plan, collect=False)

    def explain(self, mode: str = "ALL") -> str:
        """The tag tree of the CPU plan: ``*`` on the device, ``!`` off it
        with the reason (spark.rapids.sql.explain)."""
        from spark_rapids_tpu_torch.sql.overrides import TpuOverrides
        overrides = TpuOverrides(self.session.conf)
        overrides.apply(Planner(self.session.conf).plan(self._plan))
        text = overrides.explain_text(mode)
        print(text)
        return text


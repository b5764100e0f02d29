"""Process-wide structured event journal (JSONL) and always-on flight
recorder (counterpart of the JAX package's ``obs/events.py``).

Every subsystem reports durable facts through ``EVENTS.emit(kind,
**fields)``; with the journal on they land as line-delimited JSON that
``tools/trace_summary.py`` summarizes. One JSON object a line; every
event carries ``kind``, ``ts`` (epoch seconds), ``seq`` and, between
queryStart and queryEnd, ``query`` (and ``tenant`` where the session has a
job group, ``session.set_job_group``). The kinds the port produces, with
the JAX package's names and fields:

  queryStart        session      confFingerprint
  queryPlan         session      planDigest, planTree, tpuOps, cpuOps,
                                 coveragePct
  cpuFallback       session      op, describe, reasons[] (the tag pass's)
  queryEnd          session      status success|failed, wall_s, error,
                                 rowsReturned, tpuOps, cpuOps,
                                 coveragePct, cpuOpTime {op: seconds}
  flightRecorder    session      reason, count, events[], syncs[] (the
                                 ring and the sync ledger's tail)
  hostSync          obs          site, seconds, bytes, op
                                 (obs/syncledger.py)
  spill             memory       direction, bytes, buffer (memory/spill.py)
  memoryPressure    memory       neededBytes, freedBytes (a spill pass), or
                                 buffer, diskWriteError (a failed write)
  scanStall         scan         split, stall_s (sql/scan_pipeline.py)
  scanBudgetStall   scan         split (prefetch submission backpressure)
  scanDeviceFallback scan        column, reason, path, rowGroup
                                 (ops/parquet_decode.py)
  broadcastMaterialized exec     bytes, batches (exec/tpujoin.py)
  outOfCore         exec         op, fanout, bytes, budgetBytes, level
                                 (exec/outofcore.py)
  aggSkipDecision   exec         decision skip|update, source measured|
                                 cache, measuredRatio, batches, threshold
                                 (exec/tpu.py)
  fetchRetry        exec         peer, attempt, error (exec/tpu.py retry
                                 loop of the shuffle manager route)
  fetchFailure      shuffle      peer, blocks, error (shuffle/client.py)
  shuffleSkew       shuffle      source, partitions, totalBytes, maxBytes,
                                 medianBytes, maxMedianRatio: every
                                 materialized shuffle's size distribution
                                 (obs/shuffleobs.py)

  aqeStageStats     adaptive     stage, partitions, maps, totalBytes,
                                 maxBytes, medianBytes, rows, compiles,
                                 syncs (sql/adaptive/executor.py; also
                                 aqeCoalesce, aqeBroadcastDemote,
                                 aqeSkewSplit with each rule's decision)
  queryCancelled    serving      reason, wall_s, events[] (the flight
                                 recorder's tail), syncs[], compiles[]
                                 (a cancelled job, at a batch pull; a job
                                 cancelled while queued: jobId, queued)
  queryTimeout      serving      deadlineSeconds, reason, events[], syncs[]
                                 (a job past its deadline; queued=true when
                                 it never started)
  planCacheHit      serving      planDigest (tag and convert skipped,
                                 serving/caches.py)
  resultCacheHit    serving      planDigest, rows (answered from the
                                 result cache: no launch, no sync)
  aqeExchangeReuse  serving      stage, reusedFrom, totalBytes, partitions
                                 (a stage adopted from another query)
  queryShed         serving      tenant, queueDepth, jobId (the admission
                                 queue was full; the router's carries
                                 replica)
  compileCacheMiss  compile      library (an nvcc library not built in the
                                 build directory, obs/compilecache.py)
  backendCompile    compile      library, seconds (one nvcc run)
  diagnostics       monitor      reason, threads{name: stack[]},
                                 queries[], syncs[] (SIGUSR1 or
                                 obs/monitor.dump_diagnostics)
  fleetPlacement    fleet        tenant, replica, reason sticky|override|
                                 spillover, previous (serving/fleet/)
  workerDrain       fleet        replica, inflight (a rolling restart
                                 quiesced a worker)
  workerReady       fleet        replica, aot{warmed, pending, skipped,
                                 ...}, ready, waitSeconds (a replacement
                                 worker booted and pre-warmed)
  workerLost        fleet        replica, inflightFailed (a worker process
                                 died; its in-flight jobs end "lost")

Journal mechanics, as in the JAX package:

  * thread-safe: one lock serializes seq assignment, the ring append and
    the file write (the scan's planning threads emit concurrently);
  * size-bounded with rotation: past ``spark.rapids.tpu.eventLog.
    maxFileBytes`` the file rotates to ``<path>.1`` (older rotations shift
    up, ``eventLog.rotatedFiles`` kept; gzipped as ``<path>.1.gz`` under
    ``eventLog.compress``); ``rotations``, ``rotate_failures`` and
    ``dropped`` (failed writes) surface in the profile report's
    ``observability`` section;
  * off by default: without ``spark.rapids.tpu.eventLog.enabled`` (or a
    non-empty ``eventLog.path``) nothing touches the filesystem, and
    events only feed the flight recorder.

The flight recorder is a bounded ring of the last N events
(``eventLog.flightRecorderSize``), kept at the cost of a deque append
with the journal and the tracer off; while the tracer is on its spans
mirror into the ring too (``TRACER.flight_hook``). A failed query dumps
the ring into the journal as one ``flightRecorder`` event, and
``session.dump_flight_recorder()`` returns the same snapshot.
"""

from __future__ import annotations

import collections
import hashlib
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

DEFAULT_PATH = "tpu-eventlog.jsonl"
DEFAULT_MAX_BYTES = 16 << 20
DEFAULT_ROTATIONS = 2
DEFAULT_RING_SIZE = 256


def conf_fingerprint(settings: Dict[str, Any]) -> str:
    """Stable short hash of a conf settings dict: two queries with the
    same fingerprint ran under the same explicit configuration (defaults
    excluded - they are code, not configuration)."""
    blob = json.dumps({k: str(v) for k, v in settings.items()},
                      sort_keys=True)
    return hashlib.sha1(blob.encode("utf-8")).hexdigest()[:12]


def plan_digest(plan) -> str:
    """Short structural hash of a physical plan (describe() of every node
    in walk order): the cross-run join key for "the same query shape"."""
    blob = "\n".join(n.describe() for n in plan.walk())
    return hashlib.sha1(blob.encode("utf-8")).hexdigest()[:12]


class EventLog:
    """One process-wide journal; ``EVENTS`` is the shared instance."""

    def __init__(self, ring_size: int = DEFAULT_RING_SIZE):
        self._lock = threading.Lock()
        self.enabled = False
        self.path = ""
        self.max_bytes = DEFAULT_MAX_BYTES
        self.max_rotations = DEFAULT_ROTATIONS
        self._fh = None
        self._written = 0
        self._seq = 0
        self._query_counter = 0
        self._current_query: Optional[str] = None
        # tenant/job-group window (session.set_job_group): like the query
        # window, every event between queryStart/queryEnd carries it
        self._current_tenant: Optional[str] = None
        # one open window PER EXECUTING THREAD (thread ident -> (query
        # id, tenant)): events emitted on a query's thread attribute to
        # its window; threads without one (the scan's planning pool)
        # fall back to the most recently opened window
        self._windows: Dict[int, tuple] = {}
        # the query id last opened on each thread (the scheduler reads it)
        self._last_by_thread: Dict[int, str] = {}
        # gzip rotated segments (spark.rapids.tpu.eventLog.compress)
        self.compress = False
        # truncation visibility (profile "observability" section)
        self.dropped = 0      # events whose file write failed
        self.rotations = 0
        self.rotate_failures = 0  # size bound breached, rename failed
        self._ring: collections.deque = collections.deque(
            maxlen=max(1, ring_size))

    # -- configuration ------------------------------------------------------
    def configure(self, enabled: bool, path: str = "",
                  max_bytes: int = DEFAULT_MAX_BYTES,
                  rotations: int = DEFAULT_ROTATIONS,
                  ring_size: Optional[int] = None,
                  compress: bool = False) -> None:
        """(Re)configure the journal. A non-empty ``path`` implies
        enabled; enabled with no path writes ``DEFAULT_PATH``. Reopening
        appends - one journal accumulates across sessions/queries."""
        with self._lock:
            enabled = bool(enabled) or bool(path)
            path = path or (DEFAULT_PATH if enabled else "")
            if self._fh is not None and (not enabled
                                         or path != self.path):
                self._close_locked()
            self.enabled = enabled
            self.path = path
            self.max_bytes = max(1, int(max_bytes))
            self.max_rotations = max(0, int(rotations))
            self.compress = bool(compress)
            if ring_size is not None and \
                    self._ring.maxlen != max(1, int(ring_size)):
                self._ring = collections.deque(
                    self._ring, maxlen=max(1, int(ring_size)))

    def configure_from_conf(self, conf) -> bool:
        """Session hook: read the ``spark.rapids.tpu.eventLog.*`` keys.
        Returns whether the journal is enabled."""
        path = str(conf.get("spark.rapids.tpu.eventLog.path", "") or "")
        enabled = conf.get_bool("spark.rapids.tpu.eventLog.enabled",
                                False) or bool(path)
        self.configure(
            enabled, path,
            max_bytes=int(conf.get(
                "spark.rapids.tpu.eventLog.maxFileBytes",
                DEFAULT_MAX_BYTES)),
            rotations=int(conf.get(
                "spark.rapids.tpu.eventLog.rotatedFiles",
                DEFAULT_ROTATIONS)),
            ring_size=int(conf.get(
                "spark.rapids.tpu.eventLog.flightRecorderSize",
                DEFAULT_RING_SIZE)),
            compress=conf.get_bool(
                "spark.rapids.tpu.eventLog.compress", False))
        return self.enabled

    def close(self) -> None:
        with self._lock:
            self._close_locked()

    def _close_locked(self) -> None:
        if self._fh is not None:
            try:
                self._fh.close()
            except OSError:
                pass
            self._fh = None
        self._written = 0

    # -- recording ----------------------------------------------------------
    def emit(self, kind: str, **fields) -> Dict[str, Any]:
        """Record one durable fact. Always lands in the flight-recorder
        ring; additionally appended to the JSONL journal when enabled.
        Never raises - a broken sink must not fail the query."""
        tid = threading.get_ident()
        with self._lock:
            self._seq += 1
            ev = {"kind": kind, "ts": round(time.time(), 6),
                  "seq": self._seq}
            win = self._windows.get(tid)
            qid = win[0] if win is not None else self._current_query
            tenant = win[1] if win is not None else self._current_tenant
            if qid is not None and "query" not in fields:
                ev["query"] = qid
            if tenant is not None and "tenant" not in fields:
                ev["tenant"] = tenant
            ev.update(fields)
            if kind != "flightRecorder":
                # a dump must never re-enter the ring: the next dump
                # would nest it and grow ~2x per failed query
                self._ring.append(ev)
            if self.enabled:
                self._write_locked(ev)
        return ev

    def _write_locked(self, ev: Dict[str, Any]) -> None:
        try:
            line = (json.dumps(ev, default=str) + "\n").encode("utf-8")
            if self._fh is None:
                d = os.path.dirname(os.path.abspath(self.path))
                os.makedirs(d, exist_ok=True)
                self._fh = open(self.path, "ab")
                self._written = self._fh.tell()
            if self._written + len(line) > self.max_bytes \
                    and self._written > 0:
                self._rotate_locked()
            self._fh.write(line)
            self._fh.flush()
            self._written += len(line)
        except (OSError, TypeError, ValueError):
            self.dropped += 1

    def _rotate_locked(self) -> None:
        """Shift ``path`` -> ``path.1`` -> ... -> ``path.<n>`` (oldest
        dropped); with rotatedFiles=0 the journal truncates in place.
        With ``compress`` on, the fresh rotation lands gzipped as
        ``path.1.gz`` (the shift chain handles both extensions, so a
        mid-run toggle leaves a readable mixed chain). When the rename
        fails (file-writable but directory-unwritable paths), appending
        continues on the oversized file with honest accounting -
        ``rotate_failures`` marks the breached size bound instead of
        faking a rotation."""
        try:
            self._fh.close()
        except OSError:
            pass
        self._fh = None
        try:
            if self.max_rotations > 0:
                for ext in ("", ".gz"):
                    oldest = f"{self.path}.{self.max_rotations}{ext}"
                    if os.path.exists(oldest):
                        os.unlink(oldest)
                for i in range(self.max_rotations - 1, 0, -1):
                    for ext in ("", ".gz"):
                        src = f"{self.path}.{i}{ext}"
                        if os.path.exists(src):
                            os.replace(src, f"{self.path}.{i + 1}{ext}")
                if self.compress:
                    import gzip
                    import shutil
                    dst_path = f"{self.path}.1.gz"
                    try:
                        # moderate level: the copy runs under the emit
                        # lock, so level 9's extra CPU would stall every
                        # concurrent emitter for the whole 16MB pass
                        with open(self.path, "rb") as src_f, \
                                gzip.open(dst_path, "wb",
                                          compresslevel=5) as dst_f:
                            shutil.copyfileobj(src_f, dst_f)
                    except OSError:
                        # a torn half-written .gz must not shadow data
                        # that still lives in the uncompressed active file
                        try:
                            os.unlink(dst_path)
                        except OSError:
                            pass
                        raise
                    os.unlink(self.path)
                else:
                    os.replace(self.path, f"{self.path}.1")
            else:
                os.unlink(self.path)
        except OSError:
            self.rotate_failures += 1
            self._fh = open(self.path, "ab")
            self._written = self._fh.tell()
            return
        self.rotations += 1
        self._fh = open(self.path, "ab")
        self._written = 0

    # -- query lifecycle ----------------------------------------------------
    def query_start(self, tenant: Optional[str] = None, **fields) -> str:
        """Open a query window: subsequent events auto-attach the query
        id - and the tenant/job-group tag, when one is set - until
        query_end. Returns the id (``q-<n>``, process-wide).

        One window PER THREAD: events emitted on the query's thread
        attribute to its window; threads without a window of their own
        (the scan's planning pool) fall back to the most recently opened
        one."""
        tid = threading.get_ident()
        with self._lock:
            self._query_counter += 1
            qid = f"q-{self._query_counter}"
            self._windows[tid] = (qid, tenant or None)
            self._last_by_thread[tid] = qid
            self._current_query = qid
            self._current_tenant = tenant or None
        self.emit("queryStart", query=qid, **fields)
        return qid

    def query_end(self, status: str, flight_dump: bool = False,
                  **fields) -> None:
        if flight_dump:
            self.dump_flight(reason=f"query {status}")
        self.emit("queryEnd", status=status, **fields)
        tid = threading.get_ident()
        with self._lock:
            self._windows.pop(tid, None)
            if self._windows:
                # another query is still in flight: cross-thread
                # emitters fall back to one of the remaining windows
                self._current_query, self._current_tenant = \
                    next(reversed(self._windows.values()))
            else:
                self._current_query = None
                self._current_tenant = None

    def last_query_on_thread(self) -> Optional[str]:
        """The query id last opened on this thread (kept after its
        queryEnd: the serving scheduler's job-to-journal key)."""
        return self._last_by_thread.get(threading.get_ident())

    @property
    def current_query(self) -> Optional[str]:
        win = self._windows.get(threading.get_ident())
        return win[0] if win is not None else self._current_query

    # -- flight recorder ----------------------------------------------------
    def flight_events(self) -> List[Dict[str, Any]]:
        """Snapshot of the ring, oldest first."""
        with self._lock:
            return list(self._ring)

    def dump_flight(self, reason: str = "manual") -> Dict[str, Any]:
        """Write the ring into the journal as ONE ``flightRecorder``
        event (the dump excludes itself), together with the sync ledger's
        tail. Returns the dump event."""
        snap = self.flight_events()
        try:
            from spark_rapids_tpu_torch.obs.syncledger import SYNC_LEDGER
            syncs = SYNC_LEDGER.tail()
        except Exception:  # noqa: BLE001 - a dump must never fail
            syncs = []
        return self.emit("flightRecorder", reason=reason, count=len(snap),
                         events=snap, syncs=syncs)

    def _note_span(self, ev: Dict[str, Any]) -> None:
        """Tracer hook (TRACER.flight_hook): mirror finished spans into
        the ring in compact form. Only called while tracing is enabled -
        the disabled-tracer hot path never reaches here."""
        entry = {"kind": "span", "name": ev.get("name"),
                 "ph": ev.get("ph"), "ts": ev.get("ts")}
        if "dur" in ev:
            entry["dur_us"] = ev["dur"]
        with self._lock:
            self._ring.append(entry)

    # -- tests --------------------------------------------------------------
    def reset_for_tests(self) -> None:
        with self._lock:
            self._close_locked()
            self.enabled = False
            self.path = ""
            self.max_bytes = DEFAULT_MAX_BYTES
            self.max_rotations = DEFAULT_ROTATIONS
            self.dropped = 0
            self.rotations = 0
            self.rotate_failures = 0
            self.compress = False
            self._current_query = None
            self._current_tenant = None
            self._windows.clear()
            self._last_by_thread.clear()
            self._ring.clear()


EVENTS = EventLog()

# spans feed the flight recorder whenever the tracer is on (the tracer
# itself stays import-light: the hook is just an attribute it calls)
from spark_rapids_tpu_torch.obs.trace import TRACER  # noqa: E402

TRACER.flight_hook = EVENTS._note_span


def open_event_file(path: str):
    """Text handle over a possibly-gzipped file, sniffed by magic bytes
    (not extension: a renamed ``.gz`` still reads). The shared opener of
    the event-log readers (``read_events``, ``tools/trace_summary.py``)."""
    import gzip
    with open(path, "rb") as f:
        magic = f.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(path, "rt", encoding="utf-8", errors="replace")
    return open(path, "r", encoding="utf-8", errors="replace")


def read_events(path: str) -> List[Dict[str, Any]]:
    """Load one journal INCLUDING its rotations (``path.<n>`` /
    ``path.<n>.gz`` oldest first, then ``path``; gzip segments from
    ``spark.rapids.tpu.eventLog.compress`` decompress transparently).
    Unparseable lines are skipped - a crashed writer can leave a torn
    tail."""
    files: List[str] = []
    # tolerate HOLES in the rotation chain: a failed compress (ENOSPC
    # mid-gzip) can leave e.g. '.1.gz' and '.3.gz' with no '.2' - a
    # break-on-first-gap walk would silently drop every older segment.
    # A short run of consecutive misses (not one) ends the scan.
    i, misses = 1, 0
    while misses < 4 and i <= 256:
        if os.path.exists(f"{path}.{i}.gz"):
            files.append(f"{path}.{i}.gz")
            misses = 0
        elif os.path.exists(f"{path}.{i}"):
            files.append(f"{path}.{i}")
            misses = 0
        else:
            misses += 1
        i += 1
    files.reverse()
    if os.path.exists(path):
        files.append(path)
    out: List[Dict[str, Any]] = []
    for f in files:
        with open_event_file(f) as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    ev = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if isinstance(ev, dict) and "kind" in ev:
                    out.append(ev)
    return out

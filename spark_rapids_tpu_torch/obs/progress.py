"""Live query progress (counterpart of the JAX package's
``obs/progress.py``): a process-wide ``ProgressTracker`` (``PROGRESS``)
of in-flight and recent queries.

  * the session registers one ``QueryProgress`` per query
    (``PROGRESS.begin``), attaches it as ``ctx.progress`` and closes it
    with the terminal state;
  * the operator wrapper (``exec/base.executed_partitions``) heartbeats
    each pulled batch through ``ctx.progress`` (per-operator rows where
    the host knows them, batches and time so far);
  * the scan pipeline (``sql/scan_pipeline.py``) reports splits planned
    and the consumer-stalled state, the uploads (``exec/transitions.py``)
    batches and rows uploaded, the shuffle client and the exchange's
    retry loop fetches, bytes, retries and failures, and the spill tiers
    their spills.

Everything is gated on ONE flag, ``PROGRESS.enabled``: off (the default)
every call site is one attribute check, ``ctx.progress`` stays None and
no lock is taken. The JAX package's monitor turns it on from
``spark.rapids.tpu.ui.enabled``; until ``obs/monitor.py`` is ported
(ROADMAP A.11), a caller does (``PROGRESS.configure(True)``) and reads
``PROGRESS.queries(full=True)``. Its AQE and compile groups wait for
their modules.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Dict, List, Optional

DEFAULT_RECENT = 64


class QueryProgress:
    """Mutable live record of one executing query; ``snapshot()`` is its
    JSON shape."""

    def __init__(self, qid: str, tenant: Optional[str] = None,
                 description: str = ""):
        self._lock = threading.Lock()
        self.id = qid
        self.tenant = tenant or "default"
        self.description = description or ""
        self.status = "running"
        self.error: Optional[str] = None
        self.start_ts = time.time()
        self.end_ts: Optional[float] = None
        self.heartbeats = 0
        self.updated_ts = self.start_ts
        # static plan rows: [{"depth", "op", "id"}]. The plan objects
        # are pinned in _plans: plan rows join to _ops by id(node), and a
        # freed node's recycled id could otherwise alias an unrelated
        # operator's stats onto a live tree row.
        self._plan_rows: List[Dict[str, Any]] = []
        self._plans: List[Any] = []
        # per-plan-node operator stats (id(node) keyed, like
        # ExecContext.node_stats); the snapshot's "operators" aggregate
        # sums them by describe() string
        self._ops: Dict[int, Dict[str, Any]] = {}
        # the adaptive (AQE) stage view (sql/adaptive/executor.py)
        self.adaptive = False
        self.stages_total = 0
        self.stages_materialized = 0
        self.stage_running: Optional[int] = None
        self.stages: List[Dict[str, Any]] = []
        self.decisions: List[Dict[str, Any]] = []
        self.scan = {"splitsDecoded": 0, "bytesDecoded": 0,
                     "batchesUploaded": 0, "rowsUploaded": 0,
                     "stalls": 0, "stalled": False}
        self.shuffle = {"fetches": 0, "bytes": 0, "retries": 0,
                        "failures": 0, "mapPartitions": 0}
        self.spill = {"events": 0, "bytes": 0}

    # -- updates (all called with PROGRESS.enabled already checked) --------
    def _beat_locked(self) -> None:
        self.heartbeats += 1
        self.updated_ts = time.time()

    def set_plan(self, plan) -> None:
        """Attach the physical plan tree."""
        rows: List[Dict[str, Any]] = []

        def rec(node, depth: int) -> None:
            rows.append({"depth": depth, "op": node.describe(),
                         "id": id(node)})
            for c in node.children:
                rec(c, depth + 1)
        rec(plan, 0)
        with self._lock:
            self._plan_rows = rows
            self._plans.append(plan)  # pin: id-keyed joins stay valid
            self._beat_locked()

    def op_batch(self, node_id: int, op: str, rows,
                 seconds: float) -> None:
        """One pulled batch of one operator (the heartbeat)."""
        with self._lock:
            st = self._ops.get(node_id)
            if st is None or st["op"] != op:
                # an op-string mismatch on the same id means CPython
                # recycled a freed node's id: start fresh rather than
                # merging two different operators' stats
                st = self._ops[node_id] = {"op": op, "rows": 0,
                                           "batches": 0, "time_s": 0.0}
            st["batches"] += 1
            if rows is not None:
                st["rows"] += int(rows)
            st["time_s"] = round(st["time_s"] + seconds, 6)
            self._beat_locked()

    def aqe_begin(self, total_stages: int) -> None:
        with self._lock:
            self.adaptive = True
            self.stages_total = int(total_stages)
            self._beat_locked()

    def aqe_stage_running(self, sid: int) -> None:
        with self._lock:
            self.stage_running = sid
            self._beat_locked()

    def aqe_stage_done(self, sid: int, **stats) -> None:
        with self._lock:
            self.stages_materialized += 1
            if self.stage_running == sid:
                self.stage_running = None
            self.stages.append(dict(stage=sid, ts=round(time.time(), 3),
                                    **stats))
            self._beat_locked()

    def aqe_decision(self, decision: Dict[str, Any]) -> None:
        with self._lock:
            self.decisions.append(dict(decision))
            self._beat_locked()

    def note(self, group: str, **deltas) -> None:
        """Add counter deltas to the scan, shuffle or spill group."""
        d = getattr(self, group)
        with self._lock:
            for k, v in deltas.items():
                d[k] = d.get(k, 0) + v
            self._beat_locked()

    def set_scan_stalled(self, stalled: bool) -> None:
        with self._lock:
            if stalled and not self.scan["stalled"]:
                self.scan["stalls"] += 1
            self.scan["stalled"] = bool(stalled)
            self._beat_locked()

    def finish(self, status: str, error: Optional[str] = None) -> None:
        with self._lock:
            self.status = status
            self.error = error
            self.end_ts = time.time()
            # a query that died mid-stall must not read as stalled
            # forever in the recent ring
            self.scan["stalled"] = False
            # release the pinned plan trees (they can hold broadcast
            # tables) while this record lives on in the recent ring; no
            # heartbeat arrives after the terminal state
            self._plans = []
            self._beat_locked()

    # -- snapshot -----------------------------------------------------------
    def snapshot(self, full: bool = True) -> Dict[str, Any]:
        with self._lock:
            now = time.time()
            out: Dict[str, Any] = {
                "id": self.id, "tenant": self.tenant,
                "description": self.description, "status": self.status,
                "error": self.error,
                "start_ts": round(self.start_ts, 3),
                "end_ts": round(self.end_ts, 3) if self.end_ts else None,
                "wall_s": round((self.end_ts or now) - self.start_ts, 3),
                "updated_ts": round(self.updated_ts, 3),
                "heartbeats": self.heartbeats,
                "scan": dict(self.scan), "shuffle": dict(self.shuffle),
                "spill": dict(self.spill),
            }
            if self.adaptive:
                out["aqe"] = {
                    "stagesTotal": self.stages_total,
                    "stagesMaterialized": self.stages_materialized,
                    "stageRunning": self.stage_running,
                    "stages": list(self.stages),
                    "decisions": list(self.decisions),
                }
            if not full:
                return out
            ops = {nid: dict(st) for nid, st in self._ops.items()}
            plan = []
            for row in self._plan_rows:
                r = {"depth": row["depth"], "op": row["op"]}
                st = ops.get(row["id"])
                if st is not None:
                    r.update(rows=st["rows"], batches=st["batches"],
                             time_s=round(st["time_s"], 6))
                plan.append(r)
            out["plan"] = plan
            # aggregate by operator describe() string
            agg: Dict[str, Dict[str, Any]] = {}
            for st in ops.values():
                a = agg.setdefault(st["op"], {"rows": 0, "batches": 0,
                                              "time_s": 0.0})
                a["rows"] += st["rows"]
                a["batches"] += st["batches"]
                a["time_s"] = round(a["time_s"] + st["time_s"], 6)
            out["operators"] = [dict(op=k, **v) for k, v in
                                sorted(agg.items(),
                                       key=lambda kv: -kv[1]["time_s"])]
            return out


class ProgressTracker:
    """Process-wide registry of in-flight and recently finished queries.

    ``enabled`` is THE hot-path gate: call sites check it (one attribute
    load) before touching anything else. ``current`` resolves the
    executing thread's in-flight record first, then the most recently
    begun query: threads without an ExecContext (the scan's planning
    pool, the spill tiers) attribute to that one.
    """

    def __init__(self, recent: int = DEFAULT_RECENT):
        self._lock = threading.Lock()
        self.enabled = False
        self._inflight: Dict[str, QueryProgress] = {}
        self._recent: collections.deque = collections.deque(
            maxlen=max(1, recent))
        self._current: Optional[QueryProgress] = None
        self._by_thread: Dict[int, QueryProgress] = {}

    def configure(self, enabled: bool,
                  recent: Optional[int] = None) -> None:
        with self._lock:
            self.enabled = bool(enabled)
            if recent is not None and \
                    self._recent.maxlen != max(1, int(recent)):
                self._recent = collections.deque(
                    self._recent, maxlen=max(1, int(recent)))

    # -- lifecycle ----------------------------------------------------------
    def begin(self, qid: str, tenant: Optional[str] = None,
              description: str = "") -> QueryProgress:
        qp = QueryProgress(qid, tenant=tenant, description=description)
        tid = threading.get_ident()
        with self._lock:
            self._inflight[qid] = qp
            self._by_thread[tid] = qp
            self._current = qp
        return qp

    def finish(self, qp: QueryProgress, status: str,
               error: Optional[str] = None) -> None:
        qp.finish(status, error)
        tid = threading.get_ident()
        with self._lock:
            self._inflight.pop(qp.id, None)
            self._recent.append(qp)
            if self._by_thread.get(tid) is qp:
                del self._by_thread[tid]
            if self._current is qp:
                # another thread's query may still be in flight: keep a
                # live fallback for cross-thread attributions
                self._current = next(iter(self._inflight.values()), None)

    @property
    def current(self) -> Optional[QueryProgress]:
        qp = self._by_thread.get(threading.get_ident())
        return qp if qp is not None else self._current

    # -- hot-path helpers (caller already checked ``enabled``) --------------
    def scan_split(self, nbytes: int) -> None:
        qp = self.current
        if qp is not None:
            qp.note("scan", splitsDecoded=1, bytesDecoded=int(nbytes))

    def scan_stalled(self, stalled: bool) -> None:
        qp = self.current
        if qp is not None:
            qp.set_scan_stalled(stalled)

    def scan_upload(self, rows: int) -> None:
        qp = self.current
        if qp is not None:
            qp.note("scan", batchesUploaded=1, rowsUploaded=int(rows))

    def shuffle_fetch(self, nbytes: int) -> None:
        qp = self.current
        if qp is not None:
            qp.note("shuffle", fetches=1, bytes=int(nbytes))

    def shuffle_retry(self) -> None:
        qp = self.current
        if qp is not None:
            qp.note("shuffle", retries=1)

    def shuffle_failure(self) -> None:
        qp = self.current
        if qp is not None:
            qp.note("shuffle", failures=1)

    def shuffle_map_partition(self) -> None:
        qp = self.current
        if qp is not None:
            qp.note("shuffle", mapPartitions=1)

    def spill(self, nbytes: int) -> None:
        qp = self.current
        if qp is not None:
            qp.note("spill", events=1, bytes=int(nbytes))

    # -- introspection ------------------------------------------------------
    def get(self, qid: str) -> Optional[QueryProgress]:
        with self._lock:
            qp = self._inflight.get(qid)
            if qp is not None:
                return qp
            for r in self._recent:
                if r.id == qid:
                    return r
        return None

    def queries(self, full: bool = False) -> List[Dict[str, Any]]:
        """Snapshots: in-flight first, then recently finished newest
        first. ``full=False`` omits the per-operator and plan detail."""
        with self._lock:
            inflight = list(self._inflight.values())
            recent = list(self._recent)
        return ([qp.snapshot(full=full) for qp in inflight]
                + [qp.snapshot(full=full) for qp in reversed(recent)])

    def inflight_by_tenant(self) -> Dict[str, int]:
        """In-flight queries by tenant (the monitor's census)."""
        with self._lock:
            out: Dict[str, int] = {}
            for qp in self._inflight.values():
                out[qp.tenant] = out.get(qp.tenant, 0) + 1
            return out

    def reset_for_tests(self) -> None:
        with self._lock:
            self.enabled = False
            self._inflight.clear()
            self._recent.clear()
            self._by_thread.clear()
            self._current = None


PROGRESS = ProgressTracker()

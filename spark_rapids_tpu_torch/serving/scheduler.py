"""Admission controller and weighted-fair query scheduler (counterpart of
the JAX package's ``serving/scheduler.py``).

The serving front end of a session: queries are submitted as **jobs** and
run on a pool of worker threads over one session, with the engine's
per-query isolation (a thread's own ExecContext, event window and progress
record, the tenant budgets of the task semaphore) underneath.

  * **per-tenant FIFO lanes**: each tenant's jobs run in submission order;
  * **weighted-fair pick across lanes**: the dispatcher picks the
    non-empty lane with the least *virtual time*, and serving a job
    advances it by ``1/weight``
    (``spark.rapids.tpu.serving.tenant.<t>.weight``, default
    ``tenant.defaultWeight``); an idle lane's virtual time is clamped
    forward on its first enqueue, so it banks no credit;
  * **bounded queue with load shed**: past
    ``spark.rapids.tpu.serving.maxQueuedQueries`` queued jobs a submission
    is rejected at once (status ``shed``, a ``queryShed`` event, the
    ``serving.shed`` counter);
  * **deadlines from submission**: ``deadline_s`` (default
    ``serving.defaultDeadlineSeconds``, 0 = none); a job still queued past
    it never starts, a running one stops at its next batch pull
    (``serving/cancellation.py`` -> ``exec/base.py``);
    ``submit(queued_elapsed_s=...)`` counts a fleet router's queue time
    (``serving/fleet/``) from the original submission;
  * **cooperative cancellation**: ``cancel(id)`` dequeues a queued job at
    once and flags a running one, honored at its next batch pull;
  * **tenant budgets**: ``spark.rapids.tpu.serving.tenant.<t>.permits``
    (default ``tenant.defaultPermits``; 0 = the global limit only) goes
    into the session's task semaphore.

Every worker thread launches on the current CUDA stream of the device:
kernels of concurrent jobs queue on one stream in launch order, which the
caching allocator's stream-ordered reuse and B1's ticket per (device,
stream) (``ops/kernels``) rely on. ``snapshot()`` is the monitor's
``/api/scheduler`` shape (``obs/monitor.py``).
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Union

from spark_rapids_tpu_torch.serving.cancellation import (
    CancelScope, QueryCancelled, QueryTimeout, SchedulerOverloaded,
    serving_context,
)

WORKERS = "spark.rapids.tpu.serving.workers"
MAX_QUEUED = "spark.rapids.tpu.serving.maxQueuedQueries"
DEFAULT_DEADLINE = "spark.rapids.tpu.serving.defaultDeadlineSeconds"
TENANT_DEFAULT_PERMITS = "spark.rapids.tpu.serving.tenant.defaultPermits"
TENANT_DEFAULT_WEIGHT = "spark.rapids.tpu.serving.tenant.defaultWeight"

# live schedulers for /api/scheduler (weak: a dropped scheduler must not
# be pinned by the monitoring surface)
_ACTIVE: "weakref.WeakSet[QueryScheduler]" = weakref.WeakSet()


class QueryJob:
    """One submitted query: status machine
    queued -> running -> succeeded|failed|cancelled|timeout, or the
    terminal admission states shed (queue full) and cancelled (while
    queued)."""

    def __init__(self, job_id: str, work, tenant: str, description: str,
                 deadline_s: Optional[float],
                 queued_elapsed_s: float = 0.0):
        self.id = job_id
        self.work = work  # DataFrame or callable(session) -> DataFrame
        self.tenant = tenant
        self.description = description
        self.scope = CancelScope(deadline_s, elapsed_s=queued_elapsed_s)
        self.status = "queued"
        self.error: Optional[str] = None
        self.result = None  # pd.DataFrame on success
        self.query_id: Optional[str] = None  # journal q-<n> once running
        self.submitted_ts = time.time()
        self.started_ts: Optional[float] = None
        self.finished_ts: Optional[float] = None
        self._done = threading.Event()

    @property
    def wall_s(self) -> Optional[float]:
        if self.finished_ts is None:
            return None
        return round(self.finished_ts - self.submitted_ts, 6)

    def done(self) -> bool:
        return self._done.is_set()

    def wait(self, timeout: Optional[float] = None) -> str:
        """Block until terminal; returns the final status."""
        self._done.wait(timeout)
        return self.status

    def get(self, timeout: Optional[float] = None):
        """Result frame, or raise the job's terminal error."""
        if not self._done.wait(timeout):
            raise TimeoutError(f"{self.id} still {self.status}")
        if self.status == "succeeded":
            return self.result
        exc = {"shed": SchedulerOverloaded, "cancelled": QueryCancelled,
               "timeout": QueryTimeout}.get(self.status, RuntimeError)
        raise exc(self.error or self.status)

    def cancel(self, reason: str = "cancelled by caller") -> None:
        self.scope.cancel(reason)

    def snapshot(self) -> Dict[str, Any]:
        return {
            "id": self.id, "tenant": self.tenant,
            "description": self.description, "status": self.status,
            "query": self.query_id, "error": self.error,
            "submitted_ts": round(self.submitted_ts, 3),
            "started_ts": round(self.started_ts, 3)
            if self.started_ts else None,
            "wall_s": self.wall_s,
            "deadline_s": self.scope.deadline_s,
        }


class QueryScheduler:
    """Admission + dispatch over one session. Thread-safe; the caller
    owns the lifecycle (``close()``)."""

    _ids = itertools.count(1)

    def __init__(self, session, workers: Optional[int] = None,
                 max_queue: Optional[int] = None):
        self.session = session
        conf = session.conf
        self.workers = max(1, int(workers if workers is not None
                                  else conf.get_int(WORKERS, 4)))
        self.max_queue = max(1, int(max_queue if max_queue is not None
                                    else conf.get_int(MAX_QUEUED, 128)))
        self._cond = threading.Condition()
        self._lanes: Dict[str, collections.deque] = {}
        self._vtime: Dict[str, float] = {}
        self._jobs: "collections.OrderedDict[str, QueryJob]" = \
            collections.OrderedDict()
        self._running: Dict[str, QueryJob] = {}
        self._queued = 0
        self._closed = False
        self.peak_running = 0
        self.shed_count = 0
        self._tenant_stats: Dict[str, Dict[str, int]] = {}
        self._known_tenants: set = set()
        self._threads = [
            threading.Thread(target=self._worker_loop,
                             name=f"tpu-serve-{i}", daemon=True)
            for i in range(self.workers)]
        for t in self._threads:
            t.start()
        _ACTIVE.add(self)

    # -- tenant config -------------------------------------------------------
    def _tenant_conf(self, tenant: str, leaf: str, default):
        v = self.session.conf.get(
            f"spark.rapids.tpu.serving.tenant.{tenant}.{leaf}")
        return default if v is None else v

    def _weight(self, tenant: str) -> float:
        default = float(self.session.conf.get(TENANT_DEFAULT_WEIGHT, 1.0))
        try:
            w = float(self._tenant_conf(tenant, "weight", default))
        except (TypeError, ValueError):
            w = default
        return w if w > 0 else default

    def _register_tenant(self, tenant: str) -> None:
        """First sighting of a tenant: install its permit budget
        into the task semaphore (the quota scoreboard the monitor
        reads)."""
        if tenant in self._known_tenants:
            return
        self._known_tenants.add(tenant)
        sem = self.session.semaphore
        if sem is None:
            return
        default = self.session.conf.get_int(TENANT_DEFAULT_PERMITS, 0)
        budgets = {}
        for t in self._known_tenants:
            try:
                budgets[t] = int(self._tenant_conf(t, "permits", default))
            except (TypeError, ValueError):
                budgets[t] = default
        sem.configure_tenants(budgets, default=default)

    def _tstats(self, tenant: str) -> Dict[str, int]:
        return self._tenant_stats.setdefault(
            tenant, {"submitted": 0, "shed": 0, "succeeded": 0,
                     "failed": 0, "cancelled": 0, "timeout": 0})

    # -- submission ----------------------------------------------------------
    def submit(self, work: Union[Callable, Any], tenant: str = "default",
               description: str = "",
               deadline_s: Optional[float] = None,
               queued_elapsed_s: float = 0.0) -> QueryJob:
        """Enqueue one query: a DataFrame, or a callable
        ``fn(session) -> DataFrame`` built lazily on the worker. Returns
        immediately; the job may come back already ``shed`` when the
        admission queue is full.

        ``queued_elapsed_s`` is deadline budget already spent UPSTREAM
        (a fleet router's queue, serving/fleet/): the deadline counts
        from the original submission, not from this process's admission
        — a submission whose upstream wait alone exceeded the deadline
        is timed out immediately instead of running a dead query."""
        from spark_rapids_tpu_torch.obs.events import EVENTS
        from spark_rapids_tpu_torch.obs.metrics import REGISTRY
        tenant = str(tenant or "default")
        if deadline_s is None:
            d = float(self.session.conf.get(DEFAULT_DEADLINE, 0) or 0)
            deadline_s = d if d > 0 else None
        job = QueryJob(f"job-{next(self._ids)}", work, tenant,
                       description, deadline_s,
                       queued_elapsed_s=queued_elapsed_s)
        if job.scope.deadline_s is not None and job.scope.expired():
            # dead on arrival: the upstream queue already burned the
            # whole deadline — never enqueue, never touch the engine
            job.status = "timeout"
            job.error = (f"deadline ({job.scope.deadline_s:.3f}s) "
                         f"expired before admission (upstream queue "
                         f"{job.scope.elapsed_s:.3f}s)")
            job.finished_ts = time.time()
            job._done.set()
            with self._cond:
                if self._closed:
                    raise RuntimeError("scheduler is closed")
                self._register_tenant(tenant)
                self._tstats(tenant)["timeout"] = \
                    self._tstats(tenant).get("timeout", 0) + 1
                self._jobs[job.id] = job
            EVENTS.emit("queryTimeout", tenant=tenant, query=None,
                        jobId=job.id, queued=True,
                        deadlineSeconds=job.scope.deadline_s,
                        queuedElapsedSeconds=round(
                            job.scope.elapsed_s, 3),
                        reason=job.error)
            REGISTRY.counter("serving.completed", tenant=tenant,
                             status="timeout").add(1)
            return job
        with self._cond:
            if self._closed:
                raise RuntimeError("scheduler is closed")
            self._register_tenant(tenant)
            stats = self._tstats(tenant)
            if self._queued >= self.max_queue:
                # load-shed: reject NOW rather than building an
                # unbounded backlog the deadline would kill anyway
                job.status = "shed"
                job.error = (f"admission queue full "
                             f"({self._queued}/{self.max_queue})")
                job.finished_ts = time.time()
                job._done.set()
                self.shed_count += 1
                stats["shed"] += 1
                self._jobs[job.id] = job
                queue_depth = self._queued
            else:
                stats["submitted"] += 1
                lane = self._lanes.get(tenant)
                if lane is None:
                    lane = self._lanes[tenant] = collections.deque()
                if not lane:
                    # an idle lane must not have banked credit: clamp
                    # its virtual time forward to the least-served
                    # ACTIVE lane so a returning tenant competes fairly
                    # instead of monopolizing the pool
                    active = [self._vtime.get(t, 0.0)
                              for t, q in self._lanes.items()
                              if q and t != tenant]
                    base = min(active) if active else 0.0
                    self._vtime[tenant] = max(
                        self._vtime.get(tenant, 0.0), base)
                lane.append(job)
                self._queued += 1
                self._jobs[job.id] = job
                self._cond.notify()
                queue_depth = self._queued
        if job.status == "shed":
            REGISTRY.counter("serving.shed", tenant=tenant).add(1)
            # query=None: no journal window belongs to this job — the
            # emit-time fallback would misattribute it to whatever query
            # happens to be in flight on another worker
            EVENTS.emit("queryShed", tenant=tenant, query=None,
                        queueDepth=queue_depth, jobId=job.id)
        else:
            # mirrors the per-tenant "submitted" stat (shed is counted
            # separately on BOTH surfaces, so shed rates agree)
            REGISTRY.counter("serving.submitted", tenant=tenant).add(1)
        return job

    # -- dispatch ------------------------------------------------------------
    def _pick_locked(self) -> Optional[QueryJob]:
        """Weighted fair pick: the non-empty lane with the smallest
        virtual time; serving advances it by 1/weight."""
        best = None
        for tenant, lane in self._lanes.items():
            if not lane:
                continue
            vt = self._vtime.get(tenant, 0.0)
            if best is None or vt < best[0]:
                best = (vt, tenant)
        if best is None:
            return None
        _vt, tenant = best
        job = self._lanes[tenant].popleft()
        self._queued -= 1
        self._vtime[tenant] = \
            self._vtime.get(tenant, 0.0) + 1.0 / self._weight(tenant)
        return job

    def _worker_loop(self) -> None:
        while True:
            with self._cond:
                while not self._closed and self._queued == 0:
                    self._cond.wait()
                if self._closed and self._queued == 0:
                    return
                job = self._pick_locked()
                if job is None:
                    continue
                self._running[job.id] = job
                self.peak_running = max(self.peak_running,
                                        len(self._running))
            try:
                self._run(job)
            finally:
                with self._cond:
                    self._running.pop(job.id, None)
                    self._cond.notify_all()

    def _run(self, job: QueryJob) -> None:
        from spark_rapids_tpu_torch.obs.events import EVENTS
        from spark_rapids_tpu_torch.obs.metrics import REGISTRY
        # a job dead before it starts (cancelled in queue / deadline
        # burned in queue) never touches the engine
        status = None
        if job.scope.cancelled:
            status, job.error = "cancelled", job.scope.reason
        elif job.scope.expired():
            status = "timeout"
            job.error = (f"deadline ({job.scope.deadline_s:.3f}s) "
                         f"expired while queued")
            EVENTS.emit("queryTimeout", tenant=job.tenant,
                        query=None, jobId=job.id, queued=True,
                        deadlineSeconds=job.scope.deadline_s,
                        reason=job.error)
        if status is not None:
            self._finish(job, status)
            return
        job.status = "running"
        job.started_ts = time.time()
        try:
            with serving_context(job.tenant, job.scope):
                self.session._set_thread_job_group(job.tenant,
                                                   job.description)
                work = job.work
                df = work(self.session) if callable(work) else work
                try:
                    job.result = df.collect()
                finally:
                    # the journal id this job's query ran under, for
                    # cross-referencing /api/scheduler with the event log
                    job.query_id = EVENTS.last_query_on_thread()
            status = "succeeded"
        except QueryTimeout as e:
            status, job.error = "timeout", str(e)[:300]
        except QueryCancelled as e:
            status, job.error = "cancelled", str(e)[:300]
        except BaseException as e:  # noqa: BLE001 — job-terminal, reported
            status = "failed"
            job.error = f"{type(e).__name__}: {e}"[:300]
        self._finish(job, status)
        REGISTRY.counter("serving.completed", tenant=job.tenant,
                         status=status).add(1)

    def _finish(self, job: QueryJob, status: str) -> None:
        job.status = status
        job.finished_ts = time.time()
        job._done.set()
        with self._cond:
            self._tstats(job.tenant)[status] = \
                self._tstats(job.tenant).get(status, 0) + 1

    # -- introspection / control ---------------------------------------------
    def job(self, job_id: str) -> Optional[QueryJob]:
        with self._cond:
            return self._jobs.get(job_id)

    def status(self, job_id: str) -> Optional[Dict[str, Any]]:
        j = self.job(job_id)
        return None if j is None else j.snapshot()

    def cancel(self, job_id: str,
               reason: str = "cancelled by caller") -> bool:
        """Cancel a job: queued -> terminal immediately; running ->
        cooperative (honored at its next batch-pull boundary)."""
        j = self.job(job_id)
        if j is None or j.done():
            return False
        j.scope.cancel(reason)
        with self._cond:
            for lane in self._lanes.values():
                if j in lane:
                    lane.remove(j)
                    self._queued -= 1
                    break
            else:
                return True  # running: the scope flag does the work
        from spark_rapids_tpu_torch.obs.events import EVENTS
        EVENTS.emit("queryCancelled", tenant=j.tenant, query=None,
                    jobId=j.id, queued=True, reason=reason, events=[],
                    compiles=[])
        j.error = reason  # before _finish: waiters wake seeing both
        self._finish(j, "cancelled")
        return True

    def jobs(self) -> List[Dict[str, Any]]:
        with self._cond:
            return [j.snapshot() for j in self._jobs.values()]

    def queue_depth(self) -> int:
        with self._cond:
            return self._queued

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Wait until every submitted job is terminal."""
        end = (time.monotonic() + timeout) if timeout else None
        with self._cond:
            jobs = list(self._jobs.values())
        for j in jobs:
            left = None if end is None else max(0.0, end - time.monotonic())
            if not j._done.wait(left):
                return False
        return True

    def close(self, cancel_pending: bool = True,
              timeout: Optional[float] = 30.0) -> None:
        """Stop admission; optionally cancel still-queued jobs; wait for
        the workers to finish their running queries."""
        with self._cond:
            self._closed = True
            pending = []
            if cancel_pending:
                for lane in self._lanes.values():
                    pending.extend(lane)
                    lane.clear()
                self._queued = 0
            self._cond.notify_all()
        for j in pending:
            j.scope.cancel("scheduler closed")
            j.error = "scheduler closed"
            self._finish(j, "cancelled")
        for t in self._threads:
            t.join(timeout)
        _ACTIVE.discard(self)

    def snapshot(self) -> Dict[str, Any]:
        """The /api/scheduler shape: queue depth, running set,
        per-tenant lanes + quota usage, shed counts."""
        sem = self.session.semaphore
        quota = sem.tenant_usage() if sem is not None else {}
        with self._cond:
            tenants: Dict[str, Any] = {}
            for t in sorted(self._known_tenants | set(self._lanes)
                            | set(quota)):
                stats = dict(self._tstats(t))
                tenants[t] = {
                    "queued": len(self._lanes.get(t, ())),
                    "running": sum(1 for j in self._running.values()
                                   if j.tenant == t),
                    "weight": self._weight(t),
                    "vtime": round(self._vtime.get(t, 0.0), 4),
                    "quota": quota.get(t, {"held": 0, "waiting": 0,
                                           "budget": 0}),
                    **stats,
                }
            return {
                "workers": self.workers,
                "maxQueuedQueries": self.max_queue,
                "queueDepth": self._queued,
                "running": [j.snapshot() for j in
                            self._running.values()],
                "peakRunning": self.peak_running,
                "shedTotal": self.shed_count,
                "closed": self._closed,
                "tenants": tenants,
            }


def snapshot_all() -> Dict[str, Any]:
    """Every live scheduler's snapshot (the monitor's /api/scheduler
    endpoint; empty list when no scheduler exists)."""
    return {"schedulers": [s.snapshot() for s in list(_ACTIVE)]}

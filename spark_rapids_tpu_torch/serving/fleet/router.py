"""Fleet router: sticky placement, deadline propagation, rolling
restarts (counterpart of the JAX package's ``serving/fleet/router.py``).

The front end of the multi-process serving tier. One ``FleetRouter``
owns N worker handles, ``ProcessWorker`` (a ``fleet/worker.py`` process
over JSON lines; several of them share one card, each with its own
``spark.rapids.memory.tpu.allocFraction`` of it) or ``LocalWorker`` (an
in-process ``QueryScheduler``, the tests' double), and routes tenant
submissions over them:

  * **placement** is ``placement.PlacementPolicy`` (override map, then
    consistent-hash sticky, then least-loaded spill-over past
    ``fleet.spillover.queueDepth``), decided at dispatch against live
    router-side queue depths: a draining or lost replica is no
    candidate;
  * **deadline propagation**: the router stamps each job at submission
    and forwards its queue seconds with the dispatch; the worker's
    scheduler counts the deadline from the original submission
    (``QueryScheduler.submit(queued_elapsed_s=...)``);
  * **shed propagation**: a worker-side shed comes back as the job's
    status and again in the router's journal as ``queryShed`` with the
    replica;
  * **rolling restarts** (``rolling_restart``): quiesce the worker
    (``workerDrain``), drain its in-flight jobs, boot the replacement
    from the shared nvcc build directory and pre-warmed from the warm
    manifest (``workerReady`` once its pass ended), swap the handle,
    stop the old one: no job shed, no nvcc run;
  * **crash handling**: a dead worker's in-flight jobs fail ``worker
    lost``, a ``workerLost`` event carries the replica and the failed
    count, and its tenants re-place onto the survivors.

``snapshot()`` is the ``/api/fleet`` shape (``FleetMonitor`` in a router
process, or the live monitor's ``/api/fleet`` where a router runs in
process); the ``fleet.*`` counters render as ``srt_fleet_*``.
"""

from __future__ import annotations

import collections
import itertools
import json
import os
import subprocess
import sys
import threading
import time
import weakref
from typing import Any, Callable, Dict, List, Optional

from spark_rapids_tpu_torch.serving.fleet.placement import (
    PlacementPolicy, parse_overrides,
)

_ACTIVE_ROUTERS: "weakref.WeakSet[FleetRouter]" = weakref.WeakSet()


def snapshot_all() -> Dict[str, Any]:
    """Every live router's snapshot (the monitor's ``/api/fleet``
    route resolves this lazily — an empty list when no fleet runs)."""
    return {"fleets": [r.snapshot(include_workers=False)
                       for r in list(_ACTIVE_ROUTERS)]}


class FleetJob:
    """One routed submission: status machine queued -> dispatched ->
    succeeded|failed|cancelled|timeout|shed|lost. The terminal status
    is the WORKER's job status, verbatim, plus the router-only
    terminals ``lost`` (worker died mid-flight) and ``cancelled``
    (router shut down before dispatch)."""

    def __init__(self, job_id: str, tenant: str, description: str,
                 deadline_s: Optional[float], query: Any,
                 want_result: bool):
        self.id = job_id
        self.tenant = tenant
        self.description = description
        self.deadline_s = deadline_s
        self.query = query
        self.want_result = want_result
        self.status = "queued"
        self.error: Optional[str] = None
        self.replica: Optional[str] = None
        self.reason: Optional[str] = None  # placement reason
        self.rows: Optional[int] = None
        self.wall_s: Optional[float] = None
        self.query_id: Optional[str] = None
        self._result_payload: Optional[str] = None
        self.submitted_ts = time.time()
        self.created_mono = time.monotonic()
        self._done = threading.Event()

    def done(self) -> bool:
        return self._done.is_set()

    def wait(self, timeout: Optional[float] = None) -> str:
        self._done.wait(timeout)
        return self.status

    def result(self):
        """The worker's result frame (``want_result`` submissions
        only), deserialized lazily."""
        from spark_rapids_tpu_torch.serving.fleet.worker import (
            deserialize_frame,
        )
        return deserialize_frame(self._result_payload)

    def snapshot(self) -> Dict[str, Any]:
        return {"id": self.id, "tenant": self.tenant,
                "description": self.description, "status": self.status,
                "replica": self.replica, "placement": self.reason,
                "error": self.error, "wall_s": self.wall_s,
                "rows": self.rows,
                "deadline_s": self.deadline_s}

    def _finish(self, status: str, error: Optional[str] = None) -> None:
        self.status = status
        if error:
            self.error = error
        self._done.set()


class ProcessWorker:
    """Transport to one ``fleet/worker.py`` subprocess: JSON lines over
    its stdin/stdout, a pump thread dispatching replies to registered
    callbacks by request id. EOF on stdout (the process died) fails
    every outstanding request with ``{"lost": true}`` and fires the
    ``on_lost`` hook — unless ``stop()`` initiated the exit."""

    def __init__(self, replica: str, spec_path: str):
        self.replica = replica
        self.spec_path = spec_path
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        self._pending: Dict[int, Callable[[Dict[str, Any]], None]] = {}
        self._ready = threading.Event()
        self.fatal: Optional[str] = None
        self._on_lost: Optional[Callable] = None
        self._stopping = False
        # the package's parent on the worker's path, whatever its cwd
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))))
        path = os.environ.get("PYTHONPATH", "")
        env = dict(os.environ, PYTHONPATH=root + (os.pathsep + path
                                                  if path else ""))
        self.proc = subprocess.Popen(
            [sys.executable, "-m",
             "spark_rapids_tpu_torch.serving.fleet.worker", spec_path],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            text=True, bufsize=1, env=env)
        threading.Thread(target=self._pump, daemon=True,
                         name=f"fleet-pump-{replica}").start()

    @property
    def alive(self) -> bool:
        return self.proc.poll() is None and self.fatal is None

    def set_on_lost(self, cb: Optional[Callable]) -> None:
        self._on_lost = cb

    def _pump(self) -> None:
        for line in self.proc.stdout:
            try:
                msg = json.loads(line)
            except json.JSONDecodeError:
                continue  # stray output on the protocol channel
            mid = msg.get("id")
            if mid is None:
                if msg.get("ready"):
                    self._ready.set()
                if msg.get("fatal"):
                    self.fatal = str(msg["fatal"])
                    self._ready.set()
                continue
            with self._lock:
                cb = self._pending.pop(mid, None)
            if cb is not None:
                try:
                    cb(msg)
                except Exception:  # noqa: BLE001 — a callback must not kill the pump
                    pass
        with self._lock:
            orphans = list(self._pending.values())
            self._pending.clear()
        for cb in orphans:
            try:
                cb({"lost": True})
            except Exception:  # noqa: BLE001
                pass
        self._ready.set()  # unblock starters; they re-check alive
        if not self._stopping and self._on_lost is not None:
            self._on_lost(self, len(orphans))

    def send(self, req: Dict[str, Any],
             cb: Callable[[Dict[str, Any]], None]) -> None:
        mid = next(self._ids)
        with self._lock:
            self._pending[mid] = cb
        try:
            self.proc.stdin.write(json.dumps(dict(req, id=mid),
                                             default=str) + "\n")
            self.proc.stdin.flush()
        except (BrokenPipeError, OSError, ValueError):
            with self._lock:
                gone = self._pending.pop(mid, None)
            if gone is not None:
                cb({"lost": True})

    def ask(self, req: Dict[str, Any],
            timeout: float = 30.0) -> Optional[Dict[str, Any]]:
        box: Dict[str, Any] = {}
        ev = threading.Event()

        def cb(msg: Dict[str, Any]) -> None:
            box["msg"] = msg
            ev.set()

        self.send(req, cb)
        if not ev.wait(timeout):
            return None
        return box.get("msg")

    def submit(self, payload: Dict[str, Any],
               cb: Callable[[Dict[str, Any]], None]) -> None:
        self.send(dict(payload, op="submit"), cb)

    def status(self, timeout: float = 30.0) -> Optional[Dict[str, Any]]:
        return self.ask({"op": "status"}, timeout)

    def drain(self, timeout: float = 30.0) -> Optional[Dict[str, Any]]:
        return self.ask({"op": "drain", "timeout": timeout},
                        timeout + 10.0)

    def oracle(self, query: Dict[str, Any],
               timeout: float = 120.0) -> Optional[Dict[str, Any]]:
        return self.ask({"op": "oracle", "query": query}, timeout)

    def wait_started(self, timeout: float = 120.0) -> bool:
        self._ready.wait(timeout)
        return self._ready.is_set() and self.alive

    def stop(self, timeout: float = 30.0) -> None:
        self._stopping = True
        try:
            self.proc.stdin.write(json.dumps({"op": "exit"}) + "\n")
            self.proc.stdin.flush()
            self.proc.wait(timeout=timeout)
        except Exception:  # noqa: BLE001 — escalate to kill
            self.kill()

    def kill(self) -> None:
        self._stopping = True
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


class LocalWorker:
    """In-process worker handle over a real ``QueryScheduler`` — the
    full router surface (placement, depths, shed, deadline propagation,
    drain, crash) without paying a subprocess session boot, so the
    tier-1 fleet tests stay near-free. ``query`` may be a callable
    (``fn(session) -> DataFrame``) or the worker protocol's dict spec
    (``noop``/``sleep``)."""

    def __init__(self, replica: str, session, workers: int = 1,
                 max_queue: Optional[int] = None):
        from spark_rapids_tpu_torch.serving.scheduler import QueryScheduler
        self.replica = replica
        self.session = session
        self.sched = QueryScheduler(session, workers=workers,
                                    max_queue=max_queue)
        self._lock = threading.Lock()
        self._outstanding: Dict[object, Callable] = {}
        self._dead = False
        self._on_lost: Optional[Callable] = None

    @property
    def alive(self) -> bool:
        return not self._dead

    def set_on_lost(self, cb: Optional[Callable]) -> None:
        self._on_lost = cb

    def wait_started(self, timeout: float = 0.0) -> bool:
        return not self._dead

    def _thunk(self, query: Any) -> Callable:
        if callable(query):
            return query
        kind = (query or {}).get("kind", "noop")

        def tiny(s):
            import pandas as pd
            return s.create_dataframe(
                pd.DataFrame({"a": list(range(8)), "b": [1.0] * 8}), 2)

        if kind == "noop":
            return tiny
        if kind == "sleep":
            seconds = float(query.get("seconds", 0.1))

            def _sleep(s):
                time.sleep(seconds)
                return tiny(s)
            return _sleep
        raise ValueError(f"unknown query kind {kind!r}")

    def submit(self, payload: Dict[str, Any],
               cb: Callable[[Dict[str, Any]], None]) -> None:
        if self._dead:
            cb({"lost": True})
            return
        try:
            fn = self._thunk(payload.get("query"))
            job = self.sched.submit(
                fn, tenant=str(payload.get("tenant", "default")),
                description=str(payload.get("description", "")),
                deadline_s=payload.get("deadline_s"),
                queued_elapsed_s=float(
                    payload.get("queued_elapsed_s", 0.0)))
        except Exception as e:  # noqa: BLE001 — reported like the wire path
            cb({"status": "failed",
                "error": f"{type(e).__name__}: {e}"[:300]})
            return
        token = object()
        with self._lock:
            self._outstanding[token] = cb

        def waiter() -> None:
            job.wait()
            with self._lock:
                mine = self._outstanding.pop(token, None)
            if mine is None:
                return  # crash() already reported this one as lost
            doc: Dict[str, Any] = {
                "status": job.status, "error": job.error,
                "wall_s": job.wall_s, "query_id": job.query_id,
                "rows": (len(job.result)
                         if job.result is not None else None)}
            if payload.get("want_result") and job.status == "succeeded":
                from spark_rapids_tpu_torch.serving.fleet.worker import (
                    _serialize_frame,
                )
                doc["result"] = _serialize_frame(job.result)
            mine(doc)

        if job.done():
            waiter()  # shed / dead-on-arrival: reply inline
        else:
            threading.Thread(target=waiter, daemon=True,
                             name=f"fleet-wait-{job.id}").start()

    def status(self, timeout: float = 0.0) -> Dict[str, Any]:
        return {"replica": self.replica, "status": {},
                "scheduler": self.sched.snapshot(), "compiles": None}

    def drain(self, timeout: float = 30.0) -> Dict[str, Any]:
        return {"drained": self.sched.drain(timeout=timeout),
                "queueDepth": self.sched.queue_depth()}

    def crash(self) -> None:
        """Test hook: the worker dies mid-flight. Outstanding router
        jobs fail as lost, exactly like a ProcessWorker EOF."""
        self._dead = True
        with self._lock:
            orphans = list(self._outstanding.values())
            self._outstanding.clear()
        for cb in orphans:
            cb({"lost": True})
        self.sched.close(cancel_pending=True, timeout=5.0)
        if self._on_lost is not None:
            self._on_lost(self, len(orphans))

    def stop(self, timeout: float = 30.0) -> None:
        self._dead = True
        self.sched.close(cancel_pending=True, timeout=timeout)


class FleetRouter:
    """Placement + dispatch over a set of worker handles. The caller
    owns the lifecycle (``shutdown()``)."""

    _ids = itertools.count(1)

    def __init__(self, workers: Dict[str, Any],
                 spillover_depth: int = 4,
                 overrides: Optional[Any] = None):
        if isinstance(overrides, str):
            overrides = parse_overrides(overrides)
        self.policy = PlacementPolicy(workers.keys(),
                                      overrides=overrides,
                                      spillover_depth=spillover_depth)
        self._cond = threading.Condition()
        # replica -> {"handle", "state" up|draining|lost, "depth"}
        self._recs: Dict[str, Dict[str, Any]] = {}
        self._placement: Dict[str, str] = {}
        self._queue: "collections.deque[FleetJob]" = collections.deque()
        self._jobs: "collections.OrderedDict[str, FleetJob]" = \
            collections.OrderedDict()
        # recent distinct query specs, dispatch order: the prime set a
        # rolling restart hands the replacement (bounded; sleeps and
        # other no-warmth specs excluded at record time)
        self._recent_specs: "collections.OrderedDict[str, Any]" = \
            collections.OrderedDict()
        self._closed = False
        self.placement_churn = 0
        self.shed_total = 0
        self.lost_total = 0
        self._counts: Dict[str, int] = {}
        for rid, handle in workers.items():
            self._recs[rid] = {"handle": handle, "state": "up",
                               "depth": 0}
            handle.set_on_lost(self._make_lost_cb(rid))
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, name="fleet-router",
            daemon=True)
        self._dispatcher.start()
        _ACTIVE_ROUTERS.add(self)
        # optional launch context (set by launch_process_fleet) so
        # restart_process_worker can rebuild a replacement spec
        self.fleet_dir: Optional[str] = None
        self.base_conf: Optional[Dict[str, Any]] = None
        self.spec_extras: Optional[Dict[str, Any]] = None

    # -- submission ----------------------------------------------------------
    def submit(self, query: Any, tenant: str = "default",
               description: str = "",
               deadline_s: Optional[float] = None,
               want_result: bool = False) -> FleetJob:
        job = FleetJob(f"fjob-{next(self._ids)}", str(tenant),
                       description, deadline_s, query, want_result)
        with self._cond:
            if self._closed:
                raise RuntimeError("router is closed")
            self._jobs[job.id] = job
            self._queue.append(job)
            self._cond.notify_all()
        from spark_rapids_tpu_torch.obs.metrics import REGISTRY
        REGISTRY.counter("fleet.submitted", tenant=job.tenant).add(1)
        return job

    # -- dispatch ------------------------------------------------------------
    def _eligible_depths_locked(self) -> Dict[str, int]:
        return {rid: rec["depth"] for rid, rec in self._recs.items()
                if rec["state"] == "up" and rec["handle"].alive}

    def _dispatch_loop(self) -> None:
        while True:
            with self._cond:
                while not self._closed and not self._queue:
                    self._cond.wait()
                if self._closed:
                    return
                job = self._queue[0]
                placed = self.policy.place(
                    job.tenant, self._eligible_depths_locked())
                if placed is None:
                    # every replica draining/lost: hold the queue; a
                    # membership change notifies, the timeout bounds a
                    # missed wakeup. The job's deadline keeps burning —
                    # the worker sheds it at admission if it dies here.
                    self._cond.wait(timeout=0.25)
                    continue
                self._queue.popleft()
                rid, reason = placed
                rec = self._recs[rid]
                rec["depth"] += 1
                if isinstance(job.query, dict) \
                        and job.query.get("kind") not in (None, "sleep"):
                    key = json.dumps(job.query, sort_keys=True,
                                     default=str)
                    self._recent_specs[key] = job.query
                    self._recent_specs.move_to_end(key)
                    while len(self._recent_specs) > 32:
                        self._recent_specs.popitem(last=False)
                prev = self._placement.get(job.tenant)
                self._placement[job.tenant] = rid
                if prev is not None and prev != rid:
                    self.placement_churn += 1
                handle = rec["handle"]
            job.replica, job.reason = rid, reason
            job.status = "dispatched"
            if prev != rid:
                from spark_rapids_tpu_torch.obs.events import EVENTS
                from spark_rapids_tpu_torch.obs.metrics import REGISTRY
                EVENTS.emit("fleetPlacement", tenant=job.tenant,
                            query=None, replica=rid, reason=reason,
                            previous=prev)
                REGISTRY.counter("fleet.placement", replica=rid,
                                 reason=reason).add(1)
            payload = {
                "tenant": job.tenant, "description": job.description,
                "deadline_s": job.deadline_s,
                "queued_elapsed_s": round(
                    time.monotonic() - job.created_mono, 6),
                "query": job.query, "want_result": job.want_result,
            }
            handle.submit(payload,
                          lambda msg, j=job, r=rid:
                          self._on_reply(r, j, msg))

    def _on_reply(self, rid: str, job: FleetJob,
                  msg: Dict[str, Any]) -> None:
        from spark_rapids_tpu_torch.obs.events import EVENTS
        from spark_rapids_tpu_torch.obs.metrics import REGISTRY
        with self._cond:
            rec = self._recs.get(rid)
            if rec is not None:
                rec["depth"] = max(rec["depth"] - 1, 0)
                self._cond.notify_all()
        if msg.get("lost"):
            job._finish("lost", f"worker {rid} lost")
            REGISTRY.counter("fleet.completed", replica=rid,
                             status="lost").add(1)
            self._bump(rid, "lost")
            return
        status = str(msg.get("status")
                     or ("failed" if msg.get("error") else "failed"))
        job.wall_s = msg.get("wall_s")
        job.rows = msg.get("rows")
        job.query_id = msg.get("query_id")
        job._result_payload = msg.get("result")
        job._finish(status, msg.get("error"))
        if status == "shed":
            # replica-attributed shed in the ROUTER's journal: the
            # worker's own queryShed lands in ITS journal; operators
            # watch the router's
            with self._cond:
                self.shed_total += 1
            EVENTS.emit("queryShed", tenant=job.tenant, query=None,
                        jobId=job.id, replica=rid, reason=job.error)
            REGISTRY.counter("fleet.shed", replica=rid).add(1)
        REGISTRY.counter("fleet.completed", replica=rid,
                         status=status).add(1)
        self._bump(rid, status)

    def _bump(self, rid: str, status: str) -> None:
        with self._cond:
            self._counts[f"{rid}.{status}"] = \
                self._counts.get(f"{rid}.{status}", 0) + 1

    # -- worker loss ---------------------------------------------------------
    def _make_lost_cb(self, rid: str) -> Callable:
        def on_lost(handle, inflight_failed: int) -> None:
            self._on_worker_lost(rid, handle, inflight_failed)
        return on_lost

    def _on_worker_lost(self, rid: str, handle,
                        inflight_failed: int) -> None:
        from spark_rapids_tpu_torch.obs.events import EVENTS
        from spark_rapids_tpu_torch.obs.metrics import REGISTRY
        with self._cond:
            rec = self._recs.get(rid)
            if rec is None or rec["handle"] is not handle:
                return  # an already-swapped handle died late: stale
            rec["state"] = "lost"
            rec["depth"] = 0
            # drop placements at the dead replica: the next submission
            # re-places (emitting fleetPlacement with previous=rid)
            for tenant in [t for t, r in self._placement.items()
                           if r == rid]:
                del self._placement[tenant]
            self.lost_total += 1
            self._cond.notify_all()
        EVENTS.emit("workerLost", replica=rid, query=None,
                    inflightFailed=inflight_failed)
        REGISTRY.counter("fleet.workerLost", replica=rid).add(1)

    # -- quiesce / rolling restart -------------------------------------------
    def quiesce(self, rid: str) -> int:
        """Stop placing onto ``rid``; returns its in-flight depth at
        quiesce time. Emits ``workerDrain``."""
        from spark_rapids_tpu_torch.obs.events import EVENTS
        with self._cond:
            rec = self._recs[rid]
            rec["state"] = "draining"
            depth = rec["depth"]
            self._cond.notify_all()
        EVENTS.emit("workerDrain", replica=rid, query=None,
                    inflight=depth)
        return depth

    def restore(self, rid: str) -> None:
        with self._cond:
            self._recs[rid]["state"] = "up"
            self._cond.notify_all()

    def wait_drained(self, rid: str,
                     timeout: Optional[float] = None) -> bool:
        end = (time.monotonic() + timeout) if timeout else None
        while True:
            with self._cond:
                if self._recs[rid]["depth"] == 0:
                    return True
            if end is not None and time.monotonic() >= end:
                return False
            time.sleep(0.02)

    def _wait_ready(self, handle, timeout: float):
        """Replacement readiness: the worker's boot sequence — session
        over the shared nvcc build directory, pre-warm manifest load,
        prime-query replay and the pre-warm pass (``worker._prime``) — completes
        BEFORE its ready message, so readiness here is that message
        plus one status round-trip to capture the warm-up accounting
        (``aot`` + ``prime``) for the ``workerReady`` event."""
        end = time.monotonic() + max(timeout, 0.1)
        if not handle.wait_started(max(timeout, 0.1)):
            return False, None
        aot = None
        while time.monotonic() < end:
            st = handle.status(timeout=10.0)
            if st is not None:
                aot = dict((st.get("status") or {}).get("aot") or {})
                aot["prime"] = st.get("prime")
                return True, aot
            if not handle.alive:
                return False, aot
            time.sleep(0.1)
        return False, aot

    def rolling_restart(self, rid: str, spawn: Callable[[], Any],
                        drain_timeout: float = 60.0,
                        ready_timeout: float = 120.0) -> Dict[str, Any]:
        """Quiesce -> drain -> boot replacement -> wait warm -> swap ->
        stop old. ``spawn()`` returns the replacement handle for the
        SAME replica id (placement stays sticky across the restart)."""
        from spark_rapids_tpu_torch.obs.events import EVENTS
        inflight = self.quiesce(rid)
        drained = self.wait_drained(rid, drain_timeout)
        replacement = spawn()
        t0 = time.monotonic()
        ready, aot = self._wait_ready(replacement, ready_timeout)
        wait_s = round(time.monotonic() - t0, 3)
        EVENTS.emit("workerReady", replica=rid, query=None, aot=aot,
                    ready=ready, waitSeconds=wait_s)
        with self._cond:
            rec = self._recs[rid]
            old = rec["handle"]
            old.set_on_lost(None)  # its exit is planned, not a loss
            rec["handle"] = replacement
            rec["state"] = "up"
            rec["depth"] = 0
            replacement.set_on_lost(self._make_lost_cb(rid))
            self._cond.notify_all()
        old.stop()
        return {"replica": rid, "inflightAtQuiesce": inflight,
                "drained": drained, "ready": ready,
                "readyWaitSeconds": wait_s, "aot": aot}

    def restart_process_worker(self, rid: str, prewarm: bool = True,
                               drain_timeout: float = 60.0,
                               ready_timeout: float = 120.0
                               ) -> Dict[str, Any]:
        """Rolling restart for a ``launch_process_fleet`` fleet: the
        replacement boots from a fresh spec with the shared warm
        manifest as its AOT manifest (``prewarm=True``)."""
        if self.fleet_dir is None:
            raise RuntimeError("router was not built by "
                               "launch_process_fleet")
        from spark_rapids_tpu_torch.serving.fleet import warmstate
        with self._cond:
            recent = list(self._recent_specs.values())

        def spawn():
            conf = warmstate.worker_conf(self.base_conf, self.fleet_dir,
                                         rid, prewarm=prewarm)
            extras = dict(self.spec_extras or {})
            if prewarm and recent:
                extras["primeQueries"] = recent
            path = warmstate.write_worker_spec(
                self.fleet_dir, rid, conf, **extras)
            return ProcessWorker(rid, path)

        return self.rolling_restart(rid, spawn,
                                    drain_timeout=drain_timeout,
                                    ready_timeout=ready_timeout)

    # -- introspection / lifecycle -------------------------------------------
    def queue_depth(self) -> int:
        with self._cond:
            return len(self._queue)

    def worker(self, rid: str):
        with self._cond:
            return self._recs[rid]["handle"]

    def placement_of(self, tenant: str) -> Optional[str]:
        with self._cond:
            return self._placement.get(tenant)

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Wait until every routed job is terminal."""
        end = (time.monotonic() + timeout) if timeout else None
        with self._cond:
            jobs = list(self._jobs.values())
        for j in jobs:
            left = None if end is None \
                else max(0.0, end - time.monotonic())
            if not j._done.wait(left):
                return False
        return True

    def snapshot(self, include_workers: bool = True) -> Dict[str, Any]:
        """The ``/api/fleet`` shape: per-replica state + router-side
        depths and outcome counts, the tenant placement map, churn and
        shed totals; ``include_workers`` folds in each live worker's
        own ``/api/status`` + ``/api/scheduler`` snapshots."""
        with self._cond:
            workers = []
            for rid in sorted(self._recs):
                rec = self._recs[rid]
                counts = {k.split(".", 1)[1]: v
                          for k, v in self._counts.items()
                          if k.startswith(rid + ".")}
                workers.append({"replica": rid, "state": rec["state"],
                                "alive": rec["handle"].alive,
                                "queueDepth": rec["depth"],
                                "completed": counts})
            doc = {
                "workers": workers,
                "placement": dict(self._placement),
                "placementChurn": self.placement_churn,
                "shedTotal": self.shed_total,
                "workersLost": self.lost_total,
                "routerQueueDepth": len(self._queue),
                "jobs": len(self._jobs),
                "closed": self._closed,
            }
            handles = {w["replica"]: self._recs[w["replica"]]["handle"]
                       for w in workers if w["alive"]}
        if include_workers:
            for w in doc["workers"]:
                h = handles.get(w["replica"])
                if h is None:
                    continue
                st = h.status(timeout=10.0)
                if st is not None:
                    w["status"] = st.get("status")
                    w["scheduler"] = st.get("scheduler")
                    w["compiles"] = st.get("compiles")
        return doc

    def shutdown(self, stop_workers: bool = True,
                 timeout: float = 30.0) -> None:
        with self._cond:
            self._closed = True
            queued = list(self._queue)
            self._queue.clear()
            handles = [rec["handle"] for rec in self._recs.values()]
            for rec in self._recs.values():
                rec["handle"].set_on_lost(None)
            self._cond.notify_all()
        for j in queued:
            j._finish("cancelled", "router shut down")
        self._dispatcher.join(timeout=5.0)
        if stop_workers:
            for h in handles:
                try:
                    h.stop(timeout=timeout)
                except TypeError:
                    h.stop()
        _ACTIVE_ROUTERS.discard(self)


# ---------------------------------------------------------------------------
# Process-fleet launcher + router-process HTTP surface
# ---------------------------------------------------------------------------

def launch_process_fleet(n: int, fleet_dir: str,
                         base_conf: Optional[Dict[str, Any]] = None,
                         spec_extras: Optional[Dict[str, Any]] = None,
                         spillover_depth: int = 4,
                         overrides: Optional[Any] = None,
                         start_timeout: float = 120.0) -> FleetRouter:
    """Boot N ``fleet/worker.py`` processes over one shared fleet dir
    (``warmstate``: shared nvcc build directory + warm manifest +
    per-replica event logs) and return the router over them. Workers boot in
    parallel; a worker that fails to start raises after the others are
    stopped."""
    os.makedirs(fleet_dir, exist_ok=True)
    workers: Dict[str, ProcessWorker] = {}
    from spark_rapids_tpu_torch.serving.fleet import warmstate
    for i in range(int(n)):
        rid = f"r{i}"
        conf = warmstate.worker_conf(base_conf, fleet_dir, rid)
        path = warmstate.write_worker_spec(fleet_dir, rid, conf,
                                           **(spec_extras or {}))
        workers[rid] = ProcessWorker(rid, path)
    failed = [rid for rid, h in workers.items()
              if not h.wait_started(start_timeout)]
    if failed:
        detail = "; ".join(
            f"{rid}: {workers[rid].fatal or 'start timeout'}"
            for rid in failed)
        for h in workers.values():
            h.kill()
        raise RuntimeError(f"fleet workers failed to start: {detail}")
    router = FleetRouter(workers, spillover_depth=spillover_depth,
                         overrides=overrides)
    router.fleet_dir = fleet_dir
    router.base_conf = dict(base_conf or {})
    router.spec_extras = dict(spec_extras or {})
    return router


def _make_fleet_handler():
    from spark_rapids_tpu_torch.obs.monitor import JsonHandler

    class _FleetHandler(JsonHandler):
        server_version = "spark-rapids-tpu-fleet"

        def do_GET(self) -> None:  # noqa: N802 — BaseHTTPRequestHandler API
            from urllib.parse import urlparse
            path = urlparse(self.path).path
            try:
                if path == "/api/fleet":
                    self._send_json(
                        self.server._router.snapshot(
                            include_workers=True))
                elif path == "/metrics":
                    from spark_rapids_tpu_torch.obs.metrics import REGISTRY
                    from spark_rapids_tpu_torch.obs.monitor import (
                        render_prometheus,
                    )
                    self._send(
                        200, render_prometheus(REGISTRY),
                        "text/plain; version=0.0.4; charset=utf-8")
                elif path == "/healthz":
                    self._send_json({
                        "status": "ok",
                        "uptime_s": round(
                            time.time() - self.server._started_ts, 3)})
                else:
                    self._send_json({"error": f"no route {path}"}, 404)
            except Exception as e:  # noqa: BLE001 — a broken page, not a query
                self._send_json(
                    {"error": f"{type(e).__name__}: {e}"[:300]}, 500)

    return _FleetHandler


class FleetMonitor:
    """The router process's HTTP surface (``fleet.router.host``/
    ``.port``): ``/api/fleet`` + the router process's own ``/metrics``
    (the ``srt_fleet_*`` series) + ``/healthz``."""

    def __init__(self, router: FleetRouter, host: str = "127.0.0.1",
                 port: int = 0):
        from spark_rapids_tpu_torch.obs.monitor import BackgroundHttpServer
        self._server = BackgroundHttpServer(
            _make_fleet_handler(), host, port,
            thread_name="tpu-fleet-ui")
        self._server._httpd._router = router

    @property
    def url(self) -> str:
        return self._server.url

    def start(self) -> "FleetMonitor":
        self._server.start()
        return self

    def stop(self) -> None:
        self._server.stop()

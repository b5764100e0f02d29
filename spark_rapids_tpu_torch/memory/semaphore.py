"""Task admission semaphore (counterpart of the JAX package's
``memory/semaphore.py``; reference: GpuSemaphore.scala:101-161).

Bounds how many host task threads may hold device batches concurrently
(spark.rapids.sql.concurrentTpuTasks). Acquire-on-first-use per task
(the upload of a scan partition), release on task completion (the end of
the session's drain), the reference's protocol, with the JAX package's
two generalizations:

  * **drain-safe reconfiguration**: ``resize(permits)`` changes the bound
    of a live semaphore; a shrink takes effect as holders drain, a grow
    admits waiters at once;
  * **per-tenant permit budgets**: a tenant's tasks are additionally
    bounded by that tenant's budget (``configure_tenants``), 0 meaning
    the global limit only. A caller that passes no tenant gets the one
    of the thread's serving context (``serving/cancellation.
    current_tenant``: the scheduler's worker sets it per job).

Each session holds its own semaphore (the JAX package's process-wide
singleton would share one bound between sessions of different confs).
A single condition variable over a holder census rather than a raw
``threading.Semaphore``: resize and tenant bounds are plain predicate
changes, impossible to over-admit by construction. A contended acquire
waits inside ``sync_scope("semaphore.wait")``, as the JAX package counts
it, and a ``semaphore.wait`` tracer span; under a cancel scope the wait
wakes every 50 ms to check it, so a cancel or a deadline reaches a task
parked behind a tenant budget.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple


class TpuSemaphore:
    def __init__(self, permits: int):
        self.permits = max(1, int(permits))
        self._cond = threading.Condition()
        # task id -> (acquire count, tenant)
        self._holders: Dict[int, Tuple[int, Optional[str]]] = {}
        # tenant -> tasks currently holding / waiting
        self._tenant_held: Dict[str, int] = {}
        self._tenant_waiting: Dict[str, int] = {}
        # tenant -> max concurrent holders (0/absent = unbounded)
        self._tenant_budgets: Dict[str, int] = {}
        self._default_budget = 0
        self._holders_gauge = None  # resolved lazily, once

    # -- metrics -------------------------------------------------------------
    def _publish_locked(self, tenant: Optional[str] = None) -> None:
        """Mirror the holder count into the process-wide registry
        (semaphore.holders gauge; per tenant semaphore.tenant.holders and
        .waiters). Caller holds self._cond."""
        from spark_rapids_tpu_torch.obs.metrics import REGISTRY
        if self._holders_gauge is None:
            self._holders_gauge = REGISTRY.gauge("semaphore.holders")
        self._holders_gauge.set(len(self._holders))
        if tenant is not None:
            REGISTRY.gauge("semaphore.tenant.holders", tenant=tenant) \
                .set(self._tenant_held.get(tenant, 0))
            REGISTRY.gauge("semaphore.tenant.waiters", tenant=tenant) \
                .set(self._tenant_waiting.get(tenant, 0))

    def available_permits(self) -> int:
        """Permits not currently held by any task thread (introspection
        for tests and backpressure diagnostics)."""
        with self._cond:
            return max(self.permits - len(self._holders), 0)

    # -- configuration -------------------------------------------------------
    def resize(self, permits: int) -> None:
        """Drain-safe permit change: growth wakes waiters immediately; a
        shrink stops new admission until enough holders release that the
        census fits the new bound. Holders are never revoked."""
        with self._cond:
            self.permits = max(1, int(permits))
            self._cond.notify_all()

    def configure_tenants(self, budgets: Dict[str, int],
                          default: int = 0) -> None:
        """Install per-tenant max-holder budgets (0 = unbounded); loosened
        budgets wake waiters."""
        with self._cond:
            self._tenant_budgets = {str(t): max(0, int(b))
                                    for t, b in budgets.items()}
            self._default_budget = max(0, int(default))
            self._cond.notify_all()

    def tenant_budget(self, tenant: Optional[str]) -> int:
        if tenant is None:
            return 0
        return self._tenant_budgets.get(str(tenant), self._default_budget)

    def tenant_usage(self) -> Dict[str, Dict[str, int]]:
        """Per-tenant holders, waiters and budget."""
        with self._cond:
            tenants = (set(self._tenant_held) | set(self._tenant_waiting)
                       | set(self._tenant_budgets))
            return {t: {"held": self._tenant_held.get(t, 0),
                        "waiting": self._tenant_waiting.get(t, 0),
                        "budget": self.tenant_budget(t)}
                    for t in sorted(tenants)}

    # -- admission -----------------------------------------------------------
    def _admissible_locked(self, tenant: Optional[str]) -> bool:
        if len(self._holders) >= self.permits:
            return False
        budget = self.tenant_budget(tenant)
        return not (budget and tenant is not None
                    and self._tenant_held.get(str(tenant), 0) >= budget)

    def acquire_if_necessary(self, task_id: Optional[int] = None,
                             tenant: Optional[str] = None) -> None:
        tid = task_id if task_id is not None else threading.get_ident()
        if tenant is None:
            from spark_rapids_tpu_torch.serving.cancellation import (
                current_tenant,
            )
            tenant = current_tenant()
        tkey = str(tenant) if tenant is not None else None
        with self._cond:
            held = self._holders.get(tid)
            if held is not None:
                self._holders[tid] = (held[0] + 1, held[1])
                return
            if self._admissible_locked(tkey):
                self._grant_locked(tid, tkey)
                return
            # contended acquires are the interesting signal (tasks
            # stalled behind concurrentTpuTasks or a tenant budget); the
            # uncontended path above stays timer-free
            if tkey is not None:
                self._tenant_waiting[tkey] = \
                    self._tenant_waiting.get(tkey, 0) + 1
        import time

        from spark_rapids_tpu_torch.obs.metrics import REGISTRY
        from spark_rapids_tpu_torch.obs.syncledger import sync_scope
        from spark_rapids_tpu_torch.obs.trace import TRACER
        from spark_rapids_tpu_torch.serving.cancellation import (
            current_scope,
        )
        # a parked wait stays cancellable: tenant budgets make exactly the
        # contention where a cancel or deadline fires before the next
        # batch pull could see it
        scope = current_scope()
        t0 = time.perf_counter()
        try:
            with TRACER.span("semaphore.wait", permits=self.permits,
                             tenant=tkey or ""), \
                    sync_scope("semaphore.wait", detail=tkey or None):
                with self._cond:
                    try:
                        while not self._admissible_locked(tkey):
                            self._cond.wait(
                                0.05 if scope is not None else None)
                            if scope is not None:
                                scope.check()
                    finally:
                        if tkey is not None:
                            self._tenant_waiting[tkey] -= 1
                    self._grant_locked(tid, tkey)
        finally:
            REGISTRY.timer("semaphore.waitTime") \
                .record(time.perf_counter() - t0)

    def _grant_locked(self, tid: int, tenant: Optional[str]) -> None:
        self._holders[tid] = (1, tenant)
        if tenant is not None:
            self._tenant_held[tenant] = self._tenant_held.get(tenant, 0) + 1
        self._publish_locked(tenant)

    def release(self, task_id: Optional[int] = None) -> None:
        tid = task_id if task_id is not None else threading.get_ident()
        with self._cond:
            held = self._holders.pop(tid, None)
            if held is not None:
                tenant = held[1]
                if tenant is not None:
                    n = self._tenant_held.get(tenant, 1) - 1
                    if n > 0:
                        self._tenant_held[tenant] = n
                    else:
                        self._tenant_held.pop(tenant, None)
                self._publish_locked(tenant)
                self._cond.notify_all()

    def __enter__(self):
        self.acquire_if_necessary()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

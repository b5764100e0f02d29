"""Concurrent query serving (counterpart of the JAX package's
``serving/``): the long-lived multi-tenant front end of a session.

  * ``scheduler.py``    admission controller and weighted-fair scheduler:
    jobs (submit/status/cancel), per-tenant FIFO lanes, a bounded queue
    that sheds load, worker threads running queries concurrently with
    deadlines and cooperative cancellation;
  * ``cancellation.py`` the cancel and deadline scope the execution path
    checks at every batch pull (``exec/base.py``), and the thread-local
    serving context (the tenant the semaphore's budgets read);
  * ``caches.py``       the cross-query plan cache (no tag and convert on
    a repeat), the opt-in result cache, and the AQE exchange-reuse cache;
  * ``prewarm.py``      the background pre-warm of the nvcc libraries and
    the kernels' first launches from a manifest;
  * ``fleet/``          the multi-process tier: a router spreading tenants
    over worker processes with sticky placement, a shared compile cache
    and rolling restarts.
"""

from spark_rapids_tpu_torch.serving.cancellation import (  # noqa: F401
    CancelScope, QueryCancelled, QueryTimeout, SchedulerOverloaded,
    current_scope, current_tenant, serving_context,
)


def __getattr__(name):
    # scheduler and caches import the session's modules: resolved lazily
    # so that ``import spark_rapids_tpu_torch.serving`` never cycles
    if name in ("QueryScheduler", "QueryJob"):
        from spark_rapids_tpu_torch.serving import scheduler
        return getattr(scheduler, name)
    if name in ("PlanCache", "ResultCache", "ExchangeReuseCache"):
        from spark_rapids_tpu_torch.serving import caches
        return getattr(caches, name)
    if name == "fleet":
        import importlib
        return importlib.import_module("spark_rapids_tpu_torch.serving.fleet")
    raise AttributeError(name)

"""Cooperative cancellation and the thread-local serving context
(counterpart of the JAX package's ``serving/cancellation.py``).

A ``CancelScope`` is one query's cancellation state: an explicit cancel
flag (``scope.cancel()``) and an optional wall-clock deadline. The
execution path checks the scope at every batch pull
(``exec/base.executed_partitions``): a cancelled or expired query raises
``QueryCancelled``/``QueryTimeout`` out of its next pull instead of being
stopped inside a kernel, so the card's state stays consistent and the
session's failure path (transient buffers and shuffles released, the
journal's ``queryCancelled``/``queryTimeout`` event) runs as usual.

``serving_context`` is how the scope reaches the engine without a
parameter through every operator: the scheduler's worker thread enters it
before running a job, ``ExecContext`` takes the scope from the
thread-local, and the task semaphore's tenant budgets
(``memory/semaphore.py``) read ``current_tenant()`` at acquire time.
Standard library only, so ``exec/base`` imports it without a cycle.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Optional


class QueryCancelled(RuntimeError):
    """The query's cancel scope was cancelled (job cancel, shutdown)."""


class QueryTimeout(QueryCancelled):
    """The query ran past its deadline (checked at batch pulls, never
    inside a kernel)."""


class SchedulerOverloaded(RuntimeError):
    """The admission queue was full and the job was shed."""


class CancelScope:
    """One query's cancellation state. Thread-safe; ``check()`` is the
    per-batch call (two attribute loads while neither flag is set)."""

    __slots__ = ("deadline_ts", "deadline_s", "elapsed_s", "_cancelled",
                 "reason")

    def __init__(self, deadline_s: Optional[float] = None,
                 elapsed_s: float = 0.0):
        # elapsed_s: deadline budget spent BEFORE this scope existed (a
        # router that queued the submission forwards the elapsed seconds:
        # monotonic clocks do not compare across processes, durations
        # do), so the deadline counts from the original submission; a
        # scope with elapsed >= deadline is born expired
        self.deadline_s = deadline_s if deadline_s and deadline_s > 0 \
            else None
        self.elapsed_s = max(float(elapsed_s or 0.0), 0.0)
        self.deadline_ts = (time.monotonic() + self.deadline_s
                            - self.elapsed_s
                            if self.deadline_s else None)
        self._cancelled = False
        self.reason: Optional[str] = None

    def cancel(self, reason: str = "cancelled") -> None:
        self.reason = reason or "cancelled"
        self._cancelled = True

    @property
    def cancelled(self) -> bool:
        return self._cancelled

    def expired(self) -> bool:
        return (self.deadline_ts is not None
                and time.monotonic() > self.deadline_ts)

    def check(self) -> None:
        """Raise if the query must stop. Called once per pulled batch."""
        if self._cancelled:
            raise QueryCancelled(self.reason or "cancelled")
        if self.deadline_ts is not None \
                and time.monotonic() > self.deadline_ts:
            raise QueryTimeout(
                f"query exceeded its {self.deadline_s:.3f}s deadline")


_TLS = threading.local()


def current_scope() -> Optional[CancelScope]:
    return getattr(_TLS, "scope", None)


def current_tenant() -> Optional[str]:
    return getattr(_TLS, "tenant", None)


@contextmanager
def serving_context(tenant: Optional[str] = None,
                    scope: Optional[CancelScope] = None):
    """Install (tenant, scope) as this thread's serving context for the
    duration; the engine reads them thread-locally."""
    prev = (getattr(_TLS, "tenant", None), getattr(_TLS, "scope", None))
    _TLS.tenant, _TLS.scope = tenant, scope
    try:
        yield
    finally:
        _TLS.tenant, _TLS.scope = prev

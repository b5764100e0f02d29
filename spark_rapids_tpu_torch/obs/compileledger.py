"""The operator scope of the JAX package's ``obs/compileledger.py``: which
plan operator is executing on this thread, and the per-node wall-time
components the profile report splits into device, transfer and dispatch.

  * ``push_op``/``pop_op`` (and ``op_context``): the per-batch operator
    wrapper (``exec/base.executed_partitions``) enters the executing
    operator around every batch pull, so a host sync or a transfer inside
    that pull knows its operator;
  * ``note_transfer``: host<->device transfer sites (the scan's uploads,
    the transitions' and the write's fetches) report their seconds
    against the current operator;
  * ``note_breakdown``: the wrapper's pull/sync split under
    ``spark.rapids.sql.profile.syncEachOp``.

The compile ledger proper (``CompileLedger``, ``analyze``,
``kernel_key``: per-operator attribution of every XLA compile) has its
counterpart in the nvcc build of ``ops/cudalib.build``, which runs once
a process, not per query; it stays in ROADMAP A.11's later half. The
build is traced as a ``kernelcache.build`` span.
"""

from __future__ import annotations

import threading
from typing import Any, Optional, Tuple

_tls = threading.local()


def push_op(op: str, node_id: Optional[int] = None, ctx: Any = None) -> Any:
    """Enter an operator scope on this thread; returns the previous scope,
    to pass to ``pop_op``. Two attribute stores, no lock."""
    prev = getattr(_tls, "op", None)
    _tls.op = (op, node_id, ctx)
    return prev


def pop_op(prev: Any) -> None:
    _tls.op = prev


def current_op() -> Optional[Tuple[str, Optional[int], Any]]:
    """(describe, node_id, ExecContext) of the operator executing on this
    thread, or None outside any operator scope."""
    return getattr(_tls, "op", None)


class op_context:
    """``with op_context("Collect", None, None):``: an explicit operator
    scope for sites outside the per-batch wrapper (the collect)."""

    def __init__(self, op: str, node_id: Optional[int] = None,
                 ctx: Any = None):
        self._args = (op, node_id, ctx)
        self._prev = None

    def __enter__(self):
        self._prev = push_op(*self._args)
        return self

    def __exit__(self, *exc):
        pop_op(self._prev)
        return False


def note_transfer(seconds: float, direction: str = "h2d") -> None:
    """Report host<->device transfer seconds against the operator
    executing on this thread (nothing outside an operator scope)."""
    cur = current_op()
    if cur is None:
        return
    _op, node_id, ctx = cur
    if ctx is None or node_id is None:
        return
    note_breakdown(ctx, node_id, transfer_s=seconds)


def note_breakdown(ctx, node_id: int, **fields) -> None:
    """Accumulate per-plan-node wall-time components (pull_s, sync_s,
    transfer_s) into ``ctx.node_breakdown``."""
    bd = getattr(ctx, "node_breakdown", None)
    if bd is None:
        return
    with ctx._stats_lock:
        st = bd.get(node_id)
        if st is None:
            st = bd[node_id] = {}
        for k, v in fields.items():
            st[k] = st.get(k, 0.0) + v

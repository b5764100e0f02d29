"""Physical plan base classes (counterpart of the JAX package's
``exec/base.py``).

Execution model: a physical operator produces a list of *partitions*, each
a zero-argument callable returning an iterator of batches (the Spark
``RDD.mapPartitions`` shape). Two payloads flow through a mixed plan:

  * CPU operators: pandas DataFrames (the fallback path);
  * device operators: columnar DeviceBatches (the accelerated path).

Transition operators convert between them (``exec/transitions.py``).
The JAX package's per-operator SQL metrics around each partition (rows,
batches, time), tracer spans, progress heartbeats, compile-ledger scopes
and cancellation checks are not ported: ``executed_partitions`` is
``partitions``. An operator adds what it counts itself to its query's
metrics (``ExecContext.metric_add``: a scan's pruned row groups, a
write's files and rows), which the session keeps as
``last_query_metrics``.
"""

from __future__ import annotations

import hashlib
import threading
from typing import Callable, Iterator, List, Sequence

import torch

from spark_rapids_tpu_torch.columnar.batch import Schema

Partition = Callable[[], Iterator]  # yields pd.DataFrame or DeviceBatch


def group_contiguous(parts: Sequence[Partition],
                     n: int) -> List[List[Partition]]:
    """Contiguous partition grouping for CoalesceExec (Spark's
    DefaultPartitionCoalescer), shared by the CPU and device operators."""
    n = min(max(1, int(n)), max(len(parts), 1))
    per = -(-len(parts) // n) if parts else 0
    groups: List[List[Partition]] = [[] for _ in range(n)]
    for i, p in enumerate(parts):
        groups[min(i // max(per, 1), n - 1)].append(p)
    return groups


class PhysicalPlan:
    """Base physical operator."""

    # True if this operator's output is device columnar
    columnar_output = False

    def __init__(self, children: Sequence["PhysicalPlan"] = ()):
        self.children: List[PhysicalPlan] = list(children)

    @property
    def name(self) -> str:
        return type(self).__name__

    def output_schema(self) -> Schema:
        raise NotImplementedError

    def partitions(self, ctx: "ExecContext") -> List[Partition]:
        raise NotImplementedError

    def executed_partitions(self, ctx: "ExecContext") -> List[Partition]:
        """What consumers call; operators implement ``partitions``."""
        return self.partitions(ctx)

    def map_children(self, fn) -> "PhysicalPlan":
        import copy
        new = copy.copy(self)
        new.children = [fn(c) for c in self.children]
        return new

    def tree_string(self, indent: int = 0) -> str:
        lines = ["  " * indent + self.describe()]
        for c in self.children:
            lines.append(c.tree_string(indent + 1))
        return "\n".join(lines)

    def describe(self) -> str:
        return self.name

    def fingerprint_extra(self) -> str:
        """Identity beyond ``describe()`` for ``plan_fingerprint``."""
        return ""

    def walk(self):
        yield self
        for c in self.children:
            yield from c.walk()


def plan_fingerprint(node: PhysicalPlan) -> str:
    """Structural identity of a plan subtree, stable across executions of
    the same query over the same data: keys the session's aggregation
    ratio cache."""
    parts: List[str] = []

    def rec(n: PhysicalPlan) -> None:
        parts.extend((n.describe(), n.fingerprint_extra(), "("))
        for c in n.children:
            rec(c)
        parts.append(")")
    rec(node)
    return hashlib.md5("|".join(parts).encode()).hexdigest()


class ExecContext:
    """Per-query execution context: the conf, the session (its caches) and
    the device the query's batches live on."""

    def __init__(self, conf, session=None, device="cuda"):
        self.conf = conf
        self.session = session
        self.device = torch.device(device)
        # the shared subtrees' batches of this execution (exec/reuse.py)
        self.reuse_state: dict = {}
        # catalog ids of this query's transient spillables (broadcast
        # tables, reused subtrees, out-of-core buckets), freed at its end
        self.transient_bids: set = set()
        # {operator: {metric: value}} of this query
        self.metrics: dict = {}
        self._metrics_lock = threading.Lock()

    def metric_add(self, op: str, name: str, value) -> None:
        """Add ``value`` to metric ``name`` of operator ``op`` (its
        ``describe()``) in this query's metrics."""
        with self._metrics_lock:
            ms = self.metrics.setdefault(op, {})
            ms[name] = ms.get(name, 0) + value

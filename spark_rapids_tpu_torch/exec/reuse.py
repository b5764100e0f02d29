"""Within-query reuse of identical subtrees (counterpart of the JAX
package's ``exec/reuse.py``). The JAX package's switch,
``spark.rapids.sql.reuseSubtrees.enabled`` (on by default), is not
registered: the session always reuses, until a workload needs it off.

Spark's ReuseExchange analogue: TPC-H Q2's min-cost subquery, Q11's
threshold, Q15's revenue view and Q17's per-part average each read one
joined or aggregated intermediate from two branches, which the planner
plans as two identical physical subtrees. The pass runs on the final
physical plan (after the overrides and transitions), finds identical
subtrees by ``exec/base.plan_fingerprint`` among the node types whose
fingerprints carry their full identity, and replaces each group with one
shared ``TpuReuseSubtreeExec``: the subtree executes once per query and
every consumer replays its batches. On the card this is also what keeps
Q15 right: its filter compares the revenue view's sums with their
maximum, and two executions of a float sum over atomics need not give
the same bits.

The JAX package also gates on deterministic expressions (a ``rand()``
branch must re-execute); the port has no nondeterministic expression yet
(ROADMAP A.6), and the spill catalog registration of the materialized
batches waits for A.8.
"""

from __future__ import annotations

from collections import Counter
from typing import Iterator, List

from spark_rapids_tpu_torch.columnar.batch import Schema
from spark_rapids_tpu_torch.exec.base import (
    ExecContext, Partition, PhysicalPlan, plan_fingerprint,
)

# node types whose describe() + fingerprint_extra() carry their complete
# behavioral identity (anything else disqualifies the subtree)
_PRECISE = {
    "TpuScanExec", "TpuProjectExec", "TpuFilterExec",
    "TpuHashAggregateExec", "TpuShuffledHashJoinExec",
    "TpuBroadcastHashJoinExec", "TpuBroadcastExchangeExec",
    "TpuShuffleExchangeExec", "TpuSortExec", "TpuCoalesceBatchesExec",
    "TpuCoalescePartitionsExec",
}

# a subtree is only worth materializing when it holds real compute
_WORTH = {"TpuShuffledHashJoinExec", "TpuBroadcastHashJoinExec",
          "TpuHashAggregateExec", "TpuSortExec"}


class TpuReuseSubtreeExec(PhysicalPlan):
    """Executes its child once per query and replays the batches to every
    consumer. The same instance stands at every occurrence of the shared
    subtree; its per-query state lives on the ExecContext."""

    columnar_output = True

    def __init__(self, child: PhysicalPlan):
        super().__init__([child])

    def output_schema(self) -> Schema:
        return self.children[0].output_schema()

    def describe(self) -> str:
        return "TpuReuseSubtreeExec"

    def partitions(self, ctx: ExecContext) -> List[Partition]:
        state = ctx.reuse_state.setdefault(id(self), {"parts": None,
                                                      "data": {}})
        if state["parts"] is None:
            state["parts"] = self.children[0].executed_partitions(ctx)
        parts, data = state["parts"], state["data"]

        def make(i: int) -> Partition:
            def run() -> Iterator:
                if i not in data:
                    data[i] = list(parts[i]())
                return iter(data[i])
            return run
        return [make(i) for i in range(len(parts))]


def _eligible(node: PhysicalPlan, memo: dict) -> bool:
    got = memo.get(id(node))
    if got is None:
        got = (type(node).__name__ in _PRECISE
               and all(_eligible(c, memo) for c in node.children))
        memo[id(node)] = got
    return got


def _worth(node: PhysicalPlan) -> bool:
    return any(type(n).__name__ in _WORTH for n in node.walk())


def reuse_common_subtrees(plan: PhysicalPlan) -> PhysicalPlan:
    """Replace every group of fingerprint-identical eligible subtrees with
    one shared TpuReuseSubtreeExec (the outermost match wins; duplicates
    nested in it collapse with it, since it executes once)."""
    elig: dict = {}
    fp_memo: dict = {}

    def fp(node: PhysicalPlan) -> str:
        got = fp_memo.get(id(node))
        if got is None:
            got = fp_memo[id(node)] = plan_fingerprint(node)
        return got

    counts: Counter = Counter()

    def collect(node: PhysicalPlan) -> None:
        for c in node.children:
            collect(c)
        if node.columnar_output and _eligible(node, elig):
            counts[fp(node)] += 1
    collect(plan)

    shared: dict = {}

    def rewrite(node: PhysicalPlan) -> PhysicalPlan:
        if (node.columnar_output and _eligible(node, elig)
                and counts[fp(node)] >= 2 and _worth(node)):
            w = shared.get(fp(node))
            if w is None:
                w = shared[fp(node)] = TpuReuseSubtreeExec(node)
            return w
        node.children = [rewrite(c) for c in node.children]
        return node

    return rewrite(plan)

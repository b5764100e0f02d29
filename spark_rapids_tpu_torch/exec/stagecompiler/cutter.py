"""Pipeline cutting for whole-stage fusion (counterpart of the JAX
package's ``exec/stagecompiler/cutter.py``).

Walks the CONVERTED physical plan (post TpuOverrides + transitions +
coalesce insertion) and replaces each maximal chain of fusible unary
operators with one ``TpuFusedStageExec``. Everything that is not a
deterministic Project/Filter/Coalesce is a stage boundary — exchanges
(AQE cuts its query stages at the same edges, sql/adaptive/executor
``_is_stage_boundary``; this is the non-AQE twin over the converted
tree), scans, joins, aggregates, host<->device transitions and CPU
fallback operators all end a pipeline.

Two deliberate exclusions keep fusion-ON from regressing existing
fusions:

  * a (Coalesce +) Filter directly below a shuffle/broadcast exchange is
    left out of the chain whenever ``spark.rapids.sql.exchange
    .fuseFilter`` is on and the exchange claims it (its
    ``claims_filter``, which its ``partitions`` runs on) — the concat
    folds exactly that filter in as a single-gather mask
    (exec/tpu._fused_filter_source), which beats running the compaction
    inside a fused stage;
  * chains with fewer than ``spark.rapids.sql.fusion.minOperators``
    compute members do not fuse (fusing one operator only renames its
    dispatch).

The JAX package's input donation (``fusion.donateInputs``) has no
counterpart in eager PyTorch: the conf is accepted and the cutter never
reads it, nor ``spark.rapids.sql.reuseSubtrees.enabled``, which the JAX
package's cutter reads only to keep donation off while reuse is on.
"""

from __future__ import annotations

from typing import List, Optional

from spark_rapids_tpu_torch.exec.base import PhysicalPlan

FUSION_ENABLED_KEY = "spark.rapids.sql.fusion.stageEnabled"
FUSION_MIN_OPS_KEY = "spark.rapids.sql.fusion.minOperators"


def _is_fusible(node: PhysicalPlan) -> bool:
    from spark_rapids_tpu_torch.exec import tpu as tpuexec
    from spark_rapids_tpu_torch.exec.coalesce import TpuCoalesceBatchesExec
    if isinstance(node, TpuCoalesceBatchesExec):
        return True
    if isinstance(node, (tpuexec.TpuProjectExec, tpuexec.TpuFilterExec)):
        return not node._impure
    return False


def _is_compute(node: PhysicalPlan) -> bool:
    """Does this member do real device work? Coalesces are re-batching
    and pure-selection projects are column views with no device work
    (exec/tpu.TpuProjectExec) — neither counts toward minOperators, so a
    chain of views alone never fuses. They still ride along inside a
    chain with real compute, where they are free."""
    from spark_rapids_tpu_torch.exec import tpu as tpuexec
    from spark_rapids_tpu_torch.exec.coalesce import TpuCoalesceBatchesExec
    if isinstance(node, TpuCoalesceBatchesExec):
        return False
    if isinstance(node, tpuexec.TpuProjectExec) and node._pure_selection:
        return False
    return True


def _parent_claims_filter(parent: Optional[PhysicalPlan], conf,
                          session) -> bool:
    """Does the consumer fold a directly-below Filter into its own concat?
    The exchange's own predicate (``claims_filter`` of
    ``exec/tpu.TpuShuffleExchangeExec`` and
    ``exec/tpujoin.TpuBroadcastExchangeExec``), the one its
    ``partitions`` runs on."""
    claims = getattr(parent, "claims_filter", None)
    return claims is not None and claims(conf, session)


def _try_fuse(top: PhysicalPlan, parent: Optional[PhysicalPlan],
              conf, min_ops: int, session=None) -> PhysicalPlan:
    """Fuse the maximal fusible chain starting at ``top`` (downward),
    returning the rewritten node (or ``top`` untouched)."""
    from spark_rapids_tpu_torch.exec.coalesce import TpuCoalesceBatchesExec
    from spark_rapids_tpu_torch.exec.stagecompiler.fusedexec import (
        TpuFusedStageExec,
    )
    from spark_rapids_tpu_torch.exec.tpu import TpuFilterExec
    chain: List[PhysicalPlan] = []
    cur = top
    while _is_fusible(cur) and len(cur.children) == 1:
        chain.append(cur)
        cur = cur.children[0]
    if not chain:
        return top
    # leading coalesces stay OUTSIDE the stage: a coalesce at the chain
    # top re-batches what the CONSUMER sees (insert_coalesce put it
    # there for the consumer's dispatch count), and absorbing it as
    # identity would hand the consumer one low-occupancy fragment per
    # input batch — the interior/bottom absorption rules don't apply
    skip = 0
    while skip < len(chain) and isinstance(chain[skip],
                                           TpuCoalesceBatchesExec):
        skip += 1
    # ...and the exchange-claimed filter below them stays out too.
    # exec/tpu.claimed_filter looks through exactly ONE coalesce, so a
    # filter under two stacked coalesces is NOT claimed and stays
    # eligible for fusion
    if (_parent_claims_filter(parent, conf, session) and skip <= 1
            and skip < len(chain)
            and isinstance(chain[skip], TpuFilterExec)):
        skip += 1
    fused_nodes = chain[skip:]
    if sum(1 for m in fused_nodes if _is_compute(m)) < min_ops:
        return top
    child = fused_nodes[-1].children[0]
    fused = TpuFusedStageExec(child, list(reversed(fused_nodes)))
    # rebuild the unfused prefix (shallow copies) above the fused stage
    out: PhysicalPlan = fused
    for node in reversed(chain[:skip]):
        node = node.map_children(lambda c: c)
        node.children = [out]
        out = node
    return out


def compile_stages(plan: PhysicalPlan, conf, session=None) -> PhysicalPlan:
    """Entry point (sql/overrides.TransitionOverrides wires it in, so
    the single-shot and AQE per-stage paths both fuse). Returns the plan
    UNTOUCHED (same object) when the conf is off. ``session``: the
    session the plan runs in (its exchanges' routes), None outside one."""
    if not conf.get_bool(FUSION_ENABLED_KEY, False):
        return plan
    min_ops = max(1, conf.get_int(FUSION_MIN_OPS_KEY, 2))

    def rec(node: PhysicalPlan) -> PhysicalPlan:
        new_children = []
        for c in node.children:
            c2 = rec(c)
            if not _is_fusible(node):
                # chains cut only at their maximal top: a fusible parent
                # extends the chain upward and cuts at ITS consumer
                c2 = _try_fuse(c2, node, conf, min_ops, session)
            new_children.append(c2)
        out = node.map_children(lambda c: c)
        out.children = new_children
        return out

    root = rec(plan)
    return _try_fuse(root, None, conf, min_ops, session)

"""Operator fusion passes over the converted device plan (counterpart of
the JAX package's ``exec/fusion.py``).

Filter -> Aggregate fusion: a standalone TpuFilterExec compacts its
batch (kernel B1 and one gather per column). Aggregation never needs
compacted rows: the predicate becomes the partial aggregate's live mask
and every gather disappears. Deterministic projections between the
aggregate and the filter are folded in by substituting their expressions
into the aggregate plan. The reference keeps these operators separate
because cuDF gathers are cheap (GpuFilterExec,
basicPhysicalOperators.scala:126); the JAX package fuses them by default
(``spark.rapids.sql.agg.fuseFilter``), and so does the port.

Selection -> Filter fusion: a pure column-reference Project above a
Filter becomes the filter's output selection, so the compaction gathers
only the selected columns.

Nondeterministic filters and projects (rand, the ids) never fuse.
"""

from __future__ import annotations

from typing import List

from spark_rapids_tpu_torch.exec.aggutil import AggPlan
from spark_rapids_tpu_torch.exec.base import PhysicalPlan
from spark_rapids_tpu_torch.sql.exprs.core import BoundRef, Col, Expression


class _Unfusable(Exception):
    pass


def _substitute(e: Expression, bindings: List[Expression],
                names: List[str], memo: dict) -> Expression:
    """Replace column references with the producing project's expressions
    (projection collapse). Unknown reference forms abort fusion. ``memo``
    preserves node SHARING: AggPlan id-dedupes aggregate-function
    instances, so a function object referenced from two result
    expressions must map to ONE substituted object, or the partial schema
    would grow columns the final-mode plan does not expect."""
    hit = memo.get(id(e))
    if hit is not None:
        return hit
    if isinstance(e, BoundRef):
        if e.index >= len(bindings):
            raise _Unfusable()
        out = bindings[e.index]
    elif isinstance(e, Col):
        if e.name not in names:
            raise _Unfusable()
        out = bindings[names.index(e.name)]
    else:
        out = e.map_children(lambda c: _substitute(c, bindings, names, memo))
    memo[id(e)] = out
    return out


def fuse_selection_into_filter(plan: PhysicalPlan, conf) -> PhysicalPlan:
    """Rewrite TpuProjectExec(pure column refs)(TpuFilterExec(child)) into
    one TpuFilterExec with an output selection: the filter's row
    compaction then gathers ONLY the selected columns, so predicate-only
    columns (string chars especially) never move. The narrowing projects
    come from the logical column-pruning pass
    (``sql/pushdown.prune_filter_columns``)."""
    from spark_rapids_tpu_torch.exec import tpu as tpuexec

    def walk(node: PhysicalPlan) -> PhysicalPlan:
        node = node.map_children(walk)
        if not isinstance(node, tpuexec.TpuProjectExec):
            return node
        child = node.children[0]
        if not (isinstance(child, tpuexec.TpuFilterExec)
                and not child._impure and child.out_sel is None):
            return node
        if not all(isinstance(e, BoundRef) for _n, e in node.exprs):
            return node
        names = [n for n, _ in node.exprs]
        idx = [e.index for _n, e in node.exprs]
        return tpuexec.TpuFilterExec(child.children[0], child.condition,
                                     out_sel=(tuple(names), tuple(idx)))

    return walk(plan)


def fuse_filter_into_aggregate(plan: PhysicalPlan, conf) -> PhysicalPlan:
    """Rewrite partial TpuHashAggregateExec(TpuProjectExec* (TpuFilterExec
    (child))) into a fused aggregate with the projects substituted and the
    predicate as the partial's live mask
    (``spark.rapids.sql.agg.fuseFilter``)."""
    from spark_rapids_tpu_torch.exec import tpu as tpuexec
    if not conf.get_bool("spark.rapids.sql.agg.fuseFilter", True):
        return plan

    def walk(node: PhysicalPlan) -> PhysicalPlan:
        node = node.map_children(walk)
        if not (isinstance(node, tpuexec.TpuHashAggregateExec)
                and node.mode == "partial" and node.pre_mask is None):
            return node
        projects = []
        c = node.children[0]
        while isinstance(c, tpuexec.TpuProjectExec) and not c._impure:
            projects.append(c)
            c = c.children[0]
        if not (isinstance(c, tpuexec.TpuFilterExec) and not c._impure):
            return node
        new_child = c.children[0]
        try:
            grouping = [(n, e) for n, e in node.plan.grouping]
            results = [(n, e) for n, e in node.plan.results]
            # fold each intervening projection into the aggregate's
            # expressions (innermost project last); a selection fused
            # into the filter (out_sel) acts as one more projection
            # mapping the narrowed ordinals back to the full child schema
            sub_projects = [list(p.exprs) for p in projects]
            if c.out_sel is not None:
                names_sel, idx_sel = c.out_sel
                full = new_child.output_schema()
                sub_projects.append(
                    [(n, BoundRef(i, full.dtypes[i], n))
                     for n, i in zip(names_sel, idx_sel)])
            for exprs in sub_projects:
                bindings = [e for _, e in exprs]
                names = [n for n, _ in exprs]
                memo: dict = {}
                grouping = [(n, _substitute(e, bindings, names, memo))
                            for n, e in grouping]
                results = [(n, _substitute(e, bindings, names, memo))
                           for n, e in results]
            new_plan = AggPlan(new_child.output_schema(), grouping, results)
        except _Unfusable:
            return node
        return tpuexec.TpuHashAggregateExec(new_child, new_plan,
                                            "partial", pre_mask=c.condition)

    return walk(plan)

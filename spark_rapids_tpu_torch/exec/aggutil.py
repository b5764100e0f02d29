"""Shared aggregation planning (counterpart of the JAX package's
``exec/aggutil.py``).

Decomposes aggregate result expressions into the update/merge/finalize
pipeline — the reference's bound-reference plumbing for partial/final modes
(aggregate.scala:227-509). ``bind_non_agg`` is a copy of the JAX package's
``sql/planner._bind_non_agg``.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from spark_rapids_tpu_torch.columnar.batch import Schema
from spark_rapids_tpu_torch.columnar.dtype import DType
from spark_rapids_tpu_torch.sql.exprs.aggregates import (
    AggregateFunction, find_aggregates,
)
from spark_rapids_tpu_torch.sql.exprs.core import (
    BoundRef, Col, Expression, bind_references,
)


class AggPlan:
    """Static description of a grouped aggregation.

    grouping: [(name, expr over child schema)]
    results:  [(name, expr containing AggregateFunction nodes)]
    """

    def __init__(self, child_schema: Schema,
                 grouping: Sequence[Tuple[str, Expression]],
                 results: Sequence[Tuple[str, Expression]]):
        self.child_schema = child_schema
        self.grouping = list(grouping)
        self.results = list(results)

        # distinct aggregate function instances in result order
        self.agg_fns: List[AggregateFunction] = []
        seen = set()
        for _, e in self.results:
            for fn in find_aggregates(e):
                if id(fn) not in seen:
                    seen.add(id(fn))
                    self.agg_fns.append(fn)

        # update inputs: expressions evaluated per input row pre-reduction
        self.update_inputs: List[Expression] = []
        # per agg fn: list of (kind, update_input_index, intermediate dtype)
        self.update_plan: List[List[Tuple[str, int, DType]]] = []
        for fn in self.agg_fns:
            ops = []
            inter_dts = fn.intermediate_dtypes(child_schema)
            for (kind, child_idx), idt in zip(fn.update_ops(), inter_dts):
                self.update_inputs.append(fn.children[child_idx])
                ops.append((kind, len(self.update_inputs) - 1, idt))
            self.update_plan.append(ops)

        # intermediate (partial-output) schema: keys then intermediates
        names, dts = [], []
        for name, e in self.grouping:
            names.append(name)
            dts.append(e.dtype(child_schema))
        self.num_keys = len(names)
        i = 0
        for ops in self.update_plan:
            for _kind, _, idt in ops:
                names.append(f"_agg{i}")
                dts.append(idt)
                i += 1
        self.partial_schema = Schema(names, dts)

        # merge plan over the partial schema: [(kind, partial_col_index)]
        self.merge_plan: List[List[Tuple[str, int, DType]]] = []
        col = self.num_keys
        for fn, ops in zip(self.agg_fns, self.update_plan):
            merged = []
            for kind_merge, (_, _, idt) in zip(fn.merge_ops(), ops):
                merged.append((kind_merge, col, idt))
                col += 1
            self.merge_plan.append(merged)

        # final output schema; key results are Col(grouping name) refs
        gdt = {n: dt for (n, _), dt in zip(self.grouping,
                                            dts[:self.num_keys])}
        out_dts = []
        for _, e in self.results:
            if isinstance(e, Col) and e.name in gdt:
                out_dts.append(gdt[e.name])
            else:
                out_dts.append(e.dtype(child_schema))
        self.output_schema = Schema([n for n, _ in self.results], out_dts)

    @property
    def update_reductions(self) -> List[Tuple[str, int, DType]]:
        return [op for ops in self.update_plan for op in ops]

    @property
    def merge_reductions(self) -> List[Tuple[str, int, DType]]:
        return [op for ops in self.merge_plan for op in ops]

    def finalize_exprs(self) -> List[Tuple[str, Expression]]:
        """Result expressions over the *merged partial schema*: aggregate
        nodes replaced by finalize() over intermediate BoundRefs; grouping
        expressions replaced by key-column BoundRefs."""
        fn_final: Dict[int, Expression] = {}
        col = self.num_keys
        for fn, ops in zip(self.agg_fns, self.update_plan):
            refs = []
            for _kind, _, idt in ops:
                refs.append(BoundRef(col, idt, self.partial_schema.names[col]))
                col += 1
            fn_final[id(fn)] = fn.finalize(refs, self.child_schema)

        group_map = {name: i for i, (name, _) in enumerate(self.grouping)}

        def rewrite(e: Expression) -> Expression:
            if isinstance(e, AggregateFunction):
                return fn_final[id(e)]
            if isinstance(e, Col) and e.name in group_map:
                i = group_map[e.name]
                return BoundRef(i, self.partial_schema.dtypes[i], e.name)
            return e.map_children(rewrite)

        return [(name, rewrite(e)) for name, e in self.results]


def bind_non_agg(e: Expression, schema: Schema) -> Expression:
    """Bind column refs inside aggregate result expressions, leaving Col
    nodes that name grouping outputs for AggPlan.finalize_exprs."""

    def bind(x):
        if isinstance(x, AggregateFunction):
            return x.map_children(lambda c: bind_references(c, schema))
        if isinstance(x, Col):
            return x  # resolved against grouping names at finalize
        return x.map_children(bind)
    return bind(e)

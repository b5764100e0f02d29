"""Fused count-distinct execution (counterpart of the JAX package's
``exec/aggfuse.py``).

The DataFrame layer expands ``distinct().group_by(G2).count()`` into a
two-level aggregation:

    Agg(final G2, count) / Exch / Agg(partial G2, count)
      / Agg(final G1) / Exch / Agg(partial G1) / child      G1 = G2 + K

``fuse_count_distinct`` finds that chain on the final physical plan and
replaces it with one ``TpuCountDistinctExec``, which concatenates its
child's batches and counts in one pass, by the JAX package's route on a
TPU:

  * the hash spelling when every key is fixed-width or a dictionary: two
    group assignments over B3 (``ops/kernels.hash_group_ids``), the
    distinct G1 tuples, then the G2 groups of their representative rows;
  * the sorted spelling (``ops/aggregate.count_distinct_reduce``) when a
    key is a char slab or plain chars, which have no exact one-word
    image, or when the
    tuple is wider than B3's widest key (``MAX_KEY_WORDS``).

The gate is the JAX package's: bare-column keys, at most 32 of them, one
``count(*)`` and otherwise bare key references in the results, a
non-empty outer grouping. ``spark.rapids.sql.agg.fuseCountDistinct``
(true) turns the pass off. ``ROUTES`` counts each spelling's runs.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Tuple

import torch

from spark_rapids_tpu_torch.columnar import dtype as dtypes
from spark_rapids_tpu_torch.columnar.batch import DeviceBatch, Schema
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.exec.base import (
    ExecContext, Partition, PhysicalPlan,
)
from spark_rapids_tpu_torch.obs.metrics import bump

ROUTES = {"hash": 0, "sorted": 0}
# the widest key B3 builds (csrc/hash_table.cuh kMaxKeys): a G1 tuple of
# more keys (one word each, and one of validity bits) takes the sort
MAX_KEY_WORDS = 8


def reset_routes() -> None:
    for k in ROUTES:
        ROUTES[k] = 0


def _hash_count_distinct(batch: DeviceBatch, g2_idx: List[int],
                         rest_idx: List[int]):
    """(rep_rows, counts, num_groups) over two ``hash_group_ids`` builds:
    the distinct G1 tuples, then the G2 groups of each tuple's first row.
    A key's image is its value image (a dictionary's code) where valid, 0
    where NULL; one more word holds the keys' validity bits, so NULL is a
    value of its own."""
    from spark_rapids_tpu_torch.ops import kernels
    from spark_rapids_tpu_torch.ops.sortops import u64_key_image

    def images(idx_list):
        imgs = []
        nullsig = torch.zeros(batch.capacity, dtype=torch.int64,
                              device=batch.device)
        for j, ci in enumerate(idx_list):
            col = batch.columns[ci]
            imgs.extend(torch.where(col.validity, im, torch.zeros_like(im))
                        for im in u64_key_image(col, allow_dict=True))
            nullsig |= col.validity.to(torch.int64) << j
        return imgs + [nullsig]

    cap = batch.capacity
    dev = batch.device
    valid = batch.row_mask()
    T = kernels.hash_table_size(cap)
    rows = torch.arange(cap, dtype=torch.int32, device=dev)
    gid1, _n1, rep1 = kernels.hash_group_ids(images(g2_idx + rest_idx),
                                             valid, T)
    first = (gid1 >= 0) & (rows == rep1[gid1.clamp(0, cap - 1).long()])
    gid2, n2, rep2 = kernels.hash_group_ids(images(g2_idx), first, T)
    counts = torch.zeros(cap + 1, dtype=torch.int64, device=dev)
    counts.index_add_(0, torch.where(first, gid2,
                                     torch.full_like(gid2, cap)).long(),
                      torch.ones(cap, dtype=torch.int64, device=dev))
    return rep2, counts[:cap], n2


class TpuCountDistinctExec(PhysicalPlan):
    """One-pass grouped distinct count (see the module docstring).
    ``out_plan``: for each output column, ("key", child column index) or
    ("count", None), in output-schema order."""

    columnar_output = True

    def __init__(self, child: PhysicalPlan, out_schema: Schema,
                 out_plan: List[Tuple[str, Optional[int]]],
                 g2_idx: List[int], rest_idx: List[int]):
        super().__init__([child])
        self._schema = out_schema
        self.out_plan = list(out_plan)
        self.g2_idx = list(g2_idx)
        self.rest_idx = list(rest_idx)

    def output_schema(self) -> Schema:
        return self._schema

    def describe(self) -> str:
        return (f"TpuCountDistinctExec(g2={self.g2_idx}, "
                f"distinct={self.rest_idx})")

    def fingerprint_extra(self) -> str:
        return f"{self.out_plan}|{self._schema!r}"

    def count(self, batch: DeviceBatch) -> DeviceBatch:
        """The grouped distinct counts of one batch."""
        from spark_rapids_tpu_torch.ops.aggregate import count_distinct_reduce
        from spark_rapids_tpu_torch.ops.rowops import gather_columns
        keys = self.g2_idx + self.rest_idx
        if (any(batch.columns[ci].dtype.is_string
                and batch.columns[ci].dict_values is None for ci in keys)
                or len(keys) + 1 > MAX_KEY_WORDS):
            bump(ROUTES, "sorted")
            rep_rows, counts, n_groups = count_distinct_reduce(
                batch, self.g2_idx, self.rest_idx)
        else:
            bump(ROUTES, "hash")
            rep_rows, counts, n_groups = _hash_count_distinct(
                batch, self.g2_idx, self.rest_idx)
        cap = batch.capacity
        live = torch.arange(cap, dtype=torch.int32,
                            device=batch.device) < n_groups
        key_cols = iter(gather_columns(
            [batch.columns[ci] for kind, ci in self.out_plan
             if kind == "key"], rep_rows, live))
        cols: List[DeviceColumn] = []
        for kind, _ci in self.out_plan:
            cols.append(next(key_cols) if kind == "key" else DeviceColumn(
                dtypes.INT64, torch.where(live, counts,
                                          torch.zeros_like(counts)), live))
        return DeviceBatch(self._schema, cols, n_groups.to(torch.int32))

    def partitions(self, ctx: ExecContext) -> List[Partition]:
        from spark_rapids_tpu_torch.exec.tpu import concat_device
        child_parts = self.children[0].executed_partitions(ctx)
        schema = self.children[0].output_schema()

        def run() -> Iterator[DeviceBatch]:
            batches = [b for p in child_parts for b in p()]
            if not batches:
                from spark_rapids_tpu_torch.exec.tpu import empty_batch
                yield empty_batch(self._schema, ctx.device)
                return
            yield self.count(concat_device(batches, schema,
                                           ctx.conf.capacity_growth,
                                           ctx.device))
        return [run]


def _strip_alias(e):
    from spark_rapids_tpu_torch.sql.exprs.core import Alias
    while isinstance(e, Alias):
        e = e.children[0]
    return e


def _is_count_star(e) -> bool:
    from spark_rapids_tpu_torch.sql.exprs.aggregates import Count
    from spark_rapids_tpu_torch.sql.exprs.core import Literal
    e = _strip_alias(e)
    return (isinstance(e, Count)
            and isinstance(_strip_alias(e.children[0]), Literal))


def _skip_coalesce(node: PhysicalPlan) -> PhysicalPlan:
    from spark_rapids_tpu_torch.exec.coalesce import TpuCoalesceBatchesExec
    while isinstance(node, TpuCoalesceBatchesExec):
        node = node.children[0]
    return node


def _match_chain(node: PhysicalPlan) -> Optional[TpuCountDistinctExec]:
    """Match AggF(G2, count) / Exch / AggP(G2) / AggF(G1) / Exch / AggP(G1)
    / child (coalesce operators anywhere between): the replacement exec,
    or None."""
    from spark_rapids_tpu_torch.exec.tpu import (
        TpuHashAggregateExec, TpuShuffleExchangeExec,
    )
    from spark_rapids_tpu_torch.sql.exprs.core import BoundRef, Col

    def agg(n, mode):
        n = _skip_coalesce(n)
        return n if (isinstance(n, TpuHashAggregateExec)
                     and n.mode == mode) else None

    def exch(n):
        n = _skip_coalesce(n)
        return n if isinstance(n, TpuShuffleExchangeExec) else None

    # a partial carrying a fused filter (exec/fusion.py) takes no part,
    # as in the JAX package: the fused pass has no row mask
    fo = agg(node, "final")
    ex_o = fo and exch(fo.children[0])
    po = ex_o and agg(ex_o.children[0], "partial")
    if po is None or po.plan is not fo.plan or po.pre_mask is not None:
        return None
    fi = agg(po.children[0], "final")
    ex_i = fi and exch(fi.children[0])
    pi = ex_i and agg(ex_i.children[0], "partial")
    if pi is None or pi.plan is not fi.plan or pi.pre_mask is not None:
        return None
    child = _skip_coalesce(pi.children[0])
    plan_o, plan_i = fo.plan, fi.plan
    # the inner level is a pure distinct: no aggregate, results = keys
    if plan_i.agg_fns:
        return None
    g1_names = [n for n, _ in plan_i.grouping]
    if [n for n, _ in plan_i.results] != g1_names:
        return None
    # the outer level: one count(*), a non-empty grouping (a global
    # count distinct returns one row on empty input, the fused pass none)
    if len(plan_o.agg_fns) != 1 or not _is_count_star(plan_o.agg_fns[0]):
        return None
    g2_names = [n for n, _ in plan_o.grouping]
    if not g2_names or not set(g2_names) <= set(g1_names):
        return None
    if len(g1_names) > 32:
        return None
    # outer keys are bare references to the same-named inner outputs
    for n, e in plan_o.grouping:
        e = _strip_alias(e)
        if isinstance(e, BoundRef):
            if not (0 <= e.index < len(g1_names)
                    and g1_names[e.index] == n):
                return None
        elif not (isinstance(e, Col) and e.name == n):
            return None
    # inner keys are bare columns of the child
    child_schema = child.output_schema()
    g1_child_idx = {}
    for n, e in plan_i.grouping:
        e = _strip_alias(e)
        if isinstance(e, BoundRef):
            g1_child_idx[n] = e.index
        elif isinstance(e, Col) and e.name in child_schema.names:
            g1_child_idx[n] = child_schema.index_of(e.name)
        else:
            return None
    out_plan: List[Tuple[str, Optional[int]]] = []
    for name, e in plan_o.results:
        e = _strip_alias(e)
        if _is_count_star(e):
            out_plan.append(("count", None))
        elif isinstance(e, (Col, BoundRef)) and e.name in g2_names:
            out_plan.append(("key", g1_child_idx[e.name]))
        else:
            return None
    if sum(1 for k, _ in out_plan if k == "count") != 1:
        return None
    g2_idx = [g1_child_idx[n] for n in g2_names]
    rest_idx = [g1_child_idx[n] for n in g1_names if n not in set(g2_names)]
    return TpuCountDistinctExec(child, plan_o.output_schema, out_plan,
                                g2_idx, rest_idx)


def fuse_count_distinct(plan: PhysicalPlan) -> PhysicalPlan:
    """Bottom-up rewrite replacing every matched chain."""
    plan.children = [fuse_count_distinct(c) for c in plan.children]
    replaced = _match_chain(plan)
    return replaced if replaced is not None else plan

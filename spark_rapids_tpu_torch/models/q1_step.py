"""TPC-H Q1, Q6 and the Q18 group-by on the device (counterpart of the JAX
package's ``models/q1_step.py``, plus the query runners of this slice).

``q1_partial_step`` is the flagship step: the Q1 shipdate filter then the
partial aggregate (8 aggregates over 2 dictionary-coded string keys). The
``run_*`` functions run one query end to end the way the JAX session
composes it: upload each batch -> partial step -> concat (the exchange
collapse on one device) -> final merge -> finalize -> ``to_pandas``. Q6
is a filter then a keyless sum; the Q18 group-by is ``group by
l_orderkey, sum(l_quantity)`` through the hash-aggregation branch, then
``having sum_qty > 300``. Sort is not in this slice: results come back in
group order, not sorted.
"""

from __future__ import annotations

import datetime
from typing import Callable, List, Sequence, Tuple

import pandas as pd

from spark_rapids_tpu_torch.columnar.batch import (
    DeviceBatch, Schema, bucket_capacity,
)
from spark_rapids_tpu_torch.exec.aggutil import AggPlan, bind_non_agg
from spark_rapids_tpu_torch.ops import rowops
from spark_rapids_tpu_torch.ops.aggregate import aggregate_merge, aggregate_update
from spark_rapids_tpu_torch.sql import functions as F
from spark_rapids_tpu_torch.sql.exprs.core import Expression, bind_references
from spark_rapids_tpu_torch.sql.exprs.evalbridge import (
    eval_projection, make_context, to_device_column,
)

Q1_COLUMNS = ["l_returnflag", "l_linestatus", "l_quantity",
              "l_extendedprice", "l_discount", "l_tax", "l_shipdate"]
Q6_COLUMNS = ["l_shipdate", "l_discount", "l_quantity", "l_extendedprice"]
Q18_COLUMNS = ["l_orderkey", "l_quantity"]

# slot budget of the Q18 hash aggregation: 2^24 slots take the merge of two
# 2^22-row partials (capacity 2^23, table 2^24)
Q18_HASH_SLOTS = 1 << 24

Step = Callable[[DeviceBatch], DeviceBatch]


def _plan(schema: Schema, keys: Sequence[str],
          results: Sequence[Tuple[str, F.Column]]) -> AggPlan:
    grouping = [(k, bind_references(F.col(k).expr, schema)) for k in keys]
    return AggPlan(schema, grouping,
                   [(name, bind_non_agg(c.expr, schema))
                    for name, c in results])


def build_q1_agg_plan(schema: Schema) -> AggPlan:
    disc_price = F.col("l_extendedprice") * (1 - F.col("l_discount"))
    charge = (F.col("l_extendedprice") * (1 - F.col("l_discount"))
              * (1 + F.col("l_tax")))
    return _plan(schema, ["l_returnflag", "l_linestatus"], [
        ("l_returnflag", F.col("l_returnflag")),
        ("l_linestatus", F.col("l_linestatus")),
        ("sum_qty", F.sum("l_quantity")),
        ("sum_base_price", F.sum("l_extendedprice")),
        ("sum_disc_price", F.sum(disc_price)),
        ("sum_charge", F.sum(charge)),
        ("avg_qty", F.avg("l_quantity")),
        ("avg_price", F.avg("l_extendedprice")),
        ("avg_disc", F.avg("l_discount")),
        ("count_order", F.count("*")),
    ])


def _filtered_partial_step(schema: Schema, plan: AggPlan,
                           cond: F.Column, hash_table: int = None) -> Step:
    bound = bind_references(cond.expr, schema)
    key_exprs = [e for _, e in plan.grouping]
    reductions = plan.update_reductions

    def step(batch: DeviceBatch) -> DeviceBatch:
        batch = _filter(batch, bound)
        return aggregate_update(batch, key_exprs, plan.update_inputs,
                                reductions, plan.partial_schema,
                                hash_table=hash_table)
    return step


def q1_partial_step(schema: Schema) -> Tuple[Step, AggPlan]:
    """Returns (fn(batch) -> partial DeviceBatch, plan)."""
    plan = build_q1_agg_plan(schema)
    cond = F.col("l_shipdate") <= datetime.date(1998, 9, 2)
    return _filtered_partial_step(schema, plan, cond), plan


def q6_partial_step(schema: Schema) -> Tuple[Step, AggPlan]:
    plan = _plan(schema, [], [
        ("revenue", F.sum(F.col("l_extendedprice") * F.col("l_discount")))])
    cond = ((F.col("l_shipdate") >= datetime.date(1994, 1, 1))
            & (F.col("l_shipdate") < datetime.date(1995, 1, 1))
            & (F.col("l_discount") >= 0.05) & (F.col("l_discount") <= 0.07)
            & (F.col("l_quantity") < 24.0))
    return _filtered_partial_step(schema, plan, cond), plan


def q18_partial_step(schema: Schema) -> Tuple[Step, AggPlan]:
    plan = _plan(schema, ["l_orderkey"], [
        ("l_orderkey", F.col("l_orderkey")),
        ("sum_qty", F.sum("l_quantity"))])
    key_exprs = [e for _, e in plan.grouping]

    def step(batch: DeviceBatch) -> DeviceBatch:
        return aggregate_update(batch, key_exprs, plan.update_inputs,
                                plan.update_reductions, plan.partial_schema,
                                hash_table=Q18_HASH_SLOTS)
    return step, plan


def example_lineitem_batch(rows: int = 4096, device="cuda") -> DeviceBatch:
    from spark_rapids_tpu_torch.models.tpch_data import gen_lineitem
    df = gen_lineitem(rows / 6_000_000).head(rows)
    return DeviceBatch.from_pandas(df, device=device)


def entry_fn(device="cuda") -> Tuple:
    """(fn, example args): the flagship step and one lineitem batch."""
    batch = example_lineitem_batch(device=device)
    step, _ = q1_partial_step(batch.schema)
    return step, (batch,)


# ---------------------------------------------------------------------------
# Query runners
# ---------------------------------------------------------------------------

def upload_batches(df: pd.DataFrame, columns: Sequence[str],
                   batch_rows: int, device="cuda") -> List[DeviceBatch]:
    """Upload ``columns`` of ``df`` in batches of ``batch_rows`` rows, the
    way a file scan does (string columns dictionary-encoded per batch,
    numeric columns not)."""
    df = df[list(columns)]
    return [DeviceBatch.from_pandas(df.iloc[s:s + batch_rows],
                                    dict_numerics=False, device=device)
            for s in range(0, max(len(df), 1), batch_rows)]


def two_phase(batches: Sequence[DeviceBatch], step: Step, plan: AggPlan,
              hash_table: int = None) -> DeviceBatch:
    """Partial step per batch -> concat -> final merge -> finalize."""
    partials = [step(b) for b in batches]
    out_cap = bucket_capacity(sum(p.capacity for p in partials))
    merged = aggregate_merge(rowops.concat_batches(partials, out_cap),
                             plan.num_keys, plan.merge_reductions,
                             plan.partial_schema, hash_table=hash_table)
    final = plan.finalize_exprs()
    return eval_projection(merged, [e for _, e in final],
                           [n for n, _ in final])


def _filter(batch: DeviceBatch, bound_cond: Expression) -> DeviceBatch:
    ctx = make_context(batch)
    pred = to_device_column(ctx, bound_cond.eval_device(ctx))
    return rowops.filter_batch(batch, pred.data & pred.validity)


def filter_rows(batch: DeviceBatch, cond: F.Column) -> DeviceBatch:
    return _filter(batch, bind_references(cond.expr, batch.schema))


def q1_from_batches(batches: Sequence[DeviceBatch]) -> DeviceBatch:
    step, plan = q1_partial_step(batches[0].schema)
    return two_phase(batches, step, plan)


def q6_from_batches(batches: Sequence[DeviceBatch]) -> DeviceBatch:
    step, plan = q6_partial_step(batches[0].schema)
    return two_phase(batches, step, plan)


def q18_agg_from_batches(batches: Sequence[DeviceBatch]
                         ) -> Tuple[DeviceBatch, DeviceBatch]:
    """(the full group-by, the rows with sum_qty > 300)."""
    step, plan = q18_partial_step(batches[0].schema)
    grouped = two_phase(batches, step, plan, hash_table=Q18_HASH_SLOTS)
    return grouped, filter_rows(grouped, F.col("sum_qty") > 300)


def run_q1(df: pd.DataFrame, batch_rows: int, device="cuda") -> pd.DataFrame:
    return q1_from_batches(upload_batches(df, Q1_COLUMNS, batch_rows,
                                          device)).to_pandas()


def run_q6(df: pd.DataFrame, batch_rows: int, device="cuda") -> pd.DataFrame:
    return q6_from_batches(upload_batches(df, Q6_COLUMNS, batch_rows,
                                          device)).to_pandas()


def run_q18_agg(df: pd.DataFrame, batch_rows: int,
                device="cuda") -> pd.DataFrame:
    _grouped, having = q18_agg_from_batches(
        upload_batches(df, Q18_COLUMNS, batch_rows, device))
    return having.to_pandas()

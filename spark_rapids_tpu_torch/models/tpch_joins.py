"""TPC-H Q3 and Q4 on the device: the port's join queries, composed exactly
as the JAX package's ``models/tpch.py`` q3 and q4 compose them (same
filters, same join order and sides), through ``exec/tpujoin.hash_join``.

  * Q3: customer (``c_mktsegment = 'BUILDING'``) inner-joins orders
    (``o_orderdate < 1995-03-15``) on custkey, that inner-joins lineitem
    (``l_shipdate > 1995-03-15``) on orderkey; group by (l_orderkey,
    o_orderdate, o_shippriority) summing ``l_extendedprice * (1 -
    l_discount)`` on the hash branch (kernel B2) with a slot budget, as the
    Q18 group-by does; order by revenue desc, o_orderdate; limit 10.
  * Q4: orders of 1993-07-01 .. 1993-10-01 left-semi-join the lineitem
    rows with ``l_commitdate < l_receiptdate`` on orderkey; group by the
    dictionary column o_orderpriority counting rows; order by it.

Every join runs on kernels B3 and B4; filters and compactions on B1. Each
table is uploaded in batches the way a file scan yields them (only the
columns the query reads). ``run_q3``/``run_q4`` take pandas frames and
return pandas.
"""

from __future__ import annotations

import datetime
from typing import Dict, List, Sequence

import pandas as pd

from spark_rapids_tpu_torch.columnar.batch import DeviceBatch
from spark_rapids_tpu_torch.exec import tpujoin
from spark_rapids_tpu_torch.models import q1_step as Q
from spark_rapids_tpu_torch.ops import rowops
from spark_rapids_tpu_torch.ops.aggregate import aggregate_update
from spark_rapids_tpu_torch.ops.sortops import sort_batch
from spark_rapids_tpu_torch.sql import functions as F

Tables = Dict[str, List[DeviceBatch]]

BATCH_ROWS = 1 << 23

Q3_COLUMNS = {
    "customer": ["c_custkey", "c_mktsegment"],
    "orders": ["o_orderkey", "o_custkey", "o_orderdate", "o_shippriority"],
    "lineitem": ["l_orderkey", "l_extendedprice", "l_discount",
                 "l_shipdate"],
}
Q4_COLUMNS = {
    "orders": ["o_orderkey", "o_orderdate", "o_orderpriority"],
    "lineitem": ["l_orderkey", "l_commitdate", "l_receiptdate"],
}

# slot budget of the Q3 hash aggregation, as the Q18 group-by's: tables
# of up to 2^24 slots, for join outputs of up to 2^23 rows of capacity
Q3_HASH_SLOTS = 1 << 24
Q3_CUTOFF = datetime.date(1995, 3, 15)
Q3_LIMIT = 10


def upload_tables(frames: Dict[str, pd.DataFrame],
                  columns: Dict[str, Sequence[str]], batch_rows: int,
                  device="cuda") -> Tables:
    """Upload the ``columns`` of each table in batches of ``batch_rows``
    rows (``q1_step.upload_batches``)."""
    return {name: Q.upload_batches(frames[name], cols, batch_rows, device)
            for name, cols in columns.items()}


def upload_q3(frames: Dict[str, pd.DataFrame], batch_rows: int = BATCH_ROWS,
              device="cuda") -> Tables:
    return upload_tables(frames, Q3_COLUMNS, batch_rows, device)


def upload_q4(frames: Dict[str, pd.DataFrame], batch_rows: int = BATCH_ROWS,
              device="cuda") -> Tables:
    return upload_tables(frames, Q4_COLUMNS, batch_rows, device)


def _filter_all(batches: Sequence[DeviceBatch],
                cond: F.Column) -> List[DeviceBatch]:
    return [Q.filter_rows(b, cond) for b in batches]


def _index(batches: Sequence[DeviceBatch], name: str) -> int:
    return batches[0].schema.index_of(name)


def q3_from_batches(t: Tables) -> DeviceBatch:
    cust = _filter_all(t["customer"], F.col("c_mktsegment") == "BUILDING")
    orders = _filter_all(t["orders"], F.col("o_orderdate") < Q3_CUTOFF)
    li = _filter_all(t["lineitem"], F.col("l_shipdate") > Q3_CUTOFF)
    co = tpujoin.hash_join(cust, orders, "inner",
                           [_index(cust, "c_custkey")],
                           [_index(orders, "o_custkey")])
    joined = tpujoin.hash_join(co, li, "inner", [_index(co, "o_orderkey")],
                               [_index(li, "l_orderkey")])
    revenue = F.col("l_extendedprice") * (1 - F.col("l_discount"))
    plan = Q._plan(joined[0].schema,
                   ["l_orderkey", "o_orderdate", "o_shippriority"], [
                       ("l_orderkey", F.col("l_orderkey")),
                       ("o_orderdate", F.col("o_orderdate")),
                       ("o_shippriority", F.col("o_shippriority")),
                       ("revenue", F.sum(revenue))])
    key_exprs = [e for _, e in plan.grouping]

    def step(batch: DeviceBatch) -> DeviceBatch:
        return aggregate_update(batch, key_exprs, plan.update_inputs,
                                plan.update_reductions, plan.partial_schema,
                                hash_table=Q3_HASH_SLOTS)
    grouped = Q.two_phase(joined, step, plan, hash_table=Q3_HASH_SLOTS)
    ordered = sort_batch(grouped, [grouped.schema.index_of("revenue"),
                                   grouped.schema.index_of("o_orderdate")],
                         [False, True], [False, True])
    return rowops.slice_batch(ordered, 0, Q3_LIMIT)


def q4_from_batches(t: Tables) -> DeviceBatch:
    late = _filter_all(t["lineitem"],
                       F.col("l_commitdate") < F.col("l_receiptdate"))
    orders = _filter_all(t["orders"],
                         (F.col("o_orderdate") >= datetime.date(1993, 7, 1))
                         & (F.col("o_orderdate") < datetime.date(1993, 10, 1)))
    semi = tpujoin.hash_join(orders, late, "leftsemi",
                             [_index(orders, "o_orderkey")],
                             [_index(late, "l_orderkey")])
    plan = Q._plan(semi[0].schema, ["o_orderpriority"], [
        ("o_orderpriority", F.col("o_orderpriority")),
        ("order_count", F.count("*"))])
    key_exprs = [e for _, e in plan.grouping]

    def step(batch: DeviceBatch) -> DeviceBatch:
        return aggregate_update(batch, key_exprs, plan.update_inputs,
                                plan.update_reductions, plan.partial_schema)
    grouped = Q.two_phase(semi, step, plan)
    return sort_batch(grouped, [grouped.schema.index_of("o_orderpriority")],
                      [True], [True])


def run_q3(frames: Dict[str, pd.DataFrame], batch_rows: int = BATCH_ROWS,
           device="cuda") -> pd.DataFrame:
    """TPC-H Q3 over the ``customer``, ``orders`` and ``lineitem`` frames."""
    return q3_from_batches(upload_q3(frames, batch_rows, device)).to_pandas()


def run_q4(frames: Dict[str, pd.DataFrame], batch_rows: int = BATCH_ROWS,
           device="cuda") -> pd.DataFrame:
    """TPC-H Q4 over the ``orders`` and ``lineitem`` frames."""
    return q4_from_batches(upload_q4(frames, batch_rows, device)).to_pandas()

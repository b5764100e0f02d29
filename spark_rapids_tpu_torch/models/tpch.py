"""TPC-H queries over the port's DataFrame API (counterpart of the JAX
package's ``models/tpch.py``: Q1, Q3, Q4, Q6, Q10, Q17, Q18, Q21 and the
first stage of Q18, copied).

Each query is a function (session, tables) -> DataFrame, ``tables`` a map
of table name -> DataFrame (``session.create_dataframe`` of the frames of
``models/tpch_data.py``, or ``session.read.parquet`` of the files of
``tpch_data.write_parquet``). Every query runs at the JAX package's
default confs. ``HASH_AGG_CONFS`` turns on the one-pass hash aggregation
(kernel B2) for the unbounded group-by keys (Q3's, the Q18 group-by's),
which otherwise take the sorted-payload branch.
"""

from __future__ import annotations

import datetime

from spark_rapids_tpu_torch.models.q1_step import Q18_HASH_SLOTS
from spark_rapids_tpu_torch.sql import functions as F

# the hash branch on, with the query runners' slot budget (the merge of
# two 2^22-row partials takes 2^24)
HASH_AGG_CONFS = {"spark.rapids.sql.agg.hashAggEnabled": True,
                  "spark.rapids.sql.agg.hash.maxTableSlots": Q18_HASH_SLOTS}


def q1(s, t):
    """Pricing summary report."""
    li = t["lineitem"]
    disc_price = F.col("l_extendedprice") * (1 - F.col("l_discount"))
    charge = (F.col("l_extendedprice") * (1 - F.col("l_discount"))
              * (1 + F.col("l_tax")))
    return (li.filter(F.col("l_shipdate") <= datetime.date(1998, 9, 2))
            .group_by("l_returnflag", "l_linestatus")
            .agg(F.sum("l_quantity").alias("sum_qty"),
                 F.sum("l_extendedprice").alias("sum_base_price"),
                 F.sum(disc_price).alias("sum_disc_price"),
                 F.sum(charge).alias("sum_charge"),
                 F.avg("l_quantity").alias("avg_qty"),
                 F.avg("l_extendedprice").alias("avg_price"),
                 F.avg("l_discount").alias("avg_disc"),
                 F.count("*").alias("count_order"))
            .order_by("l_returnflag", "l_linestatus"))


def _revenue():
    return F.col("l_extendedprice") * (1 - F.col("l_discount"))


def q3(s, t):
    """Shipping-priority top unshipped orders."""
    cutoff = datetime.date(1995, 3, 15)
    cust = t["customer"].filter(F.col("c_mktsegment") == "BUILDING")
    orders = t["orders"].filter(F.col("o_orderdate") < cutoff)
    li = t["lineitem"].filter(F.col("l_shipdate") > cutoff)
    return (cust.join(orders, left_on=["c_custkey"], right_on=["o_custkey"])
            .join(li, left_on=["o_orderkey"], right_on=["l_orderkey"])
            .group_by("l_orderkey", "o_orderdate", "o_shippriority")
            .agg(F.sum(_revenue()).alias("revenue"))
            .order_by(F.col("revenue").desc(), "o_orderdate")
            .limit(10))


def q4(s, t):
    """Order-priority checking: orders with a late lineitem."""
    late = t["lineitem"].filter(F.col("l_commitdate") < F.col("l_receiptdate"))
    orders = t["orders"].filter(
        (F.col("o_orderdate") >= datetime.date(1993, 7, 1))
        & (F.col("o_orderdate") < datetime.date(1993, 10, 1)))
    return (orders.join(late, left_on=["o_orderkey"], right_on=["l_orderkey"],
                        how="leftsemi")
            .group_by("o_orderpriority")
            .agg(F.count("*").alias("order_count"))
            .order_by("o_orderpriority"))


def q6(s, t):
    """Forecasting revenue change."""
    li = t["lineitem"]
    return (li.filter(
        (F.col("l_shipdate") >= datetime.date(1994, 1, 1))
        & (F.col("l_shipdate") < datetime.date(1995, 1, 1))
        & (F.col("l_discount") >= 0.05) & (F.col("l_discount") <= 0.07)
        & (F.col("l_quantity") < 24.0))
        .agg(F.sum(F.col("l_extendedprice") * F.col("l_discount"))
             .alias("revenue")))


def q18_groupby(s, t):
    """Large-volume customers, first stage: the orders whose lines sum to
    more than 300 units."""
    return (t["lineitem"].group_by("l_orderkey")
            .agg(F.sum("l_quantity").alias("sum_qty"))
            .filter(F.col("sum_qty") > 300))


def q10(s, t):
    """Returned-item reporting (Q10Like)."""
    orders = t["orders"].filter(
        (F.col("o_orderdate") >= datetime.date(1993, 10, 1))
        & (F.col("o_orderdate") < datetime.date(1994, 1, 1)))
    li = t["lineitem"].filter(F.col("l_returnflag") == "R")
    return (t["customer"]
            .join(orders, left_on=["c_custkey"], right_on=["o_custkey"])
            .join(li, left_on=["o_orderkey"], right_on=["l_orderkey"])
            .join(t["nation"], left_on=["c_nationkey"],
                  right_on=["n_nationkey"])
            .group_by("c_custkey", "c_name", "c_acctbal", "c_phone",
                      "n_name")
            .agg(F.sum(_revenue()).alias("revenue"))
            .order_by(F.col("revenue").desc(), "c_custkey")
            .limit(20))


def q17(s, t):
    """Small-quantity-order revenue (Q17Like)."""
    part = t["part"].filter((F.col("p_brand") == "Brand#23")
                            & (F.col("p_container") == "MED BOX"))
    j = t["lineitem"].join(part, left_on=["l_partkey"],
                           right_on=["p_partkey"])
    threshold = (j.group_by("p_partkey")
                 .agg((F.avg("l_quantity") * 0.2).alias("qty_limit")))
    return (j.join(threshold, on=["p_partkey"])
            .filter(F.col("l_quantity") < F.col("qty_limit"))
            .agg((F.sum("l_extendedprice") / 7.0).alias("avg_yearly")))


def q18(s, t):
    """Large-volume customers (Q18Like)."""
    big = (t["lineitem"].group_by("l_orderkey")
           .agg(F.sum("l_quantity").alias("sum_qty"))
           .filter(F.col("sum_qty") > 300))
    return (t["orders"]
            .join(big, left_on=["o_orderkey"], right_on=["l_orderkey"],
                  how="leftsemi")
            .join(t["customer"], left_on=["o_custkey"],
                  right_on=["c_custkey"])
            .join(t["lineitem"], left_on=["o_orderkey"],
                  right_on=["l_orderkey"])
            .group_by("c_name", "c_custkey", "o_orderkey", "o_orderdate",
                      "o_totalprice")
            .agg(F.sum("l_quantity").alias("sum_qty"))
            .order_by(F.col("o_totalprice").desc(), "o_orderdate")
            .limit(100))


def q21(s, t):
    """Suppliers who kept orders waiting (Q21Like). The EXISTS /
    NOT EXISTS pair is rendered as per-order distinct-supplier counts."""
    li = t["lineitem"]
    late = li.filter(F.col("l_receiptdate") > F.col("l_commitdate"))
    all_cnt = (li.select("l_orderkey", "l_suppkey").distinct()
               .group_by("l_orderkey").agg(F.count("*").alias("nsupp"))
               .select(F.col("l_orderkey").alias("ok_all"), F.col("nsupp")))
    late_cnt = (late.select("l_orderkey", "l_suppkey").distinct()
                .group_by("l_orderkey").agg(F.count("*").alias("nlate"))
                .select(F.col("l_orderkey").alias("ok_late"),
                        F.col("nlate")))
    return (late
            .join(t["supplier"], left_on=["l_suppkey"],
                  right_on=["s_suppkey"])
            .join(t["nation"].filter(F.col("n_name") == "SAUDI ARABIA"),
                  left_on=["s_nationkey"], right_on=["n_nationkey"])
            .join(t["orders"].filter(F.col("o_orderstatus") == "F"),
                  left_on=["l_orderkey"], right_on=["o_orderkey"])
            .join(all_cnt, left_on=["l_orderkey"], right_on=["ok_all"])
            .filter(F.col("nsupp") > 1)
            .join(late_cnt, left_on=["l_orderkey"], right_on=["ok_late"])
            .filter(F.col("nlate") == 1)
            .group_by("s_name")
            .agg(F.count("*").alias("numwait"))
            .order_by(F.col("numwait").desc(), "s_name")
            .limit(100))


def customer_segment(s, t, segment: str = "BUILDING"):
    """Every customer column of one market segment (a filter and collect
    of all six columns, the string columns included)."""
    return t["customer"].filter(F.col("c_mktsegment") == segment)


QUERIES = {"q1": q1, "q3": q3, "q4": q4, "q6": q6, "q10": q10, "q17": q17,
           "q18": q18, "q21": q21, "q18_groupby": q18_groupby}

"""TPC-H queries over the port's DataFrame API (counterpart of the JAX
package's ``models/tpch.py``: Q1, Q6 and the first stage of Q18).

Each query is a function (session, tables) -> DataFrame, ``tables`` a map
of table name -> DataFrame (``session.create_dataframe`` of the frames of
``models/tpch_data.py``). The Q18 group-by runs on the hash-aggregation
branch: it needs ``HASH_AGG_CONFS`` (the port has neither the sorted-payload
branch nor the dense-key branch the JAX package's defaults take).
"""

from __future__ import annotations

import datetime

from spark_rapids_tpu_torch.models.q1_step import Q18_HASH_SLOTS
from spark_rapids_tpu_torch.sql import functions as F

# the confs the Q18 group-by needs: the hash branch on, with the query
# runners' slot budget (the merge of two 2^22-row partials takes 2^24)
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


QUERIES = {"q1": q1, "q6": q6, "q18_groupby": q18_groupby}

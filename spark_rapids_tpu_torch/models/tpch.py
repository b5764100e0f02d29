"""TPC-H queries over the port's DataFrame API (counterpart of the JAX
package's ``models/tpch.py``: all 22 queries and the first stage of Q18,
copied).

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


def q2(s, t):
    """Minimum-cost supplier (TpchLikeSpark.scala Q2Like)."""
    europe = (t["region"].filter(F.col("r_name") == "EUROPE")
              .join(t["nation"], left_on=["r_regionkey"],
                    right_on=["n_regionkey"])
              .join(t["supplier"], left_on=["n_nationkey"],
                    right_on=["s_nationkey"])
              .join(t["partsupp"], left_on=["s_suppkey"],
                    right_on=["ps_suppkey"]))
    brass = t["part"].filter((F.col("p_size") == 15)
                             & F.col("p_type").like("%BRASS"))
    merged = europe.join(brass, left_on=["ps_partkey"],
                         right_on=["p_partkey"])
    min_cost = (merged.group_by("p_partkey")
                .agg(F.min("ps_supplycost").alias("min_cost")))
    return (merged.join(min_cost, left_on=["p_partkey", "ps_supplycost"],
                        right_on=["p_partkey", "min_cost"])
            .select("s_acctbal", "s_name", "n_name", "p_partkey", "p_mfgr")
            .order_by(F.col("s_acctbal").desc(), "n_name", "s_name",
                      "p_partkey")
            .limit(100))


def q5(s, t):
    """Local-supplier volume in ASIA (Q5Like)."""
    orders = t["orders"].filter(
        (F.col("o_orderdate") >= datetime.date(1994, 1, 1))
        & (F.col("o_orderdate") < datetime.date(1995, 1, 1)))
    return (t["region"].filter(F.col("r_name") == "ASIA")
            .join(t["nation"], left_on=["r_regionkey"],
                  right_on=["n_regionkey"])
            .join(t["customer"], left_on=["n_nationkey"],
                  right_on=["c_nationkey"])
            .join(orders, left_on=["c_custkey"], right_on=["o_custkey"])
            .join(t["lineitem"], left_on=["o_orderkey"],
                  right_on=["l_orderkey"])
            .join(t["supplier"], left_on=["l_suppkey", "n_nationkey"],
                  right_on=["s_suppkey", "s_nationkey"])
            .group_by("n_name")
            .agg(F.sum(_revenue()).alias("revenue"))
            .order_by(F.col("revenue").desc()))


def q7(s, t):
    """Volume shipping FRANCE<->GERMANY (Q7Like)."""
    n1 = t["nation"].select(F.col("n_nationkey").alias("sn_key"),
                            F.col("n_name").alias("supp_nation"))
    n2 = t["nation"].select(F.col("n_nationkey").alias("cn_key"),
                            F.col("n_name").alias("cust_nation"))
    li = t["lineitem"].filter(
        (F.col("l_shipdate") >= datetime.date(1995, 1, 1))
        & (F.col("l_shipdate") <= datetime.date(1996, 12, 31)))
    j = (li.join(t["supplier"], left_on=["l_suppkey"], right_on=["s_suppkey"])
         .join(n1, left_on=["s_nationkey"], right_on=["sn_key"])
         .join(t["orders"], left_on=["l_orderkey"], right_on=["o_orderkey"])
         .join(t["customer"], left_on=["o_custkey"], right_on=["c_custkey"])
         .join(n2, left_on=["c_nationkey"], right_on=["cn_key"])
         .filter(((F.col("supp_nation") == "FRANCE")
                  & (F.col("cust_nation") == "GERMANY"))
                 | ((F.col("supp_nation") == "GERMANY")
                    & (F.col("cust_nation") == "FRANCE"))))
    return (j.with_column("l_year", F.year(F.col("l_shipdate")))
            .group_by("supp_nation", "cust_nation", "l_year")
            .agg(F.sum(_revenue()).alias("revenue"))
            .order_by("supp_nation", "cust_nation", "l_year"))


def q8(s, t):
    """National market share in AMERICA (Q8Like)."""
    n2 = t["nation"].select(F.col("n_nationkey").alias("sn_key"),
                            F.col("n_name").alias("supp_nation"))
    orders = t["orders"].filter(
        (F.col("o_orderdate") >= datetime.date(1995, 1, 1))
        & (F.col("o_orderdate") <= datetime.date(1996, 12, 31)))
    j = (t["part"].filter(F.col("p_type") == "ECONOMY ANODIZED STEEL")
         .join(t["lineitem"], left_on=["p_partkey"], right_on=["l_partkey"])
         .join(t["supplier"], left_on=["l_suppkey"], right_on=["s_suppkey"])
         .join(orders, left_on=["l_orderkey"], right_on=["o_orderkey"])
         .join(t["customer"], left_on=["o_custkey"], right_on=["c_custkey"])
         .join(t["nation"], left_on=["c_nationkey"],
               right_on=["n_nationkey"])
         .join(t["region"].filter(F.col("r_name") == "AMERICA"),
               left_on=["n_regionkey"], right_on=["r_regionkey"])
         .join(n2, left_on=["s_nationkey"], right_on=["sn_key"]))
    vol = _revenue()
    brazil = F.when(F.col("supp_nation") == "BRAZIL", vol).otherwise(0.0)
    return (j.with_column("o_year", F.year(F.col("o_orderdate")))
            .group_by("o_year")
            .agg((F.sum(brazil)).alias("brazil_vol"),
                 F.sum(vol).alias("total_vol"))
            .select(F.col("o_year"),
                    (F.col("brazil_vol") / F.col("total_vol"))
                    .alias("mkt_share"))
            .order_by("o_year"))


def q9(s, t):
    """Product-type profit (Q9Like)."""
    j = (t["part"].filter(F.col("p_name").contains("green"))
         .join(t["lineitem"], left_on=["p_partkey"], right_on=["l_partkey"])
         .join(t["supplier"], left_on=["l_suppkey"], right_on=["s_suppkey"])
         .join(t["partsupp"], left_on=["l_suppkey", "p_partkey"],
               right_on=["ps_suppkey", "ps_partkey"])
         .join(t["orders"], left_on=["l_orderkey"], right_on=["o_orderkey"])
         .join(t["nation"], left_on=["s_nationkey"],
               right_on=["n_nationkey"]))
    amount = (_revenue()
              - F.col("ps_supplycost") * F.col("l_quantity"))
    return (j.with_column("o_year", F.year(F.col("o_orderdate")))
            .group_by("n_name", "o_year")
            .agg(F.sum(amount).alias("sum_profit"))
            .order_by("n_name", F.col("o_year").desc()))


def q11(s, t):
    """Important stock identification in GERMANY (Q11Like)."""
    base = (t["partsupp"]
            .join(t["supplier"], left_on=["ps_suppkey"],
                  right_on=["s_suppkey"])
            .join(t["nation"].filter(F.col("n_name") == "GERMANY"),
                  left_on=["s_nationkey"], right_on=["n_nationkey"]))
    value = F.col("ps_supplycost") * F.col("ps_availqty")
    per_part = (base.group_by("ps_partkey")
                .agg(F.sum(value).alias("value")))
    total = base.agg((F.sum(value) * 0.0001).alias("threshold"))
    return (per_part.join(total, on=None)
            .filter(F.col("value") > F.col("threshold"))
            .select("ps_partkey", "value")
            .order_by(F.col("value").desc(), "ps_partkey"))


def q12(s, t):
    """Shipping modes and order priority (Q12Like)."""
    li = t["lineitem"].filter(
        F.col("l_shipmode").isin("MAIL", "SHIP")
        & (F.col("l_commitdate") < F.col("l_receiptdate"))
        & (F.col("l_shipdate") < F.col("l_commitdate"))
        & (F.col("l_receiptdate") >= datetime.date(1994, 1, 1))
        & (F.col("l_receiptdate") < datetime.date(1995, 1, 1)))
    high = F.when(F.col("o_orderpriority").isin("1-URGENT", "2-HIGH"),
                  1).otherwise(0)
    low = F.when(F.col("o_orderpriority").isin("1-URGENT", "2-HIGH"),
                 0).otherwise(1)
    return (t["orders"]
            .join(li, left_on=["o_orderkey"], right_on=["l_orderkey"])
            .group_by("l_shipmode")
            .agg(F.sum(high).alias("high_line_count"),
                 F.sum(low).alias("low_line_count"))
            .order_by("l_shipmode"))


def q13(s, t):
    """Customer order-count distribution (Q13Like). The official NOT LIKE
    '%special%requests%' is rendered as two contains (the TPU LIKE gate
    supports single-needle patterns, stringexprs.Like)."""
    orders = t["orders"].filter(
        ~(F.col("o_comment").contains("special")
          & F.col("o_comment").contains("requests")))
    counts = (t["customer"]
              .join(orders, left_on=["c_custkey"], right_on=["o_custkey"],
                    how="left")
              .group_by("c_custkey")
              .agg(F.count("o_orderkey").alias("c_count")))
    return (counts.group_by("c_count")
            .agg(F.count("*").alias("custdist"))
            .order_by(F.col("custdist").desc(), F.col("c_count").desc()))


def q14(s, t):
    """Promotion effect (Q14Like)."""
    li = t["lineitem"].filter(
        (F.col("l_shipdate") >= datetime.date(1995, 9, 1))
        & (F.col("l_shipdate") < datetime.date(1995, 10, 1)))
    promo = F.when(F.col("p_type").like("PROMO%"),
                   _revenue()).otherwise(0.0)
    return (li.join(t["part"], left_on=["l_partkey"], right_on=["p_partkey"])
            .agg(F.sum(promo).alias("promo_rev"),
                 F.sum(_revenue()).alias("total_rev"))
            .select((F.lit(100.0) * F.col("promo_rev")
                     / F.col("total_rev")).alias("promo_revenue")))


def q15(s, t):
    """Top supplier (Q15Like: the revenue view + its max)."""
    li = t["lineitem"].filter(
        (F.col("l_shipdate") >= datetime.date(1996, 1, 1))
        & (F.col("l_shipdate") < datetime.date(1996, 4, 1)))
    rev = (li.group_by("l_suppkey")
           .agg(F.sum(_revenue()).alias("total_revenue")))
    top = rev.agg(F.max("total_revenue").alias("max_revenue"))
    return (rev.join(top, on=None)
            .filter(F.col("total_revenue") == F.col("max_revenue"))
            .join(t["supplier"], left_on=["l_suppkey"],
                  right_on=["s_suppkey"])
            .select("s_suppkey", "s_name", "total_revenue")
            .order_by("s_suppkey"))


def q16(s, t):
    """Parts/supplier relationship (Q16Like); count(distinct) rendered as
    distinct + count."""
    bad_supp = t["supplier"].filter(
        F.col("s_comment").contains("Customer")
        & F.col("s_comment").contains("Complaints"))
    part = t["part"].filter(
        (F.col("p_brand") != "Brand#45")
        & ~F.col("p_type").startswith("MEDIUM POLISHED")
        & F.col("p_size").isin(49, 14, 23, 45, 19, 3, 36, 9))
    return (t["partsupp"]
            .join(bad_supp, left_on=["ps_suppkey"], right_on=["s_suppkey"],
                  how="leftanti")
            .join(part, left_on=["ps_partkey"], right_on=["p_partkey"])
            .select("p_brand", "p_type", "p_size", "ps_suppkey")
            .distinct()
            .group_by("p_brand", "p_type", "p_size")
            .agg(F.count("*").alias("supplier_cnt"))
            .order_by(F.col("supplier_cnt").desc(), "p_brand", "p_type",
                      "p_size"))


def q19(s, t):
    """Discounted revenue, disjunctive predicate (Q19Like)."""
    j = (t["lineitem"]
         .filter(F.col("l_shipmode").isin("AIR", "REG AIR")
                 & (F.col("l_shipinstruct") == "DELIVER IN PERSON"))
         .join(t["part"], left_on=["l_partkey"], right_on=["p_partkey"]))
    cond = (
        ((F.col("p_brand") == "Brand#12")
         & F.col("p_container").isin("SM CASE", "SM BOX")
         & (F.col("l_quantity") >= 1) & (F.col("l_quantity") <= 11)
         & (F.col("p_size") >= 1) & (F.col("p_size") <= 5))
        | ((F.col("p_brand") == "Brand#23")
           & F.col("p_container").isin("MED BAG", "MED BOX")
           & (F.col("l_quantity") >= 10) & (F.col("l_quantity") <= 20)
           & (F.col("p_size") >= 1) & (F.col("p_size") <= 10))
        | ((F.col("p_brand") == "Brand#34")
           & F.col("p_container").isin("LG CASE", "LG BOX")
           & (F.col("l_quantity") >= 20) & (F.col("l_quantity") <= 30)
           & (F.col("p_size") >= 1) & (F.col("p_size") <= 15)))
    return j.filter(cond).agg(F.sum(_revenue()).alias("revenue"))


def q20(s, t):
    """Potential part promotion (Q20Like)."""
    forest_parts = t["part"].filter(F.col("p_name").startswith("forest"))
    shipped = (t["lineitem"].filter(
        (F.col("l_shipdate") >= datetime.date(1994, 1, 1))
        & (F.col("l_shipdate") < datetime.date(1995, 1, 1)))
        .group_by("l_partkey", "l_suppkey")
        .agg((F.sum("l_quantity") * 0.5).alias("half_qty")))
    qualified = (t["partsupp"]
                 .join(forest_parts, left_on=["ps_partkey"],
                       right_on=["p_partkey"], how="leftsemi")
                 .join(shipped, left_on=["ps_partkey", "ps_suppkey"],
                       right_on=["l_partkey", "l_suppkey"])
                 .filter(F.col("ps_availqty") > F.col("half_qty")))
    return (t["supplier"]
            .join(qualified, left_on=["s_suppkey"], right_on=["ps_suppkey"],
                  how="leftsemi")
            .join(t["nation"].filter(F.col("n_name") == "CANADA"),
                  left_on=["s_nationkey"], right_on=["n_nationkey"])
            .select("s_name", "s_address")
            .order_by("s_name"))


def q22(s, t):
    """Global sales opportunity (Q22Like)."""
    codes = ["13", "31", "23", "29", "30", "18", "17"]
    cust = (t["customer"]
            .with_column("cntrycode", F.substring(F.col("c_phone"), 1, 2))
            .filter(F.col("cntrycode").isin(codes)))
    avg_bal = (cust.filter(F.col("c_acctbal") > 0.0)
               .agg(F.avg("c_acctbal").alias("avg_bal")))
    return (cust.join(avg_bal, on=None)
            .filter(F.col("c_acctbal") > F.col("avg_bal"))
            .join(t["orders"], left_on=["c_custkey"], right_on=["o_custkey"],
                  how="leftanti")
            .group_by("cntrycode")
            .agg(F.count("*").alias("numcust"),
                 F.sum("c_acctbal").alias("totacctbal"))
            .order_by("cntrycode"))


def customer_segment(s, t, segment: str = "BUILDING"):
    """Every customer column of one market segment (a filter and collect
    of all six columns, the string columns included)."""
    return t["customer"].filter(F.col("c_mktsegment") == segment)


class TpchTables:
    """Load or generate the TPC-H tables as DataFrames."""

    @staticmethod
    def generate(session, sf: float, num_partitions: int = 4):
        from spark_rapids_tpu_torch.models import tpch_data as gen
        return {
            "lineitem": session.create_dataframe(gen.gen_lineitem(sf),
                                                 num_partitions),
            "orders": session.create_dataframe(gen.gen_orders(sf),
                                               num_partitions),
            "customer": session.create_dataframe(gen.gen_customer(sf),
                                                 num_partitions),
            "supplier": session.create_dataframe(gen.gen_supplier(sf),
                                                 num_partitions),
            "part": session.create_dataframe(gen.gen_part(sf),
                                             num_partitions),
            "partsupp": session.create_dataframe(gen.gen_partsupp(sf),
                                                 num_partitions),
            "nation": session.create_dataframe(gen.gen_nation(), 1),
            "region": session.create_dataframe(gen.gen_region(), 1),
        }

    @staticmethod
    def from_parquet(session, path: str):
        import os
        out = {}
        for name in ("lineitem", "orders", "customer", "supplier", "part",
                     "nation", "region"):
            f = os.path.join(path, f"{name}.parquet")
            if os.path.exists(f):
                out[name] = session.read.parquet(f)
        return out


QUERIES = {
    "q1": q1, "q2": q2, "q3": q3, "q4": q4, "q5": q5, "q6": q6, "q7": q7,
    "q8": q8, "q9": q9, "q10": q10, "q11": q11, "q12": q12, "q13": q13,
    "q14": q14, "q15": q15, "q16": q16, "q17": q17, "q18": q18, "q19": q19,
    "q20": q20, "q21": q21, "q22": q22, "q18_groupby": q18_groupby}

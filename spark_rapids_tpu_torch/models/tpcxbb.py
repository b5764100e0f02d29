"""TPCxBB-like (BigBench) queries over the port's DataFrame API (a copy of
the JAX package's ``models/tpcxbb.py``, so both packages run the same 19
queries; ``testing/tpcxbbcases.py`` holds a pandas reference for each).

The reference ships the same suite as SQL text (integration_tests/.../
tpcxbb/TpcxbbLikeSpark.scala:785-2069): 19 of the 30 queries are
implemented; the others raise "uses UDTF/UDF/calls python" — this module
mirrors that split exactly (``UNSUPPORTED`` carries the same reasons,
Q1/Q2/Q29/Q30 UDTF, Q3/Q4/Q8 python, Q10/Q18/Q19/Q27 UDF).

TPU-first reformulations (documented per query):
- Date-window predicates written against ``*_date_sk`` surrogate keys
  (days since 1900-01-01, the convention the suite's literals assume —
  e.g. Q25's ``37621 == 2003-01-02``) instead of string-typed ``d_date``
  comparisons / ``unix_timestamp`` round trips: pure int64 arithmetic that
  stays on the accelerator, with identical semantics over the generated
  date_dim.
- ``IN (subquery)`` / correlated existence filters become left-semi hash
  joins (what Spark itself plans them to).
- CREATE TEMPORARY VIEW staging (Q6/Q7/Q13/Q23/Q24/Q25) becomes plain
  DataFrame composition; Q28's INSERT-OVERWRITE train/test split returns
  one labelled union instead of writing two tables.

Each query is a function (session, tables) -> DataFrame; ``tables`` maps
name -> DataFrame (TpcxbbTables.generate or any source).
"""

from __future__ import annotations

import datetime
from typing import Callable, Dict

from spark_rapids_tpu_torch.models.tpcxbb_data import date_sk as _sk
from spark_rapids_tpu_torch.sql import functions as F

_date = datetime.date


def q5(s, t):
    """Per-visitor click-category feature vectors for logistic regression
    (TpcxbbLikeSpark.scala Q5Like:809)."""
    clicks = t["web_clickstreams"].filter(F.col("wcs_user_sk").isNotNull())
    j = clicks.join(
        t["item"].select("i_item_sk", "i_category", "i_category_id"),
        left_on=["wcs_item_sk"], right_on=["i_item_sk"])

    def clicks_in(cond, name):
        return F.sum(F.when(cond, 1).otherwise(0)).alias(name)

    per_user = (j.group_by("wcs_user_sk")
                .agg(clicks_in(F.col("i_category") == "Books",
                               "clicks_in_category"),
                     *[clicks_in(F.col("i_category_id") == i, f"clicks_in_{i}")
                       for i in range(1, 8)]))
    out = (per_user
           .join(t["customer"].select("c_customer_sk", "c_current_cdemo_sk"),
                 left_on=["wcs_user_sk"], right_on=["c_customer_sk"])
           .join(t["customer_demographics"].select(
               "cd_demo_sk", "cd_gender", "cd_education_status"),
               left_on=["c_current_cdemo_sk"], right_on=["cd_demo_sk"]))
    college = F.when(
        F.col("cd_education_status").isin(
            "Advanced Degree", "College", "4 yr Degree", "2 yr Degree"),
        1).otherwise(0)
    return out.select(
        F.col("clicks_in_category"),
        college.alias("college_education"),
        F.when(F.col("cd_gender") == "M", 1).otherwise(0).alias("male"),
        *[F.col(f"clicks_in_{i}") for i in range(1, 8)])


def _year_over_year(sales, date_col, cust_col, date_dim, amount, year=2001):
    """First/second-year totals per customer with HAVING first > 0 — the
    shared core of Q6/Q13 (their q*_temp_table1/2 views)."""
    dd = (date_dim.select("d_date_sk", "d_year")
          .filter(F.col("d_year").isin(year, year + 1)))
    j = sales.join(dd, left_on=[date_col], right_on=["d_date_sk"])
    return (j.group_by(cust_col)
            .agg(F.sum(F.when(F.col("d_year") == year, amount)
                       .otherwise(0.0)).alias("first_year_total"),
                 F.sum(F.when(F.col("d_year") == year + 1, amount)
                       .otherwise(0.0)).alias("second_year_total"))
            .filter(F.col("first_year_total") > 0))


def q6(s, t):
    """Customers shifting store->web purchase habit (Q6Like:868)."""
    ss_amt = ((F.col("ss_ext_list_price") - F.col("ss_ext_wholesale_cost")
               - F.col("ss_ext_discount_amt") + F.col("ss_ext_sales_price"))
              / 2)
    ws_amt = ((F.col("ws_ext_list_price") - F.col("ws_ext_wholesale_cost")
               - F.col("ws_ext_discount_amt") + F.col("ws_ext_sales_price"))
              / 2)
    store = _year_over_year(
        t["store_sales"].select("ss_customer_sk", "ss_sold_date_sk",
                                "ss_ext_list_price", "ss_ext_wholesale_cost",
                                "ss_ext_discount_amt", "ss_ext_sales_price"),
        "ss_sold_date_sk", "ss_customer_sk", t["date_dim"], ss_amt)
    web = _year_over_year(
        t["web_sales"].select("ws_bill_customer_sk", "ws_sold_date_sk",
                              "ws_ext_list_price", "ws_ext_wholesale_cost",
                              "ws_ext_discount_amt", "ws_ext_sales_price"),
        "ws_sold_date_sk", "ws_bill_customer_sk", t["date_dim"], ws_amt)
    store = store.select(F.col("ss_customer_sk").alias("s_cust"),
                         F.col("first_year_total").alias("s_first"),
                         F.col("second_year_total").alias("s_second"))
    web = web.select(F.col("ws_bill_customer_sk").alias("w_cust"),
                     F.col("first_year_total").alias("w_first"),
                     F.col("second_year_total").alias("w_second"))
    web_ratio = F.col("w_second") / F.col("w_first")
    store_ratio = F.col("s_second") / F.col("s_first")
    return (store.join(web, left_on=["s_cust"], right_on=["w_cust"])
            .join(t["customer"].select(
                "c_customer_sk", "c_first_name", "c_last_name",
                "c_preferred_cust_flag", "c_birth_country", "c_login",
                "c_email_address"),
                left_on=["w_cust"], right_on=["c_customer_sk"])
            .filter(web_ratio > store_ratio)
            .select(web_ratio.alias("web_sales_increase_ratio"),
                    "c_customer_sk", "c_first_name", "c_last_name",
                    "c_preferred_cust_flag", "c_birth_country", "c_login",
                    "c_email_address")
            .order_by(F.col("web_sales_increase_ratio").desc(),
                      "c_customer_sk", "c_first_name", "c_last_name",
                      "c_preferred_cust_flag", "c_birth_country", "c_login")
            .limit(100))


def q7(s, t):
    """Top states with >=10 customers buying items priced 20% above the
    category average in July 2004 (Q7Like:949)."""
    item = t["item"].select("i_item_sk", "i_category", "i_current_price")
    avg_price = (item.group_by("i_category")
                 .agg((F.avg("i_current_price") * 1.2).alias("avg_price")))
    high = (item.join(avg_price.select(F.col("i_category").alias("ac_cat"),
                                       "avg_price"),
                      left_on=["i_category"], right_on=["ac_cat"])
            .filter(F.col("i_current_price") > F.col("avg_price"))
            .select("i_item_sk"))
    dates = (t["date_dim"]
             .filter((F.col("d_year") == 2004) & (F.col("d_moy") == 7))
             .select("d_date_sk"))
    ss = (t["store_sales"].select("ss_item_sk", "ss_customer_sk",
                                  "ss_sold_date_sk")
          .join(dates, left_on=["ss_sold_date_sk"], right_on=["d_date_sk"],
                how="leftsemi")
          .join(high, left_on=["ss_item_sk"], right_on=["i_item_sk"],
                how="leftsemi"))
    j = (t["customer_address"].select("ca_address_sk", "ca_state")
         .filter(F.col("ca_state").isNotNull())
         .join(t["customer"].select("c_customer_sk", "c_current_addr_sk"),
               left_on=["ca_address_sk"], right_on=["c_current_addr_sk"])
         .join(ss, left_on=["c_customer_sk"], right_on=["ss_customer_sk"]))
    return (j.group_by("ca_state").agg(F.count("*").alias("cnt"))
            .filter(F.col("cnt") >= 10)
            .order_by(F.col("cnt").desc(), "ca_state")
            .limit(10))


def q9(s, t):
    """Total quantity over demographic x geography filter bands
    (Q9Like:1021)."""
    dd = (t["date_dim"].filter(F.col("d_year") == 2001)
          .select("d_date_sk"))
    j = (t["store_sales"].select(
            "ss_sold_date_sk", "ss_addr_sk", "ss_store_sk", "ss_cdemo_sk",
            "ss_quantity", "ss_sales_price", "ss_net_profit")
         .join(dd, left_on=["ss_sold_date_sk"], right_on=["d_date_sk"],
               how="leftsemi")
         .join(t["store"].select("s_store_sk"),
               left_on=["ss_store_sk"], right_on=["s_store_sk"],
               how="leftsemi")
         .join(t["customer_address"].select("ca_address_sk", "ca_state",
                                            "ca_country"),
               left_on=["ss_addr_sk"], right_on=["ca_address_sk"])
         .join(t["customer_demographics"].select(
               "cd_demo_sk", "cd_marital_status", "cd_education_status"),
               left_on=["ss_cdemo_sk"], right_on=["cd_demo_sk"]))
    sp = F.col("ss_sales_price")
    prof = F.col("ss_net_profit")
    demo = ((F.col("cd_marital_status") == "M")
            & (F.col("cd_education_status") == "4 yr Degree")
            & (((sp >= 100) & (sp <= 150)) | ((sp >= 50) & (sp <= 200))
               | ((sp >= 150) & (sp <= 200))))
    geo = ((F.col("ca_country") == "United States")
           & ((F.col("ca_state").isin("KY", "GA", "NM")
               & (prof >= 0) & (prof <= 2000))
              | (F.col("ca_state").isin("MT", "OR", "IN")
                 & (prof >= 150) & (prof <= 3000))
              | (F.col("ca_state").isin("WI", "MO", "WV")
                 & (prof >= 50) & (prof <= 25000))))
    return j.filter(demo & geo).agg(F.sum("ss_quantity").alias("sum_qty"))


def q11(s, t):
    """corr(review count, avg rating) vs monthly revenue (Q11Like:1103).
    Date range '2003-01-02'..'2003-02-02' expressed on d_date_sk."""
    pr = (t["product_reviews"].filter(F.col("pr_item_sk").isNotNull())
          .group_by("pr_item_sk")
          .agg(F.count("*").alias("r_count"),
               F.avg("pr_review_rating").alias("avg_rating")))
    lo, hi = _sk(_date(2003, 1, 2)), _sk(_date(2003, 2, 2))
    dd = (t["date_dim"].select("d_date_sk")
          .filter((F.col("d_date_sk") >= lo) & (F.col("d_date_sk") <= hi)))
    ws = (t["web_sales"].select("ws_item_sk", "ws_sold_date_sk",
                                "ws_net_paid")
          .filter(F.col("ws_item_sk").isNotNull())
          .join(dd, left_on=["ws_sold_date_sk"], right_on=["d_date_sk"],
                how="leftsemi")
          .group_by("ws_item_sk").agg(F.sum("ws_net_paid").alias("revenue")))
    return (pr.join(ws, left_on=["pr_item_sk"], right_on=["ws_item_sk"])
            .agg(F.corr("r_count", "avg_rating").alias("correlation")))


def q12(s, t):
    """Customers who viewed a category online then bought in-store within
    90 days (Q12Like:1161)."""
    item = (t["item"].filter(F.col("i_category").isin("Books", "Electronics"))
            .select("i_item_sk"))
    web = (t["web_clickstreams"]
           .filter((F.col("wcs_click_date_sk") >= 37134)
                   & (F.col("wcs_click_date_sk") <= 37134 + 30)
                   & F.col("wcs_user_sk").isNotNull()
                   & F.col("wcs_sales_sk").isNull())
           .join(item, left_on=["wcs_item_sk"], right_on=["i_item_sk"],
                 how="leftsemi")
           .select("wcs_user_sk", "wcs_click_date_sk"))
    store = (t["store_sales"]
             .filter((F.col("ss_sold_date_sk") >= 37134)
                     & (F.col("ss_sold_date_sk") <= 37134 + 90)
                     & F.col("ss_customer_sk").isNotNull())
             .join(item, left_on=["ss_item_sk"], right_on=["i_item_sk"],
                   how="leftsemi")
             .select("ss_customer_sk", "ss_sold_date_sk"))
    return (web.join(store, left_on=["wcs_user_sk"],
                     right_on=["ss_customer_sk"])
            .filter(F.col("wcs_click_date_sk") < F.col("ss_sold_date_sk"))
            .select("wcs_user_sk").distinct().order_by("wcs_user_sk"))


def q13(s, t):
    """Customers whose web-sales growth outpaces store-sales growth
    (Q13Like:1203) — net-paid variant of Q6."""
    store = _year_over_year(
        t["store_sales"].select("ss_customer_sk", "ss_sold_date_sk",
                                "ss_net_paid"),
        "ss_sold_date_sk", "ss_customer_sk", t["date_dim"],
        F.col("ss_net_paid"))
    web = _year_over_year(
        t["web_sales"].select("ws_bill_customer_sk", "ws_sold_date_sk",
                              "ws_net_paid"),
        "ws_sold_date_sk", "ws_bill_customer_sk", t["date_dim"],
        F.col("ws_net_paid"))
    store = store.select(F.col("ss_customer_sk").alias("s_cust"),
                         F.col("first_year_total").alias("s_first"),
                         F.col("second_year_total").alias("s_second"))
    web = web.select(F.col("ws_bill_customer_sk").alias("w_cust"),
                     F.col("first_year_total").alias("w_first"),
                     F.col("second_year_total").alias("w_second"))
    web_ratio = (F.col("w_second") / F.col("w_first"))
    store_ratio = (F.col("s_second") / F.col("s_first"))
    return (store.join(web, left_on=["s_cust"], right_on=["w_cust"])
            .join(t["customer"].select("c_customer_sk", "c_first_name",
                                       "c_last_name"),
                  left_on=["w_cust"], right_on=["c_customer_sk"])
            .filter(web_ratio > store_ratio)
            .select("c_customer_sk", "c_first_name", "c_last_name",
                    store_ratio.alias("storeSalesIncreaseRatio"),
                    web_ratio.alias("webSalesIncreaseRatio"))
            .order_by(F.col("webSalesIncreaseRatio").desc(),
                      "c_customer_sk", "c_first_name", "c_last_name")
            .limit(100))


def q14(s, t):
    """Morning/evening web-sales ratio for high-content pages
    (Q14Like:1284)."""
    hd = (t["household_demographics"].filter(F.col("hd_dep_count") == 5)
          .select("hd_demo_sk"))
    wp = (t["web_page"].filter((F.col("wp_char_count") >= 5000)
                               & (F.col("wp_char_count") <= 6000))
          .select("wp_web_page_sk"))
    td = (t["time_dim"].filter(F.col("t_hour").isin(7, 8, 19, 20))
          .select("t_time_sk", "t_hour"))
    j = (t["web_sales"].select("ws_ship_hdemo_sk", "ws_web_page_sk",
                               "ws_sold_time_sk")
         .join(hd, left_on=["ws_ship_hdemo_sk"], right_on=["hd_demo_sk"],
               how="leftsemi")
         .join(wp, left_on=["ws_web_page_sk"], right_on=["wp_web_page_sk"],
               how="leftsemi")
         .join(td, left_on=["ws_sold_time_sk"], right_on=["t_time_sk"]))
    per_hour = j.group_by("t_hour").agg(F.count("*").alias("cnt"))
    tot = per_hour.agg(
        F.sum(F.when((F.col("t_hour") >= 7) & (F.col("t_hour") <= 8),
                     F.col("cnt")).otherwise(0)).alias("amc"),
        F.sum(F.when((F.col("t_hour") >= 19) & (F.col("t_hour") <= 20),
                     F.col("cnt")).otherwise(0)).alias("pmc"))
    return tot.select(
        F.when(F.col("pmc") > 0, F.col("amc") / F.col("pmc"))
        .otherwise(-1.0).alias("am_pm_ratio"))


def q15(s, t):
    """Categories with flat/declining store sales: per-category least-squares
    slope over daily revenue (Q15Like:1313), assembled from plain sums."""
    lo, hi = _sk(_date(2001, 9, 2)), _sk(_date(2002, 9, 2))
    ss = (t["store_sales"].select("ss_item_sk", "ss_sold_date_sk",
                                  "ss_store_sk", "ss_net_paid")
          .filter((F.col("ss_store_sk") == 10)
                  & (F.col("ss_sold_date_sk") >= lo)
                  & (F.col("ss_sold_date_sk") <= hi)))
    item = (t["item"].filter(F.col("i_category_id").isNotNull())
            .select("i_item_sk", "i_category_id"))
    daily = (ss.join(item, left_on=["ss_item_sk"], right_on=["i_item_sk"])
             .group_by("i_category_id", "ss_sold_date_sk")
             .agg(F.sum("ss_net_paid").alias("y")))
    x = F.col("ss_sold_date_sk")
    daily = daily.select(F.col("i_category_id").alias("cat"),
                         x.alias("x"), F.col("y"),
                         (x * F.col("y")).alias("xy"),
                         (x * x).alias("xx"))
    n = F.count("*")
    sx, sy = F.sum("x"), F.sum("y")
    sxy, sxx = F.sum("xy"), F.sum("xx")
    slope = (n * sxy - sx * sy) / (n * sxx - sx * sx)
    intercept = (sy - slope * sx) / n
    return (daily.group_by("cat")
            .agg(slope.alias("slope"), intercept.alias("intercept"))
            .filter(F.col("slope") <= 0)
            .order_by("cat"))


def q16(s, t):
    """Sales before/after an item price change, net of refunds, by
    warehouse state (Q16Like:1377). The +-30-day unix_timestamp window is
    expressed on d_date_sk."""
    pivot = _sk(_date(2001, 3, 16))
    dd = (t["date_dim"].select("d_date_sk")
          .filter((F.col("d_date_sk") >= pivot - 30)
                  & (F.col("d_date_sk") <= pivot + 30)))
    wr = t["web_returns"].select(F.col("wr_order_number").alias("r_order"),
                                 F.col("wr_item_sk").alias("r_item"),
                                 "wr_refunded_cash")
    j = (t["web_sales"].select("ws_item_sk", "ws_order_number",
                               "ws_warehouse_sk", "ws_sold_date_sk",
                               "ws_sales_price")
         .join(wr, left_on=["ws_order_number", "ws_item_sk"],
               right_on=["r_order", "r_item"], how="left")
         .join(t["item"].select("i_item_sk", "i_item_id"),
               left_on=["ws_item_sk"], right_on=["i_item_sk"])
         .join(t["warehouse"].select("w_warehouse_sk", "w_state"),
               left_on=["ws_warehouse_sk"], right_on=["w_warehouse_sk"])
         .join(dd, left_on=["ws_sold_date_sk"], right_on=["d_date_sk"],
               how="leftsemi"))
    net = F.col("ws_sales_price") - F.coalesce(F.col("wr_refunded_cash"),
                                               F.lit(0.0))
    return (j.group_by("w_state", "i_item_id")
            .agg(F.sum(F.when(F.col("ws_sold_date_sk") < pivot, net)
                       .otherwise(0.0)).alias("sales_before"),
                 F.sum(F.when(F.col("ws_sold_date_sk") >= pivot, net)
                       .otherwise(0.0)).alias("sales_after"))
            .order_by("w_state", "i_item_id")
            .limit(100))


def q17(s, t):
    """Promoted vs total sales ratio for categories/timezone
    (Q17Like:1419)."""
    dd = (t["date_dim"]
          .filter((F.col("d_year") == 2001) & (F.col("d_moy") == 12))
          .select("d_date_sk"))
    item = (t["item"].filter(F.col("i_category").isin("Books", "Music"))
            .select("i_item_sk"))
    st = (t["store"].filter(F.col("s_gmt_offset") == -5.0)
          .select("s_store_sk"))
    tz_cust = (t["customer"].select("c_customer_sk", "c_current_addr_sk")
               .join(t["customer_address"]
                     .filter(F.col("ca_gmt_offset") == -5.0)
                     .select("ca_address_sk"),
                     left_on=["c_current_addr_sk"],
                     right_on=["ca_address_sk"], how="leftsemi")
               .select("c_customer_sk"))
    ss = (t["store_sales"].select(
            "ss_sold_date_sk", "ss_item_sk", "ss_store_sk", "ss_customer_sk",
            "ss_promo_sk", "ss_ext_sales_price")
          .join(dd, left_on=["ss_sold_date_sk"], right_on=["d_date_sk"],
                how="leftsemi")
          .join(item, left_on=["ss_item_sk"], right_on=["i_item_sk"],
                how="leftsemi")
          .join(st, left_on=["ss_store_sk"], right_on=["s_store_sk"],
                how="leftsemi")
          .join(tz_cust, left_on=["ss_customer_sk"],
                right_on=["c_customer_sk"], how="leftsemi")
          .join(t["promotion"].select("p_promo_sk", "p_channel_dmail",
                                      "p_channel_email", "p_channel_tv"),
                left_on=["ss_promo_sk"], right_on=["p_promo_sk"]))
    per_channel = (ss.group_by("p_channel_email", "p_channel_dmail",
                               "p_channel_tv")
                   .agg(F.sum("ss_ext_sales_price").alias("total_sales")))
    promo = F.when((F.col("p_channel_dmail") == "Y")
                   | (F.col("p_channel_email") == "Y")
                   | (F.col("p_channel_tv") == "Y"),
                   F.col("total_sales")).otherwise(0.0)
    sums = per_channel.select(promo.alias("promo_sales"),
                              F.col("total_sales"))
    out = sums.agg(F.sum("promo_sales").alias("promotional"),
                   F.sum("total_sales").alias("total"))
    return (out.select(
        "promotional", "total",
        F.when(F.col("total") > 0,
               100 * F.col("promotional") / F.col("total"))
        .otherwise(0.0).alias("promo_percent"))
        .order_by("promotional", "total")
        .limit(100))


def q20(s, t):
    """Customer return-behaviour segmentation vectors (Q20Like:1480) —
    count(DISTINCT ticket) rides the two-level distinct rewrite."""
    orders = (t["store_sales"]
              .group_by("ss_customer_sk")
              .agg(F.count_distinct("ss_ticket_number").alias("orders_count"),
                   F.count("ss_item_sk").alias("orders_items"),
                   F.sum("ss_net_paid").alias("orders_money")))
    returned = (t["store_returns"]
                .group_by("sr_customer_sk")
                .agg(F.count_distinct("sr_ticket_number")
                     .alias("returns_count"),
                     F.count("sr_item_sk").alias("returns_items"),
                     F.sum("sr_return_amt").alias("returns_money")))
    j = orders.join(returned, left_on=["ss_customer_sk"],
                    right_on=["sr_customer_sk"], how="left")

    def ratio(num, den, name):
        r = F.col(num).cast("double") / F.col(den)
        return F.round(F.coalesce(r, F.lit(0.0)), 7).alias(name)

    return (j.select(
        F.col("ss_customer_sk").alias("user_sk"),
        ratio("returns_count", "orders_count", "orderRatio"),
        ratio("returns_items", "orders_items", "itemsRatio"),
        ratio("returns_money", "orders_money", "monetaryRatio"),
        F.round(F.coalesce(F.col("returns_count").cast("double"),
                           F.lit(0.0)), 0).alias("frequency"))
        .order_by("user_sk"))


def q21(s, t):
    """Items sold, returned within 6 months, re-purchased on the web
    (Q21Like:1542)."""
    d1 = (t["date_dim"]
          .filter((F.col("d_year") == 2003) & (F.col("d_moy") == 1))
          .select("d_date_sk"))
    d2 = (t["date_dim"]
          .filter((F.col("d_year") == 2003) & (F.col("d_moy") >= 1)
                  & (F.col("d_moy") <= 7))
          .select("d_date_sk"))
    d3 = (t["date_dim"]
          .filter((F.col("d_year") >= 2003) & (F.col("d_year") <= 2005))
          .select("d_date_sk"))
    sr = (t["store_returns"].select("sr_item_sk", "sr_customer_sk",
                                    "sr_ticket_number", "sr_return_quantity",
                                    "sr_returned_date_sk")
          .join(d2, left_on=["sr_returned_date_sk"], right_on=["d_date_sk"],
                how="leftsemi"))
    ws = (t["web_sales"].select("ws_item_sk", "ws_bill_customer_sk",
                                "ws_quantity", "ws_sold_date_sk")
          .join(d3, left_on=["ws_sold_date_sk"], right_on=["d_date_sk"],
                how="leftsemi"))
    ss = (t["store_sales"].select("ss_item_sk", "ss_store_sk",
                                  "ss_customer_sk", "ss_ticket_number",
                                  "ss_quantity", "ss_sold_date_sk")
          .join(d1, left_on=["ss_sold_date_sk"], right_on=["d_date_sk"],
                how="leftsemi"))
    j = (sr.join(ws, left_on=["sr_item_sk", "sr_customer_sk"],
                 right_on=["ws_item_sk", "ws_bill_customer_sk"])
         .join(ss, left_on=["sr_ticket_number", "sr_item_sk",
                            "sr_customer_sk"],
               right_on=["ss_ticket_number", "ss_item_sk", "ss_customer_sk"])
         .join(t["store"].select("s_store_sk", "s_store_id", "s_store_name"),
               left_on=["ss_store_sk"], right_on=["s_store_sk"])
         .join(t["item"].select("i_item_sk", "i_item_id", "i_item_desc"),
               left_on=["sr_item_sk"], right_on=["i_item_sk"]))
    return (j.group_by("i_item_id", "i_item_desc", "s_store_id",
                       "s_store_name")
            .agg(F.sum("ss_quantity").alias("store_sales_quantity"),
                 F.sum("sr_return_quantity").alias("store_returns_quantity"),
                 F.sum("ws_quantity").alias("web_sales_quantity"))
            .order_by("i_item_id", "i_item_desc", "s_store_id",
                      "s_store_name")
            .limit(100))


def q22(s, t):
    """Inventory change around a price change, by warehouse (Q22Like:1630).
    datediff(d_date, '2001-05-08') becomes d_date_sk - sk(2001-05-08)."""
    pivot = _sk(_date(2001, 5, 8))
    dd = (t["date_dim"].select("d_date_sk")
          .filter((F.col("d_date_sk") >= pivot - 30)
                  & (F.col("d_date_sk") <= pivot + 30)))
    item = (t["item"].filter((F.col("i_current_price") >= 0.98)
                             & (F.col("i_current_price") <= 1.5))
            .select("i_item_sk", "i_item_id"))
    j = (t["inventory"]
         .join(dd, left_on=["inv_date_sk"], right_on=["d_date_sk"],
               how="leftsemi")
         .join(item, left_on=["inv_item_sk"], right_on=["i_item_sk"])
         .join(t["warehouse"].select("w_warehouse_sk", "w_warehouse_name"),
               left_on=["inv_warehouse_sk"], right_on=["w_warehouse_sk"]))
    g = (j.group_by("w_warehouse_name", "i_item_id")
         .agg(F.sum(F.when(F.col("inv_date_sk") < pivot,
                           F.col("inv_quantity_on_hand")).otherwise(0))
              .alias("inv_before"),
              F.sum(F.when(F.col("inv_date_sk") >= pivot,
                           F.col("inv_quantity_on_hand")).otherwise(0))
              .alias("inv_after")))
    ratio = F.col("inv_after").cast("double") / F.col("inv_before")
    return (g.filter((F.col("inv_before") > 0)
                     & (ratio >= 2.0 / 3.0) & (ratio <= 3.0 / 2.0))
            .order_by("w_warehouse_name", "i_item_id")
            .limit(100))


def q23(s, t):
    """Items with coefficient of variation >= 1.3 in two consecutive months
    (Q23Like:1685) — stddev_samp on the sufficient-statistics agg path."""
    dd = (t["date_dim"]
          .filter((F.col("d_year") == 2001) & (F.col("d_moy") >= 1)
                  & (F.col("d_moy") <= 2))
          .select("d_date_sk", "d_moy"))
    g = (t["inventory"]
         .join(dd, left_on=["inv_date_sk"], right_on=["d_date_sk"])
         .group_by("inv_warehouse_sk", "inv_item_sk", "d_moy")
         .agg(F.stddev_samp("inv_quantity_on_hand").alias("stdev"),
              F.avg("inv_quantity_on_hand").alias("mean")))
    cov = (g.filter((F.col("mean") > 0)
                    & (F.col("stdev") / F.col("mean") >= 1.3))
           .select("inv_warehouse_sk", "inv_item_sk", "d_moy",
                   (F.col("stdev") / F.col("mean")).alias("cov")))
    inv1 = cov.filter(F.col("d_moy") == 1).select(
        F.col("inv_warehouse_sk").alias("w1"),
        F.col("inv_item_sk").alias("i1"),
        F.col("d_moy").alias("d_moy_1"), F.col("cov").alias("cov_1"))
    inv2 = cov.filter(F.col("d_moy") == 2).select(
        F.col("inv_warehouse_sk").alias("w2"),
        F.col("inv_item_sk").alias("i2"),
        F.col("d_moy").alias("d_moy_2"), F.col("cov").alias("cov_2"))
    return (inv1.join(inv2, left_on=["w1", "i1"], right_on=["w2", "i2"])
            .select(F.col("w1").alias("inv_warehouse_sk"),
                    F.col("i1").alias("inv_item_sk"),
                    "d_moy_1", "cov_1", "d_moy_2", "cov_2")
            .order_by("inv_warehouse_sk", "inv_item_sk"))


# the reference pins i_item_sk = 10000, sized for its SF1000+ datasets
# (TpcxbbLikeSpark.scala:1791); scaled down for the generated tables
Q24_ITEM_SK = 15


def q24(s, t):
    """Cross-price elasticity of demand for one item (Q24Like:1761)."""
    comp = (t["item"].filter(F.col("i_item_sk") == Q24_ITEM_SK)
            .select("i_item_sk", "i_current_price")
            .join(t["item_marketprices"].select(
                "imp_item_sk", "imp_sk", "imp_competitor_price",
                "imp_start_date", "imp_end_date"),
                left_on=["i_item_sk"], right_on=["imp_item_sk"])
            .select(F.col("i_item_sk"), F.col("imp_sk"),
                    ((F.col("imp_competitor_price")
                      - F.col("i_current_price"))
                     / F.col("i_current_price")).alias("price_change"),
                    F.col("imp_start_date"),
                    (F.col("imp_end_date") - F.col("imp_start_date"))
                    .alias("no_days_comp_price")))

    def windowed(sales, item_col, date_col, qty_col, cur_name, prev_name):
        j = sales.join(comp, left_on=[item_col], right_on=["i_item_sk"])
        start, ndays = F.col("imp_start_date"), F.col("no_days_comp_price")
        cur = F.sum(F.when((F.col(date_col) >= start)
                           & (F.col(date_col) < start + ndays),
                           F.col(qty_col)).otherwise(0)).alias(cur_name)
        prev = F.sum(F.when((F.col(date_col) >= start - ndays)
                            & (F.col(date_col) < start),
                            F.col(qty_col)).otherwise(0)).alias(prev_name)
        return (j.group_by(item_col, "imp_sk", "price_change")
                .agg(cur, prev))

    wsq = windowed(t["web_sales"].select("ws_item_sk", "ws_sold_date_sk",
                                         "ws_quantity"),
                   "ws_item_sk", "ws_sold_date_sk", "ws_quantity",
                   "current_ws_quant", "prev_ws_quant")
    ssq = windowed(t["store_sales"].select("ss_item_sk", "ss_sold_date_sk",
                                           "ss_quantity"),
                   "ss_item_sk", "ss_sold_date_sk", "ss_quantity",
                   "current_ss_quant", "prev_ss_quant")
    ssq = ssq.select(F.col("ss_item_sk"), F.col("imp_sk").alias("s_imp_sk"),
                     F.col("price_change").alias("s_price_change"),
                     "current_ss_quant", "prev_ss_quant")
    j = wsq.join(ssq, left_on=["ws_item_sk", "imp_sk"],
                 right_on=["ss_item_sk", "s_imp_sk"])
    elasticity = ((F.col("current_ss_quant") + F.col("current_ws_quant")
                   - F.col("prev_ss_quant") - F.col("prev_ws_quant"))
                  .cast("double")
                  / ((F.col("prev_ss_quant") + F.col("prev_ws_quant"))
                     * F.col("price_change")))
    return (j.select(F.col("ws_item_sk"), elasticity.alias("e"))
            .group_by("ws_item_sk")
            .agg(F.avg("e").alias("cross_price_elasticity")))


def q25(s, t):
    """RFM customer segmentation over store + web purchases
    (Q25Like:1861); d_date > '2002-01-02' expressed on the date key, and
    the two INSERTs become a union."""
    cutoff = _sk(_date(2002, 1, 2))
    ss = (t["store_sales"]
          .filter(F.col("ss_customer_sk").isNotNull()
                  & (F.col("ss_sold_date_sk") > cutoff))
          .group_by("ss_customer_sk")
          .agg(F.count_distinct("ss_ticket_number").alias("frequency"),
               F.max("ss_sold_date_sk").alias("most_recent_date"),
               F.sum("ss_net_paid").alias("amount"))
          .select(F.col("ss_customer_sk").alias("cid"), "frequency",
                  "most_recent_date", "amount"))
    ws = (t["web_sales"]
          .filter(F.col("ws_bill_customer_sk").isNotNull()
                  & (F.col("ws_sold_date_sk") > cutoff))
          .group_by("ws_bill_customer_sk")
          .agg(F.count_distinct("ws_order_number").alias("frequency"),
               F.max("ws_sold_date_sk").alias("most_recent_date"),
               F.sum("ws_net_paid").alias("amount"))
          .select(F.col("ws_bill_customer_sk").alias("cid"), "frequency",
                  "most_recent_date", "amount"))
    # 37621 == 2003-01-02 (the reference's hardcoded recency anchor)
    return (ss.union(ws)
            .group_by("cid")
            .agg(F.when(37621 - F.max("most_recent_date") < 60, 1.0)
                 .otherwise(0.0).alias("recency"),
                 F.sum("frequency").alias("frequency"),
                 F.sum("amount").alias("totalspend"))
            .order_by("cid"))


def q26(s, t):
    """Book-club clustering vectors: per-customer purchase counts in class
    ids 1..15 (Q26Like:1945)."""
    item = (t["item"].filter(F.col("i_category") == "Books")
            .select("i_item_sk", "i_class_id"))
    j = (t["store_sales"].filter(F.col("ss_customer_sk").isNotNull())
         .select("ss_customer_sk", "ss_item_sk")
         .join(item, left_on=["ss_item_sk"], right_on=["i_item_sk"]))
    class_counts = [F.count(F.when(F.col("i_class_id") == i, 1))
                    .alias(f"id{i}") for i in range(1, 16)]
    g = (j.group_by("ss_customer_sk")
         .agg(*class_counts, F.count("ss_item_sk").alias("total_cnt")))
    return (g.filter(F.col("total_cnt") > 5)
            .select(F.col("ss_customer_sk").alias("cid"),
                    *[F.col(f"id{i}") for i in range(1, 16)])
            .order_by("cid"))


def q28(s, t):
    """90/10 train/test split of product reviews for sentiment
    classification (Q28Like:2004). The reference INSERT-OVERWRITEs two
    tables; here both splits come back as one labelled DataFrame."""
    pr = t["product_reviews"].select(
        "pr_review_sk", F.col("pr_review_rating").alias("pr_rating"),
        "pr_review_content")
    m = F.pmod(F.col("pr_review_sk"), 10)
    train = pr.filter(m != 0).select(
        F.lit("train").alias("split"), "pr_review_sk", "pr_rating",
        "pr_review_content")
    test = pr.filter(m == 0).select(
        F.lit("test").alias("split"), "pr_review_sk", "pr_rating",
        "pr_review_content")
    return train.union(test).order_by("split", "pr_review_sk")


QUERIES: Dict[str, Callable] = {
    "q5": q5, "q6": q6, "q7": q7, "q9": q9, "q11": q11, "q12": q12,
    "q13": q13, "q14": q14, "q15": q15, "q16": q16, "q17": q17, "q20": q20,
    "q21": q21, "q22": q22, "q23": q23, "q24": q24, "q25": q25, "q26": q26,
    "q28": q28,
}

# same not-implemented split as the reference (TpcxbbLikeSpark.scala:785+)
UNSUPPORTED: Dict[str, str] = {
    "q1": "Q1 uses UDTF", "q2": "Q2 uses UDTF", "q3": "Q3 calls python",
    "q4": "Q4 calls python", "q8": "Q8 calls python", "q10": "Q10 uses UDF",
    "q18": "Q18 uses UDF", "q19": "Q19 uses UDF", "q27": "Q27 uses UDF",
    "q29": "Q29 uses UDTF", "q30": "Q30 uses UDTF",
}


class TpcxbbTables:
    """Generate the TPCxBB tables as DataFrames."""

    @staticmethod
    def generate(session, sf: float, num_partitions: int = 4):
        from spark_rapids_tpu_torch.models import tpcxbb_data as gen
        out = {}
        for name, fn in gen.ALL_TABLES.items():
            out[name] = session.create_dataframe(fn(sf, None),
                                                 num_partitions)
        return out

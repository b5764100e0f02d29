"""Synthetic TPCxBB-like (BigBench) data generator (a copy of the JAX
package's ``models/tpcxbb_data.py``: the same rows for the same scale
factor and seeds, 31-103).

The reference feeds its TPCxBB-like 30-query suite from pre-generated CSV /
Parquet files with fixed schemas (integration_tests/.../tpcxbb/
TpcxbbLikeSpark.scala:25-783 declares every table's StructType). This module
generates statistically similar tables in-memory at a given scale factor so
the suite is self-contained, mirroring those schemas' column names/dtypes for
every column the queries touch.

Date surrogate keys follow the TPC-DS/BigBench convention the query literals
assume: ``*_date_sk`` = days since 1900-01-01 (the reference's Q25 hardcodes
``37621 == 2003-01-02``, TpcxbbLikeSpark.scala:1930). The generated date_dim
spans 2000-01-01..2004-12-31, covering every date literal in the suite.
"""

from __future__ import annotations

import datetime
import functools

import numpy as np
import pandas as pd

# rows per unit scale factor (sf=1 stays laptop-sized; benchmarks raise sf)
STORE_SALES_PER_SF = 40_000
WEB_SALES_PER_SF = 20_000
CLICKS_PER_SF = 60_000
STORE_RETURNS_PER_SF = 8_000
WEB_RETURNS_PER_SF = 4_000
INVENTORY_PER_SF = 30_000
REVIEWS_PER_SF = 3_000
MARKETPRICES_PER_SF = 2_000
CUSTOMERS_PER_SF = 2_000
ITEMS_PER_SF = 400

_EPOCH = datetime.date(1900, 1, 1)
_DATE_LO = datetime.date(2000, 1, 1)
_DATE_HI = datetime.date(2004, 12, 31)


def date_sk(d: datetime.date) -> int:
    """days since 1900-01-01 — the key convention query literals assume."""
    return (d - _EPOCH).days


_SK_LO = date_sk(_DATE_LO)
_SK_HI = date_sk(_DATE_HI)

_CATEGORIES = ["Books", "Electronics", "Music", "Home", "Sports",
               "Toys", "Clothing", "Jewelry", "Garden", "Shoes"]
_EDU = ["Advanced Degree", "College", "4 yr Degree", "2 yr Degree",
        "Secondary", "Primary", "Unknown"]
_STATES = ["KY", "GA", "NM", "MT", "OR", "IN", "WI", "MO", "WV",
           "CA", "NY", "TX", "WA", "FL", "IL"]


def _days(rng, n):
    return rng.integers(_SK_LO, _SK_HI + 1, n).astype(np.int64)


def gen_date_dim() -> pd.DataFrame:
    days = pd.date_range(_DATE_LO, _DATE_HI, freq="D")
    sks = np.array([date_sk(d.date()) for d in days], dtype=np.int64)
    return pd.DataFrame({
        "d_date_sk": sks,
        "d_date_id": np.char.add("D", sks.astype(str)).astype(object),
        "d_date": days.strftime("%Y-%m-%d").values.astype(object),
        "d_year": days.year.values.astype(np.int32),
        "d_moy": days.month.values.astype(np.int32),
        "d_dom": days.day.values.astype(np.int32),
        "d_dow": days.dayofweek.values.astype(np.int32),
        "d_qoy": days.quarter.values.astype(np.int32),
    })


def gen_time_dim() -> pd.DataFrame:
    secs = np.arange(0, 86400, 60, dtype=np.int64)  # minute resolution
    hours = (secs // 3600).astype(np.int32)
    return pd.DataFrame({
        "t_time_sk": secs,
        "t_time_id": np.char.add("T", secs.astype(str)).astype(object),
        "t_time": secs.astype(np.int32),
        "t_hour": hours,
        "t_minute": ((secs % 3600) // 60).astype(np.int32),
        "t_second": np.zeros(len(secs), dtype=np.int32),
        "t_am_pm": np.where(hours < 12, "AM", "PM").astype(object),
    })


def gen_item(sf: float, seed: int = 31) -> pd.DataFrame:
    n = max(20, int(ITEMS_PER_SF * sf))
    rng = np.random.default_rng(seed)
    cat_id = rng.integers(1, 11, n).astype(np.int32)
    cats = np.asarray(_CATEGORIES, dtype=object)[cat_id - 1]
    return pd.DataFrame({
        "i_item_sk": np.arange(1, n + 1, dtype=np.int64),
        "i_item_id": np.char.add("ITEM", np.arange(1, n + 1).astype(str))
                       .astype(object),
        "i_item_desc": np.char.add("desc of item ",
                                   np.arange(1, n + 1).astype(str))
                         .astype(object),
        "i_current_price": np.round(rng.uniform(0.5, 5.0, n), 2),
        "i_category_id": cat_id,
        "i_category": cats,
        "i_class_id": rng.integers(1, 16, n).astype(np.int32),
        "i_class": np.char.add("class", rng.integers(1, 16, n).astype(str))
                     .astype(object),
        "i_brand_id": rng.integers(1, 100, n).astype(np.int32),
        "i_manager_id": rng.integers(1, 50, n).astype(np.int32),
    })


def gen_customer(sf: float, seed: int = 37) -> pd.DataFrame:
    n = max(50, int(CUSTOMERS_PER_SF * sf))
    rng = np.random.default_rng(seed)
    return pd.DataFrame({
        "c_customer_sk": np.arange(1, n + 1, dtype=np.int64),
        "c_customer_id": np.char.add("C", np.arange(1, n + 1).astype(str))
                           .astype(object),
        "c_current_cdemo_sk": rng.integers(1, _demo_rows(sf) + 1,
                                           n).astype(np.int64),
        "c_current_hdemo_sk": rng.integers(1, 101, n).astype(np.int64),
        "c_current_addr_sk": rng.integers(1, n + 1, n).astype(np.int64),
        "c_first_name": np.char.add("First", np.arange(n).astype(str))
                          .astype(object),
        "c_last_name": np.char.add("Last", np.arange(n).astype(str))
                         .astype(object),
        "c_preferred_cust_flag": np.asarray(["Y", "N"], dtype=object)[
            rng.integers(0, 2, n)],
        "c_birth_year": rng.integers(1940, 2000, n).astype(np.int32),
        "c_birth_country": np.asarray(
            ["UNITED STATES", "CANADA", "GERMANY", "JAPAN"],
            dtype=object)[rng.integers(0, 4, n)],
        "c_login": np.char.add("login", np.arange(n).astype(str))
                     .astype(object),
        "c_email_address": np.char.add("user", np.arange(n).astype(str))
                             .astype(object),
    })


def _demo_rows(sf: float) -> int:
    return max(40, int(200 * sf))


def gen_customer_demographics(sf: float, seed: int = 41) -> pd.DataFrame:
    n = _demo_rows(sf)
    rng = np.random.default_rng(seed)
    return pd.DataFrame({
        "cd_demo_sk": np.arange(1, n + 1, dtype=np.int64),
        "cd_gender": np.asarray(["M", "F"], dtype=object)[
            rng.integers(0, 2, n)],
        "cd_marital_status": np.asarray(["M", "S", "D", "W"], dtype=object)[
            rng.integers(0, 4, n)],
        "cd_education_status": np.asarray(_EDU, dtype=object)[
            rng.integers(0, len(_EDU), n)],
        "cd_purchase_estimate": rng.integers(500, 10000, n).astype(np.int32),
        "cd_dep_count": rng.integers(0, 7, n).astype(np.int32),
    })


def gen_household_demographics(seed: int = 43) -> pd.DataFrame:
    rng = np.random.default_rng(seed)
    n = 100
    return pd.DataFrame({
        "hd_demo_sk": np.arange(1, n + 1, dtype=np.int64),
        "hd_income_band_sk": rng.integers(1, 21, n).astype(np.int64),
        "hd_buy_potential": np.asarray(["1001-5000", "5001-10000", "0-500"],
                                       dtype=object)[rng.integers(0, 3, n)],
        "hd_dep_count": rng.integers(0, 10, n).astype(np.int32),
        "hd_vehicle_count": rng.integers(0, 5, n).astype(np.int32),
    })


def gen_customer_address(sf: float, seed: int = 47) -> pd.DataFrame:
    n = max(50, int(CUSTOMERS_PER_SF * sf))
    rng = np.random.default_rng(seed)
    states = np.asarray(_STATES, dtype=object)[
        rng.integers(0, len(_STATES), n)]
    # a sprinkle of NULL states (Q7 filters ca_state IS NOT NULL)
    states[rng.random(n) < 0.02] = None
    return pd.DataFrame({
        "ca_address_sk": np.arange(1, n + 1, dtype=np.int64),
        "ca_address_id": np.char.add("A", np.arange(1, n + 1).astype(str))
                           .astype(object),
        "ca_city": np.char.add("city", rng.integers(0, 40, n).astype(str))
                     .astype(object),
        "ca_state": states,
        "ca_zip": rng.integers(10000, 99999, n).astype(str).astype(object),
        "ca_country": np.asarray(["United States", "Canada"], dtype=object)[
            (rng.random(n) < 0.1).astype(int)],
        "ca_gmt_offset": np.asarray([-5.0, -6.0, -7.0, -8.0])[
            rng.integers(0, 4, n)],
    })


def gen_store(seed: int = 53) -> pd.DataFrame:
    rng = np.random.default_rng(seed)
    n = 12
    return pd.DataFrame({
        "s_store_sk": np.arange(1, n + 1, dtype=np.int64),
        "s_store_id": np.char.add("S", np.arange(1, n + 1).astype(str))
                        .astype(object),
        "s_store_name": np.char.add("store ", np.arange(1, n + 1).astype(str))
                          .astype(object),
        "s_number_employees": rng.integers(50, 300, n).astype(np.int32),
        "s_market_id": rng.integers(1, 11, n).astype(np.int32),
        "s_state": np.asarray(_STATES, dtype=object)[
            rng.integers(0, len(_STATES), n)],
        "s_gmt_offset": np.asarray([-5.0, -6.0, -7.0, -8.0])[
            rng.integers(0, 4, n)],
    })


def gen_warehouse(seed: int = 59) -> pd.DataFrame:
    rng = np.random.default_rng(seed)
    n = 6
    return pd.DataFrame({
        "w_warehouse_sk": np.arange(1, n + 1, dtype=np.int64),
        "w_warehouse_id": np.char.add("W", np.arange(1, n + 1).astype(str))
                            .astype(object),
        "w_warehouse_name": np.char.add("warehouse ",
                                        np.arange(1, n + 1).astype(str))
                              .astype(object),
        "w_warehouse_sq_ft": rng.integers(50000, 900000, n).astype(np.int32),
        "w_state": np.asarray(_STATES, dtype=object)[
            rng.integers(0, len(_STATES), n)],
    })


def gen_web_page(seed: int = 61) -> pd.DataFrame:
    rng = np.random.default_rng(seed)
    n = 60
    return pd.DataFrame({
        "wp_web_page_sk": np.arange(1, n + 1, dtype=np.int64),
        "wp_web_page_id": np.char.add("WP", np.arange(1, n + 1).astype(str))
                            .astype(object),
        "wp_char_count": rng.integers(100, 7001, n).astype(np.int32),
        "wp_link_count": rng.integers(2, 25, n).astype(np.int32),
        "wp_type": np.asarray(["order", "general", "welcome", "ad"],
                              dtype=object)[rng.integers(0, 4, n)],
    })


def gen_promotion(seed: int = 67) -> pd.DataFrame:
    rng = np.random.default_rng(seed)
    n = 40
    yn = np.asarray(["Y", "N"], dtype=object)
    return pd.DataFrame({
        "p_promo_sk": np.arange(1, n + 1, dtype=np.int64),
        "p_promo_id": np.char.add("P", np.arange(1, n + 1).astype(str))
                        .astype(object),
        "p_channel_dmail": yn[rng.integers(0, 2, n)],
        "p_channel_email": yn[rng.integers(0, 2, n)],
        "p_channel_tv": yn[rng.integers(0, 2, n)],
    })


@functools.lru_cache(maxsize=4)
def gen_store_sales(sf: float, seed: int = 71) -> pd.DataFrame:
    n = max(200, int(STORE_SALES_PER_SF * sf))
    rng = np.random.default_rng(seed)
    n_cust = max(50, int(CUSTOMERS_PER_SF * sf))
    n_item = max(20, int(ITEMS_PER_SF * sf))
    cust = rng.integers(1, n_cust + 1, n).astype(np.float64)
    cust[rng.random(n) < 0.02] = np.nan  # NULL customers exist in BigBench
    wholesale = np.round(rng.uniform(1.0, 100.0, n), 2)
    qty = rng.integers(1, 100, n).astype(np.int32)
    sales_price = np.round(rng.uniform(0.0, 300.0, n), 2)
    return pd.DataFrame({
        "ss_sold_date_sk": _days(rng, n),
        "ss_sold_time_sk": rng.integers(0, 86400, n).astype(np.int64),
        "ss_item_sk": rng.integers(1, n_item + 1, n).astype(np.int64),
        "ss_customer_sk": pd.array(cust).astype("Int64"),
        "ss_cdemo_sk": rng.integers(1, _demo_rows(sf) + 1,
                                    n).astype(np.int64),
        "ss_hdemo_sk": rng.integers(1, 101, n).astype(np.int64),
        "ss_addr_sk": rng.integers(1, n_cust + 1, n).astype(np.int64),
        "ss_store_sk": rng.integers(1, 13, n).astype(np.int64),
        "ss_promo_sk": rng.integers(1, 41, n).astype(np.int64),
        "ss_ticket_number": rng.integers(1, max(2, n // 3),
                                         n).astype(np.int64),
        "ss_quantity": qty,
        "ss_wholesale_cost": wholesale,
        "ss_sales_price": sales_price,
        "ss_ext_discount_amt": np.round(rng.uniform(0.0, 50.0, n), 2),
        "ss_ext_sales_price": np.round(sales_price * qty, 2),
        "ss_ext_wholesale_cost": np.round(wholesale * qty, 2),
        "ss_ext_list_price": np.round(wholesale * qty
                                      * rng.uniform(1.0, 2.0, n), 2),
        "ss_net_paid": np.round(sales_price * qty
                                * rng.uniform(0.8, 1.0, n), 2),
        "ss_net_profit": np.round(rng.uniform(-500.0, 25000.0, n), 2),
    })


def gen_store_returns(sf: float, seed: int = 73) -> pd.DataFrame:
    """Returns reference actual store_sales rows (ticket/item/customer
    triples), as in the real dataset — Q21's sale->return->web-repurchase
    chain depends on it."""
    n = max(50, int(STORE_RETURNS_PER_SF * sf))
    rng = np.random.default_rng(seed)
    sales = gen_store_sales(sf)
    pick = rng.integers(0, len(sales), n)
    cust = sales["ss_customer_sk"].to_numpy()[pick]
    cust = pd.array(cust).astype("Int64")
    cust = np.where(pd.isna(cust), 1, cust).astype(np.int64)
    return pd.DataFrame({
        "sr_returned_date_sk": np.minimum(
            sales["ss_sold_date_sk"].to_numpy()[pick]
            + rng.integers(1, 180, n), _SK_HI).astype(np.int64),
        "sr_item_sk": sales["ss_item_sk"].to_numpy()[pick],
        "sr_customer_sk": cust,
        "sr_ticket_number": sales["ss_ticket_number"].to_numpy()[pick],
        "sr_return_quantity": rng.integers(1, 40, n).astype(np.int32),
        "sr_return_amt": np.round(rng.uniform(1.0, 4000.0, n), 2),
    })


@functools.lru_cache(maxsize=4)
def gen_web_sales(sf: float, seed: int = 79) -> pd.DataFrame:
    n = max(100, int(WEB_SALES_PER_SF * sf))
    rng = np.random.default_rng(seed)
    n_cust = max(50, int(CUSTOMERS_PER_SF * sf))
    n_item = max(20, int(ITEMS_PER_SF * sf))
    qty = rng.integers(1, 100, n).astype(np.int32)
    wholesale = np.round(rng.uniform(1.0, 100.0, n), 2)
    sales_price = np.round(rng.uniform(0.0, 300.0, n), 2)
    # a third of web orders are repurchases by store customers of the
    # same item, later in time — the behaviour Q21's store-sale ->
    # return -> web-repurchase chain measures
    ss = gen_store_sales(sf)
    pick = rng.integers(0, len(ss), n)
    rep = rng.random(n) < 0.33
    ss_cust = pd.array(ss["ss_customer_sk"].to_numpy()[pick]).astype("Int64")
    ss_cust = np.where(pd.isna(ss_cust), 1, ss_cust).astype(np.int64)
    item = np.where(rep, ss["ss_item_sk"].to_numpy()[pick],
                    rng.integers(1, n_item + 1, n)).astype(np.int64)
    cust = np.where(rep, ss_cust,
                    rng.integers(1, n_cust + 1, n)).astype(np.int64)
    sold = np.where(
        rep,
        np.minimum(ss["ss_sold_date_sk"].to_numpy()[pick]
                   + rng.integers(30, 700, n), _SK_HI),
        _days(rng, n)).astype(np.int64)
    return pd.DataFrame({
        "ws_sold_date_sk": sold,
        "ws_sold_time_sk": (rng.integers(0, 1440, n) * 60).astype(np.int64),
        "ws_item_sk": item,
        "ws_bill_customer_sk": cust,
        "ws_ship_hdemo_sk": rng.integers(1, 101, n).astype(np.int64),
        "ws_web_page_sk": rng.integers(1, 61, n).astype(np.int64),
        "ws_warehouse_sk": rng.integers(1, 7, n).astype(np.int64),
        "ws_order_number": rng.integers(1, max(2, n // 2),
                                        n).astype(np.int64),
        "ws_quantity": qty,
        "ws_wholesale_cost": wholesale,
        "ws_sales_price": sales_price,
        "ws_ext_discount_amt": np.round(rng.uniform(0.0, 50.0, n), 2),
        "ws_ext_sales_price": np.round(sales_price * qty, 2),
        "ws_ext_wholesale_cost": np.round(wholesale * qty, 2),
        "ws_ext_list_price": np.round(wholesale * qty
                                      * rng.uniform(1.0, 2.0, n), 2),
        "ws_net_paid": np.round(sales_price * qty
                                * rng.uniform(0.8, 1.0, n), 2),
    })


def gen_web_returns(sf: float, seed: int = 83) -> pd.DataFrame:
    """Returns reference actual web_sales (order, item) pairs so Q16's
    left join finds refunds."""
    n = max(30, int(WEB_RETURNS_PER_SF * sf))
    rng = np.random.default_rng(seed)
    sales = gen_web_sales(sf)
    pick = rng.integers(0, len(sales), n)
    return pd.DataFrame({
        "wr_returned_date_sk": np.minimum(
            sales["ws_sold_date_sk"].to_numpy()[pick]
            + rng.integers(1, 90, n), _SK_HI).astype(np.int64),
        "wr_item_sk": sales["ws_item_sk"].to_numpy()[pick],
        "wr_order_number": sales["ws_order_number"].to_numpy()[pick],
        "wr_return_quantity": rng.integers(1, 40, n).astype(np.int32),
        "wr_refunded_cash": np.round(rng.uniform(0.0, 2000.0, n), 2),
    })


def gen_web_clickstreams(sf: float, seed: int = 89) -> pd.DataFrame:
    n = max(300, int(CLICKS_PER_SF * sf))
    rng = np.random.default_rng(seed)
    n_cust = max(50, int(CUSTOMERS_PER_SF * sf))
    n_item = max(20, int(ITEMS_PER_SF * sf))
    user = rng.integers(1, n_cust + 1, n).astype(np.float64)
    user[rng.random(n) < 0.05] = np.nan  # anonymous clicks
    sales = rng.integers(1, 1000, n).astype(np.float64)
    sales[rng.random(n) < 0.7] = np.nan  # most clicks are views, not buys
    return pd.DataFrame({
        "wcs_click_date_sk": _days(rng, n),
        "wcs_click_time_sk": rng.integers(0, 86400, n).astype(np.int64),
        "wcs_sales_sk": pd.array(sales).astype("Int64"),
        "wcs_item_sk": rng.integers(1, n_item + 1, n).astype(np.int64),
        "wcs_web_page_sk": rng.integers(1, 61, n).astype(np.int64),
        "wcs_user_sk": pd.array(user).astype("Int64"),
    })


def gen_inventory(sf: float, seed: int = 97) -> pd.DataFrame:
    """Weekly snapshots per (warehouse, item) across 2001 — the TPC shape:
    Q22's +-30-day window around 2001-05-08 and Q23's per-month
    coefficient of variation both need several observations per group."""
    rng = np.random.default_rng(seed)
    n_item = max(20, int(ITEMS_PER_SF * sf))
    weeks = np.arange(date_sk(datetime.date(2001, 1, 1)),
                      date_sk(datetime.date(2001, 12, 31)), 7,
                      dtype=np.int64)
    wh = np.arange(1, 7, dtype=np.int64)
    items = np.arange(1, n_item + 1, dtype=np.int64)
    grid = np.array(np.meshgrid(weeks, wh, items,
                                indexing="ij")).reshape(3, -1)
    n = grid.shape[1]
    # zero-inflated quantities: stock-outs push the coefficient of
    # variation past Q23's >= 1.3 threshold for a realistic slice of items
    qty = rng.integers(0, 1000, n).astype(np.int32)
    qty[rng.random(n) < 0.55] = 0
    return pd.DataFrame({
        "inv_date_sk": grid[0],
        "inv_item_sk": grid[2],
        "inv_warehouse_sk": grid[1],
        "inv_quantity_on_hand": qty,
    })


def gen_product_reviews(sf: float, seed: int = 101) -> pd.DataFrame:
    n = max(40, int(REVIEWS_PER_SF * sf))
    rng = np.random.default_rng(seed)
    n_item = max(20, int(ITEMS_PER_SF * sf))
    words = np.asarray(["great", "poor", "average", "fantastic", "bad",
                        "decent", "solid", "broken"], dtype=object)
    content = (words[rng.integers(0, 8, n)] + " product, "
               + words[rng.integers(0, 8, n)] + " service")
    return pd.DataFrame({
        "pr_review_sk": np.arange(1, n + 1, dtype=np.int64),
        "pr_review_rating": rng.integers(1, 6, n).astype(np.int32),
        "pr_item_sk": rng.integers(1, n_item + 1, n).astype(np.int64),
        "pr_user_sk": rng.integers(1, max(51, int(CUSTOMERS_PER_SF * sf) + 1),
                                   n).astype(np.int64),
        "pr_review_content": content,
    })


def gen_item_marketprices(sf: float, seed: int = 103) -> pd.DataFrame:
    n = max(30, int(MARKETPRICES_PER_SF * sf))
    rng = np.random.default_rng(seed)
    n_item = max(20, int(ITEMS_PER_SF * sf))
    start = _days(rng, n)
    return pd.DataFrame({
        "imp_sk": np.arange(1, n + 1, dtype=np.int64),
        "imp_item_sk": rng.integers(1, n_item + 1, n).astype(np.int64),
        "imp_competitor": np.char.add("comp",
                                      rng.integers(1, 6, n).astype(str))
                            .astype(object),
        "imp_competitor_price": np.round(rng.uniform(0.3, 6.0, n), 2),
        "imp_start_date": start,
        "imp_end_date": start + rng.integers(10, 120, n),
    })


ALL_TABLES = {
    "date_dim": lambda sf, np_: gen_date_dim(),
    "time_dim": lambda sf, np_: gen_time_dim(),
    "item": lambda sf, np_: gen_item(sf),
    "customer": lambda sf, np_: gen_customer(sf),
    "customer_demographics": lambda sf, np_: gen_customer_demographics(sf),
    "household_demographics": lambda sf, np_: gen_household_demographics(),
    "customer_address": lambda sf, np_: gen_customer_address(sf),
    "store": lambda sf, np_: gen_store(),
    "warehouse": lambda sf, np_: gen_warehouse(),
    "web_page": lambda sf, np_: gen_web_page(),
    "promotion": lambda sf, np_: gen_promotion(),
    "store_sales": lambda sf, np_: gen_store_sales(sf),
    "store_returns": lambda sf, np_: gen_store_returns(sf),
    "web_sales": lambda sf, np_: gen_web_sales(sf),
    "web_returns": lambda sf, np_: gen_web_returns(sf),
    "web_clickstreams": lambda sf, np_: gen_web_clickstreams(sf),
    "inventory": lambda sf, np_: gen_inventory(sf),
    "product_reviews": lambda sf, np_: gen_product_reviews(sf),
    "item_marketprices": lambda sf, np_: gen_item_marketprices(sf),
}

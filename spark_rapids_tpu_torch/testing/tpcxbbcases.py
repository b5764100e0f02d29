"""TPCxBB answers as the port's tests and ``chip_smoke.py`` check them: each
query's sort columns, the row comparison, a pandas reference for each of
the 19 queries of ``models/tpcxbb.py``, and the one frame change that
makes a query return rows:

  * Q7 counts, per state, the store sales of July 2004 of items priced 20%
    above their category's average, and keeps states with at least 10.
    At small scale factors no state reaches 10, so ``q7_store_sales``
    adds 12 such sales by one customer of the first state that has
    customers (no change to a query's answer at the scale factors where
    states already pass, but one more state's count).

The references follow the queries' SQL semantics, not pandas': rows with
a NULL join key never match, a NULL group key forms its own group, an
aggregate skips NULLs and is NULL over no values, ``x / 0`` is NULL.
Each one filters and projects before it merges, so that SF 250 runs in
seconds.
"""

from __future__ import annotations

import datetime

import numpy as np
import pandas as pd

from spark_rapids_tpu_torch.models.tpcxbb_data import date_sk

F64_RTOL = 1e-9

# each query's sort columns (None: compared as a set of rows)
ORDERS = {
    "q5": None,
    "q6": ["web_sales_increase_ratio", "c_customer_sk", "c_first_name",
           "c_last_name", "c_preferred_cust_flag", "c_birth_country",
           "c_login"],
    "q7": ["cnt", "ca_state"], "q9": None, "q11": None,
    "q12": ["wcs_user_sk"],
    "q13": ["webSalesIncreaseRatio", "c_customer_sk", "c_first_name",
            "c_last_name"],
    "q14": None, "q15": ["cat"], "q16": ["w_state", "i_item_id"],
    "q17": ["promotional", "total"], "q20": ["user_sk"],
    "q21": ["i_item_id", "i_item_desc", "s_store_id", "s_store_name"],
    "q22": ["w_warehouse_name", "i_item_id"],
    "q23": ["inv_warehouse_sk", "inv_item_sk"], "q24": None,
    "q25": ["cid"], "q26": ["cid"], "q28": ["split", "pr_review_sk"],
}

# the columns a query rounds (HALF_UP, to the scale given) from values it
# computed from float sums: where the reference's unrounded value (its
# "__raw_" column) lies within the float tolerance of a rounding
# boundary, the sums' order of addition decides the rounding, and either
# neighbour is right (Q20 at SF 250 on the card: 1 row of 500,001)
ROUNDED = {"q20": {"orderRatio": 7, "itemsRatio": 7, "monetaryRatio": 7}}
RAW = "__raw_"

Q7_EXTRA_SALES = 12


def q7_store_sales(fr: dict) -> pd.DataFrame:
    """store_sales with ``Q7_EXTRA_SALES`` rows on a July 2004 date of an
    item priced above 1.2x its category's average, by a customer whose
    current address has a state."""
    item, ss = fr["item"], fr["store_sales"]
    avg = item.groupby("i_category").i_current_price.transform("mean")
    high = item.i_item_sk[item.i_current_price > avg * 1.2]
    ca, c = fr["customer_address"], fr["customer"]
    with_state = ca.ca_address_sk[ca.ca_state.notna()]
    cust = c.c_customer_sk[c.c_current_addr_sk.isin(with_state)]
    if not len(high) or not len(cust):
        return ss
    extra = ss.iloc[[0] * Q7_EXTRA_SALES].reset_index(drop=True).copy()
    extra["ss_sold_date_sk"] = np.int64(date_sk(datetime.date(2004, 7, 15)))
    extra["ss_item_sk"] = np.int64(high.iloc[0])
    extra["ss_customer_sk"] = pd.array([int(cust.iloc[0])]
                                       * Q7_EXTRA_SALES, dtype="Int64")
    return pd.concat([ss, extra], ignore_index=True)


def query_frames(qname: str, frames: dict) -> dict:
    """``frames`` with the change ``qname`` needs (Q7), if any."""
    fr = dict(frames)
    if qname == "q7":
        fr["store_sales"] = q7_store_sales(fr)
    return fr


def in_query_order(df: pd.DataFrame, sort_cols) -> pd.DataFrame:
    """``df`` with the rows of each run tied on ``sort_cols`` (all rows for
    None) ordered by their other non-float columns, so that two answers
    compare row by row."""
    sort_cols = list(sort_cols or [])
    keyed = [c for c in df.columns if c not in sort_cols
             and not pd.api.types.is_float_dtype(df[c].dtype)]
    tie = (df.groupby(sort_cols, sort=False, dropna=False).ngroup()
           .to_numpy() if sort_cols else np.zeros(len(df), np.int64))
    keys = [df[c].astype(str).to_numpy() for c in reversed(keyed)]
    return df.iloc[np.lexsort(keys + [tie])].reset_index(drop=True)


def _floats(s: pd.Series) -> np.ndarray:
    return s.astype("Float64").to_numpy(np.float64, na_value=np.nan)


def same_rows(got: pd.DataFrame, want: pd.DataFrame, rtol: float = F64_RTOL,
              ties: dict = None) -> float:
    """Row by row: floats at ``rtol`` (NULL equal to NULL), the rest
    exact as text; ``ties`` maps a rounded column to (rows whose value
    may round either way, the rounding unit). Returns the largest
    relative float error."""
    assert list(got.columns) == list(want.columns), (list(got.columns),
                                                     list(want.columns))
    assert len(got) == len(want), (len(got), len(want))
    worst = 0.0
    for c in got.columns:
        g, w = got[c], want[c]
        if pd.api.types.is_float_dtype(w.dtype):
            gv, wv = _floats(g), _floats(w)
            if ties and c in ties:
                tie, unit = ties[c]
                assert (np.abs(gv[tie] - wv[tie]) <= unit * 1.000001).all(), c
                gv, wv = gv[~tie], wv[~tie]
            np.testing.assert_allclose(gv, wv, rtol=rtol, err_msg=c,
                                       equal_nan=True)
            both = ~np.isnan(wv) & (wv != 0)
            if both.any():
                worst = max(worst, float(np.max(
                    np.abs(gv[both] - wv[both]) / np.abs(wv[both]))))
        else:
            assert ([str(x) for x in g.astype(object)]
                    == [str(x) for x in w.astype(object)]), c
    return worst


def same_answer(qname: str, got: pd.DataFrame, want: pd.DataFrame,
                rtol: float = F64_RTOL) -> float:
    """``same_rows`` of two answers of ``qname`` in its order; a pandas
    reference's unrounded columns (``ROUNDED``) mark its rounding ties."""
    got = in_query_order(got, ORDERS[qname])
    want = in_query_order(want, ORDERS[qname])
    ties = {}
    for c, scale in ROUNDED.get(qname, {}).items():
        if RAW + c in want.columns:
            x = np.abs(_floats(want.pop(RAW + c))) * 10.0 ** scale
            ties[c] = (np.abs(x - np.floor(x) - 0.5)
                       <= rtol * np.maximum(x, 1.0), 10.0 ** -scale)
    return same_rows(got, want, rtol, ties)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _sk(y: int, m: int, d: int) -> int:
    return date_sk(datetime.date(y, m, d))


def _dates(t, cond) -> np.ndarray:
    dd = t["date_dim"]
    return dd.d_date_sk[cond(dd)].to_numpy()


def _notna(df: pd.DataFrame, *cols) -> pd.DataFrame:
    m = np.ones(len(df), bool)
    for c in cols:
        m &= df[c].notna().to_numpy()
    return df[m]


def _int(s) -> np.ndarray:
    return np.asarray(s, dtype=np.int64)


def _sorted(df: pd.DataFrame, cols, ascending) -> pd.DataFrame:
    return df.sort_values(cols, ascending=ascending,
                          kind="stable").reset_index(drop=True)


def _nullable_float(x) -> pd.Series:
    return pd.Series(pd.array([None if x is None or (isinstance(x, float)
                                                     and np.isnan(x))
                               else float(x)], dtype="Float64"))


# ---------------------------------------------------------------------------
# the 19 references
# ---------------------------------------------------------------------------

def _ref_q5(t):
    w = _notna(t["web_clickstreams"][["wcs_user_sk", "wcs_item_sk"]],
               "wcs_user_sk")
    it = t["item"][["i_item_sk", "i_category", "i_category_id"]]
    j = w.merge(it, left_on="wcs_item_sk", right_on="i_item_sk")
    feats = pd.DataFrame({"u": _int(j.wcs_user_sk),
                          "clicks_in_category":
                              (j.i_category == "Books").astype(np.int64)})
    for i in range(1, 8):
        feats[f"clicks_in_{i}"] = (j.i_category_id == i).to_numpy(np.int64)
    per_user = feats.groupby("u", as_index=False).sum()
    c = t["customer"][["c_customer_sk", "c_current_cdemo_sk"]]
    cd = t["customer_demographics"][["cd_demo_sk", "cd_gender",
                                     "cd_education_status"]]
    out = (per_user.merge(c, left_on="u", right_on="c_customer_sk")
           .merge(cd, left_on="c_current_cdemo_sk", right_on="cd_demo_sk"))
    college = out.cd_education_status.isin(
        ["Advanced Degree", "College", "4 yr Degree", "2 yr Degree"])
    res = pd.DataFrame({
        "clicks_in_category": out.clicks_in_category.to_numpy(np.int64),
        "college_education": college.to_numpy(np.int64),
        "male": (out.cd_gender == "M").to_numpy(np.int64)})
    for i in range(1, 8):
        res[f"clicks_in_{i}"] = out[f"clicks_in_{i}"].to_numpy(np.int64)
    return res


def _year_over_year(t, sales, date_col, cust_col, amount, year=2001):
    dd = t["date_dim"]
    dd = dd[dd.d_year.isin([year, year + 1])][["d_date_sk", "d_year"]]
    j = _notna(sales, cust_col).merge(dd, left_on=date_col,
                                      right_on="d_date_sk")
    amt = amount(j)
    g = pd.DataFrame({
        "cust": _int(j[cust_col]),
        "first": np.where(j.d_year == year, amt, 0.0),
        "second": np.where(j.d_year == year + 1, amt, 0.0)})
    g = g.groupby("cust", as_index=False).sum()
    return g[g["first"] > 0]


def _yoy_pair(t, ss_amount, ws_amount):
    store = _year_over_year(t, t["store_sales"], "ss_sold_date_sk",
                            "ss_customer_sk", ss_amount)
    web = _year_over_year(t, t["web_sales"], "ws_sold_date_sk",
                          "ws_bill_customer_sk", ws_amount)
    j = store.merge(web, on="cust", suffixes=("_s", "_w"))
    j = j.assign(web_ratio=j.second_w / j.first_w,
                 store_ratio=j.second_s / j.first_s)
    j = j[j.web_ratio > j.store_ratio]
    return j.merge(t["customer"], left_on="cust", right_on="c_customer_sk")


def _ref_q6(t):
    def amount(p):
        return lambda j: ((j[f"{p}_ext_list_price"]
                           - j[f"{p}_ext_wholesale_cost"]
                           - j[f"{p}_ext_discount_amt"]
                           + j[f"{p}_ext_sales_price"]) / 2).to_numpy()
    j = _yoy_pair(t, amount("ss"), amount("ws"))
    out = pd.DataFrame({"web_sales_increase_ratio": j.web_ratio.to_numpy(),
                        "c_customer_sk": _int(j.c_customer_sk)})
    for c in ("c_first_name", "c_last_name", "c_preferred_cust_flag",
              "c_birth_country", "c_login", "c_email_address"):
        out[c] = j[c].to_numpy()
    out = _sorted(out, ["web_sales_increase_ratio", "c_customer_sk"],
                  [False, True])
    return out.head(100)


def _ref_q7(t):
    item = t["item"]
    avg = item.groupby("i_category").i_current_price.transform("mean")
    high = item.i_item_sk[item.i_current_price > avg * 1.2]
    july = _dates(t, lambda d: (d.d_year == 2004) & (d.d_moy == 7))
    ss = t["store_sales"]
    ss = ss[ss.ss_sold_date_sk.isin(july) & ss.ss_item_sk.isin(high)
            & ss.ss_customer_sk.notna()]
    ca = _notna(t["customer_address"][["ca_address_sk", "ca_state"]],
                "ca_state")
    c = t["customer"][["c_customer_sk", "c_current_addr_sk"]]
    j = (ca.merge(c, left_on="ca_address_sk", right_on="c_current_addr_sk")
         .merge(pd.DataFrame({"k": _int(ss.ss_customer_sk)}),
                left_on="c_customer_sk", right_on="k"))
    g = j.groupby("ca_state").size().rename("cnt").reset_index()
    g["cnt"] = g.cnt.astype(np.int64)
    g = g[g.cnt >= 10]
    return _sorted(g, ["cnt", "ca_state"], [False, True]).head(10)


def _ref_q9(t):
    y2001 = _dates(t, lambda d: d.d_year == 2001)
    ss = t["store_sales"]
    ss = ss[ss.ss_sold_date_sk.isin(y2001)
            & ss.ss_store_sk.isin(t["store"].s_store_sk)]
    ca = t["customer_address"][["ca_address_sk", "ca_state", "ca_country"]]
    cd = t["customer_demographics"][["cd_demo_sk", "cd_marital_status",
                                     "cd_education_status"]]
    j = (ss[["ss_addr_sk", "ss_cdemo_sk", "ss_quantity", "ss_sales_price",
             "ss_net_profit"]]
         .merge(ca, left_on="ss_addr_sk", right_on="ca_address_sk")
         .merge(cd, left_on="ss_cdemo_sk", right_on="cd_demo_sk"))
    sp, prof = j.ss_sales_price, j.ss_net_profit
    demo = ((j.cd_marital_status == "M")
            & (j.cd_education_status == "4 yr Degree")
            & (sp.between(100, 150) | sp.between(50, 200)
               | sp.between(150, 200)))
    st = j.ca_state
    geo = ((j.ca_country == "United States")
           & ((st.isin(["KY", "GA", "NM"]) & prof.between(0, 2000))
              | (st.isin(["MT", "OR", "IN"]) & prof.between(150, 3000))
              | (st.isin(["WI", "MO", "WV"]) & prof.between(50, 25000))))
    q = j.ss_quantity[demo & geo]
    return pd.DataFrame({"sum_qty": pd.array(
        [int(q.astype(np.int64).sum()) if len(q) else None],
        dtype="Int64")})


def _ref_q11(t):
    pr = _notna(t["product_reviews"], "pr_item_sk")
    pr = pr.groupby("pr_item_sk").agg(
        r_count=("pr_review_rating", "size"),
        avg_rating=("pr_review_rating", "mean")).reset_index()
    lo, hi = _sk(2003, 1, 2), _sk(2003, 2, 2)
    ws = _notna(t["web_sales"], "ws_item_sk")
    ws = ws[ws.ws_sold_date_sk.isin(t["date_dim"].d_date_sk)
            & ws.ws_sold_date_sk.between(lo, hi)]
    items = ws.ws_item_sk.unique()
    j = pr[pr.pr_item_sk.isin(items)]
    x = j.r_count.to_numpy(np.float64)
    y = j.avg_rating.to_numpy(np.float64)
    corr = None
    if len(x) > 1 and x.std() > 0 and y.std() > 0:
        corr = float(np.corrcoef(x, y)[0, 1])
    return pd.DataFrame({"correlation": _nullable_float(corr)})


def _ref_q12(t):
    books = t["item"].i_item_sk[t["item"].i_category.isin(
        ["Books", "Electronics"])]
    w = t["web_clickstreams"]
    w = w[w.wcs_click_date_sk.between(37134, 37134 + 30)
          & w.wcs_user_sk.notna() & w.wcs_sales_sk.isna()
          & w.wcs_item_sk.isin(books)]
    s = t["store_sales"]
    s = s[s.ss_sold_date_sk.between(37134, 37134 + 90)
          & s.ss_customer_sk.notna() & s.ss_item_sk.isin(books)]
    web = pd.DataFrame({"u": _int(w.wcs_user_sk),
                        "click": _int(w.wcs_click_date_sk)})
    store = pd.DataFrame({"u": _int(s.ss_customer_sk),
                          "sold": _int(s.ss_sold_date_sk)})
    # the earliest click against the latest sale of each user decides
    j = (web.groupby("u").click.min().reset_index()
         .merge(store.groupby("u").sold.max().reset_index(), on="u"))
    users = np.sort(j.u[j.click < j.sold].to_numpy())
    return pd.DataFrame({"wcs_user_sk": users.astype(np.int64)})


def _ref_q13(t):
    def amount(p):
        return lambda j: j[f"{p}_net_paid"].to_numpy()
    j = _yoy_pair(t, amount("ss"), amount("ws"))
    out = pd.DataFrame({"c_customer_sk": _int(j.c_customer_sk),
                        "c_first_name": j.c_first_name.to_numpy(),
                        "c_last_name": j.c_last_name.to_numpy(),
                        "storeSalesIncreaseRatio": j.store_ratio.to_numpy(),
                        "webSalesIncreaseRatio": j.web_ratio.to_numpy()})
    out = _sorted(out, ["webSalesIncreaseRatio", "c_customer_sk"],
                  [False, True])
    return out.head(100)


def _ref_q14(t):
    hd = t["household_demographics"]
    hd = hd.hd_demo_sk[hd.hd_dep_count == 5]
    wp = t["web_page"]
    wp = wp.wp_web_page_sk[wp.wp_char_count.between(5000, 6000)]
    td = t["time_dim"]
    td = td[td.t_hour.isin([7, 8, 19, 20])][["t_time_sk", "t_hour"]]
    ws = t["web_sales"]
    ws = ws[ws.ws_ship_hdemo_sk.isin(hd) & ws.ws_web_page_sk.isin(wp)]
    j = ws[["ws_sold_time_sk"]].merge(td, left_on="ws_sold_time_sk",
                                      right_on="t_time_sk")
    if not len(j):
        return pd.DataFrame({"am_pm_ratio": [-1.0]})
    amc = int(j.t_hour.between(7, 8).sum())
    pmc = int(j.t_hour.between(19, 20).sum())
    return pd.DataFrame({"am_pm_ratio": [amc / pmc if pmc > 0 else -1.0]})


def _ref_q15(t):
    lo, hi = _sk(2001, 9, 2), _sk(2002, 9, 2)
    ss = t["store_sales"]
    ss = ss[(ss.ss_store_sk == 10) & ss.ss_sold_date_sk.between(lo, hi)]
    item = _notna(t["item"], "i_category_id")[["i_item_sk",
                                               "i_category_id"]]
    j = ss[["ss_item_sk", "ss_sold_date_sk", "ss_net_paid"]].merge(
        item, left_on="ss_item_sk", right_on="i_item_sk")
    daily = (j.groupby(["i_category_id", "ss_sold_date_sk"])
             .ss_net_paid.sum().reset_index())
    x = _int(daily.ss_sold_date_sk)
    y = daily.ss_net_paid.to_numpy()
    d = pd.DataFrame({"cat": daily.i_category_id.to_numpy(np.int32), "x": x,
                      "y": y, "xy": x * y, "xx": x * x})
    g = d.groupby("cat").agg(n=("x", "size"), sx=("x", "sum"),
                             sy=("y", "sum"), sxy=("xy", "sum"),
                             sxx=("xx", "sum")).reset_index()
    n = g.n.to_numpy(np.int64)
    sx, sxx = g.sx.to_numpy(np.int64), g.sxx.to_numpy(np.int64)
    den = (n * sxx - sx * sx).astype(np.float64)
    num = n * g.sxy.to_numpy() - sx * g.sy.to_numpy()
    slope = np.where(den != 0, num / np.where(den != 0, den, 1.0), np.nan)
    intercept = (g.sy.to_numpy() - slope * sx) / n
    out = pd.DataFrame({"cat": g.cat.to_numpy(np.int32),
                        "slope": slope, "intercept": intercept})
    return out[out.slope <= 0].sort_values("cat").reset_index(drop=True)


def _ref_q16(t):
    pivot = _sk(2001, 3, 16)
    ws = t["web_sales"]
    ws = ws[ws.ws_sold_date_sk.between(pivot - 30, pivot + 30)
            & ws.ws_sold_date_sk.isin(t["date_dim"].d_date_sk)]
    wr = t["web_returns"][["wr_order_number", "wr_item_sk",
                           "wr_refunded_cash"]]
    j = (ws[["ws_item_sk", "ws_order_number", "ws_warehouse_sk",
             "ws_sold_date_sk", "ws_sales_price"]]
         .merge(wr, how="left", left_on=["ws_order_number", "ws_item_sk"],
                right_on=["wr_order_number", "wr_item_sk"])
         .merge(t["item"][["i_item_sk", "i_item_id"]],
                left_on="ws_item_sk", right_on="i_item_sk")
         .merge(t["warehouse"][["w_warehouse_sk", "w_state"]],
                left_on="ws_warehouse_sk", right_on="w_warehouse_sk"))
    net = j.ws_sales_price - j.wr_refunded_cash.fillna(0.0)
    before = j.ws_sold_date_sk < pivot
    g = pd.DataFrame({"w_state": j.w_state, "i_item_id": j.i_item_id,
                      "sales_before": np.where(before, net, 0.0),
                      "sales_after": np.where(before, 0.0, net)})
    g = g.groupby(["w_state", "i_item_id"], as_index=False).sum()
    return _sorted(g, ["w_state", "i_item_id"], [True, True]).head(100)


def _ref_q17(t):
    dec = _dates(t, lambda d: (d.d_year == 2001) & (d.d_moy == 12))
    item = t["item"].i_item_sk[t["item"].i_category.isin(["Books",
                                                          "Music"])]
    st = t["store"].s_store_sk[t["store"].s_gmt_offset == -5.0]
    ca = t["customer_address"]
    ca = ca.ca_address_sk[ca.ca_gmt_offset == -5.0]
    c = t["customer"]
    tz = c.c_customer_sk[c.c_current_addr_sk.isin(ca)]
    ss = t["store_sales"]
    ss = ss[ss.ss_sold_date_sk.isin(dec) & ss.ss_item_sk.isin(item)
            & ss.ss_store_sk.isin(st)
            & ss.ss_customer_sk.isin(tz).fillna(False).astype(bool)]
    j = ss[["ss_promo_sk", "ss_ext_sales_price"]].merge(
        t["promotion"], left_on="ss_promo_sk", right_on="p_promo_sk")
    if not len(j):
        return pd.DataFrame({"promotional": _nullable_float(None),
                             "total": _nullable_float(None),
                             "promo_percent": [0.0]})
    per = (j.groupby(["p_channel_email", "p_channel_dmail", "p_channel_tv"])
           .ss_ext_sales_price.sum().reset_index())
    promo = ((per.p_channel_dmail == "Y") | (per.p_channel_email == "Y")
             | (per.p_channel_tv == "Y"))
    promotional = float(np.where(promo, per.ss_ext_sales_price, 0.0).sum())
    total = float(per.ss_ext_sales_price.sum())
    pct = 100 * promotional / total if total > 0 else 0.0
    return pd.DataFrame({"promotional": [promotional], "total": [total],
                         "promo_percent": [pct]})


def _round_half_up(x: np.ndarray, scale: int) -> np.ndarray:
    p = float(10.0 ** scale)
    y = np.floor(np.abs(x) * p + 0.5) / p
    return np.where(x < 0, -y, y)


def _ref_q20(t):
    ss = t["store_sales"]
    orders = (ss.groupby("ss_customer_sk", dropna=False)
              .agg(orders_count=("ss_ticket_number", "nunique"),
                   orders_items=("ss_item_sk", "count"),
                   orders_money=("ss_net_paid", "sum")).reset_index())
    sr = t["store_returns"]
    returned = (sr.groupby("sr_customer_sk")
                .agg(returns_count=("sr_ticket_number", "nunique"),
                     returns_items=("sr_item_sk", "count"),
                     returns_money=("sr_return_amt", "sum")).reset_index())
    key = orders.ss_customer_sk.astype("Int64")
    j = orders.assign(k=key.fillna(-1).astype(np.int64)).merge(
        returned.assign(k=returned.sr_customer_sk.astype(np.int64)),
        how="left", on="k")
    j.loc[key.isna().to_numpy(), ["returns_count", "returns_items",
                                  "returns_money"]] = np.nan

    def ratio(num, den):
        n = j[num].to_numpy(np.float64)
        d = j[den].to_numpy(np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            r = np.where(d != 0, n / np.where(d != 0, d, 1.0), np.nan)
        return np.nan_to_num(r, nan=0.0)

    raw = {"orderRatio": ratio("returns_count", "orders_count"),
           "itemsRatio": ratio("returns_items", "orders_items"),
           "monetaryRatio": ratio("returns_money", "orders_money")}
    out = pd.DataFrame({"user_sk": key.to_numpy()})
    for c, r in raw.items():
        out[c] = _round_half_up(r, ROUNDED["q20"][c])
    out["frequency"] = _round_half_up(np.nan_to_num(
        j.returns_count.to_numpy(np.float64), nan=0.0), 0)
    for c, r in raw.items():
        out[RAW + c] = r
    out["user_sk"] = out.user_sk.astype("Int64")
    return out.sort_values("user_sk", na_position="first",
                           kind="stable").reset_index(drop=True)


def _ref_q21(t):
    def days(cond):
        return _dates(t, cond)
    d1 = days(lambda d: (d.d_year == 2003) & (d.d_moy == 1))
    d2 = days(lambda d: (d.d_year == 2003) & d.d_moy.between(1, 7))
    d3 = days(lambda d: d.d_year.between(2003, 2005))
    sr = t["store_returns"]
    sr = sr[sr.sr_returned_date_sk.isin(d2)]
    ws = t["web_sales"]
    ws = ws[ws.ws_sold_date_sk.isin(d3)][["ws_item_sk",
                                          "ws_bill_customer_sk",
                                          "ws_quantity"]]
    ss = _notna(t["store_sales"], "ss_customer_sk")
    ss = ss[ss.ss_sold_date_sk.isin(d1)][["ss_item_sk", "ss_store_sk",
                                          "ss_customer_sk",
                                          "ss_ticket_number", "ss_quantity"]]
    ss = ss.assign(ss_customer_sk=_int(ss.ss_customer_sk))
    j = (sr[["sr_item_sk", "sr_customer_sk", "sr_ticket_number",
             "sr_return_quantity"]]
         .merge(ws, left_on=["sr_item_sk", "sr_customer_sk"],
                right_on=["ws_item_sk", "ws_bill_customer_sk"])
         .merge(ss, left_on=["sr_ticket_number", "sr_item_sk",
                             "sr_customer_sk"],
                right_on=["ss_ticket_number", "ss_item_sk",
                          "ss_customer_sk"])
         .merge(t["store"][["s_store_sk", "s_store_id", "s_store_name"]],
                left_on="ss_store_sk", right_on="s_store_sk")
         .merge(t["item"][["i_item_sk", "i_item_id", "i_item_desc"]],
                left_on="sr_item_sk", right_on="i_item_sk"))
    keys = ["i_item_id", "i_item_desc", "s_store_id", "s_store_name"]
    g = j.groupby(keys).agg(
        store_sales_quantity=("ss_quantity", "sum"),
        store_returns_quantity=("sr_return_quantity", "sum"),
        web_sales_quantity=("ws_quantity", "sum")).reset_index()
    for c in ("store_sales_quantity", "store_returns_quantity",
              "web_sales_quantity"):
        g[c] = g[c].astype(np.int64)
    return _sorted(g, keys, [True] * 4).head(100)


def _ref_q22(t):
    pivot = _sk(2001, 5, 8)
    inv = t["inventory"]
    inv = inv[inv.inv_date_sk.between(pivot - 30, pivot + 30)
              & inv.inv_date_sk.isin(t["date_dim"].d_date_sk)]
    item = t["item"]
    item = item[item.i_current_price.between(0.98, 1.5)][["i_item_sk",
                                                          "i_item_id"]]
    j = (inv.merge(item, left_on="inv_item_sk", right_on="i_item_sk")
         .merge(t["warehouse"][["w_warehouse_sk", "w_warehouse_name"]],
                left_on="inv_warehouse_sk", right_on="w_warehouse_sk"))
    qty = j.inv_quantity_on_hand.to_numpy(np.int64)
    before = j.inv_date_sk < pivot
    g = pd.DataFrame({"w_warehouse_name": j.w_warehouse_name,
                      "i_item_id": j.i_item_id,
                      "inv_before": np.where(before, qty, 0),
                      "inv_after": np.where(before, 0, qty)})
    g = g.groupby(["w_warehouse_name", "i_item_id"], as_index=False).sum()
    ratio = g.inv_after / g.inv_before.where(g.inv_before != 0)
    g = g[(g.inv_before > 0) & (ratio >= 2.0 / 3.0) & (ratio <= 3.0 / 2.0)]
    g = _sorted(g, ["w_warehouse_name", "i_item_id"], [True, True])
    return g.head(100).reset_index(drop=True)


def _ref_q23(t):
    dd = t["date_dim"]
    dd = dd[(dd.d_year == 2001) & dd.d_moy.between(1, 2)][["d_date_sk",
                                                           "d_moy"]]
    j = t["inventory"].merge(dd, left_on="inv_date_sk",
                             right_on="d_date_sk")
    g = (j.groupby(["inv_warehouse_sk", "inv_item_sk", "d_moy"])
         .inv_quantity_on_hand.agg(["std", "mean"]).reset_index())
    g = g[(g["mean"] > 0) & (g["std"] / g["mean"] >= 1.3)]
    g = g.assign(cov=g["std"] / g["mean"])
    m1 = g[g.d_moy == 1]
    m2 = g[g.d_moy == 2]
    out = m1.merge(m2, on=["inv_warehouse_sk", "inv_item_sk"],
                   suffixes=("_1", "_2"))
    res = pd.DataFrame({
        "inv_warehouse_sk": _int(out.inv_warehouse_sk),
        "inv_item_sk": _int(out.inv_item_sk),
        "d_moy_1": out.d_moy_1.to_numpy(np.int32),
        "cov_1": out.cov_1.to_numpy(),
        "d_moy_2": out.d_moy_2.to_numpy(np.int32),
        "cov_2": out.cov_2.to_numpy()})
    return _sorted(res, ["inv_warehouse_sk", "inv_item_sk"], [True, True])


def _ref_q24(t):
    from spark_rapids_tpu_torch.models.tpcxbb import Q24_ITEM_SK
    item = t["item"]
    item = item[item.i_item_sk == Q24_ITEM_SK][["i_item_sk",
                                                "i_current_price"]]
    comp = item.merge(t["item_marketprices"], left_on="i_item_sk",
                      right_on="imp_item_sk")
    comp = pd.DataFrame({
        "i_item_sk": _int(comp.i_item_sk), "imp_sk": _int(comp.imp_sk),
        "price_change": ((comp.imp_competitor_price - comp.i_current_price)
                         / comp.i_current_price).to_numpy(),
        "start": _int(comp.imp_start_date),
        "ndays": _int(comp.imp_end_date - comp.imp_start_date)})

    def windowed(sales, item_col, date_col, qty_col):
        s = sales[[item_col, date_col, qty_col]]
        s = s[s[item_col] == Q24_ITEM_SK]
        j = s.merge(comp, left_on=item_col, right_on="i_item_sk")
        d, st, nd = _int(j[date_col]), j.start.to_numpy(), j.ndays.to_numpy()
        q = j[qty_col].to_numpy(np.int64)
        cur = np.where((d >= st) & (d < st + nd), q, 0)
        prev = np.where((d >= st - nd) & (d < st), q, 0)
        g = pd.DataFrame({"item": _int(j[item_col]), "imp_sk": j.imp_sk,
                          "price_change": j.price_change, "cur": cur,
                          "prev": prev})
        return g.groupby(["item", "imp_sk", "price_change"],
                         as_index=False).sum()

    wsq = windowed(t["web_sales"], "ws_item_sk", "ws_sold_date_sk",
                   "ws_quantity")
    ssq = windowed(t["store_sales"], "ss_item_sk", "ss_sold_date_sk",
                   "ss_quantity")
    j = wsq.merge(ssq, on=["item", "imp_sk"], suffixes=("_w", "_s"))
    num = (j.cur_s + j.cur_w - j.prev_s - j.prev_w).to_numpy(np.float64)
    den = (j.prev_s + j.prev_w).to_numpy(np.float64) * \
        j.price_change_w.to_numpy()
    with np.errstate(divide="ignore", invalid="ignore"):
        e = np.where(den != 0, num / np.where(den != 0, den, 1.0), np.nan)
    g = pd.DataFrame({"ws_item_sk": _int(j["item"]), "e": e})
    out = g.groupby("ws_item_sk").e.mean().reset_index()
    return pd.DataFrame({
        "ws_item_sk": _int(out.ws_item_sk),
        "cross_price_elasticity": pd.array(
            [None if np.isnan(v) else v for v in out.e], dtype="Float64")})


def _ref_q25(t):
    cutoff = _sk(2002, 1, 2)

    def per_customer(df, cust, date, ticket, paid):
        df = _notna(df, cust)
        df = df[df[date] > cutoff]
        return pd.DataFrame({
            "cid": _int(df[cust]), "ticket": _int(df[ticket]),
            "date": _int(df[date]), "paid": df[paid].to_numpy()}).groupby(
                "cid").agg(frequency=("ticket", "nunique"),
                           most_recent_date=("date", "max"),
                           amount=("paid", "sum")).reset_index()

    u = pd.concat([
        per_customer(t["store_sales"], "ss_customer_sk", "ss_sold_date_sk",
                     "ss_ticket_number", "ss_net_paid"),
        per_customer(t["web_sales"], "ws_bill_customer_sk",
                     "ws_sold_date_sk", "ws_order_number", "ws_net_paid")])
    g = u.groupby("cid").agg(recent=("most_recent_date", "max"),
                             frequency=("frequency", "sum"),
                             totalspend=("amount", "sum")).reset_index()
    return pd.DataFrame({
        "cid": _int(g.cid),
        "recency": np.where(37621 - g.recent < 60, 1.0, 0.0),
        "frequency": _int(g.frequency),
        "totalspend": g.totalspend.to_numpy()})


def _ref_q26(t):
    item = t["item"]
    item = item[item.i_category == "Books"][["i_item_sk", "i_class_id"]]
    ss = _notna(t["store_sales"], "ss_customer_sk")[["ss_customer_sk",
                                                      "ss_item_sk"]]
    j = ss.merge(item, left_on="ss_item_sk", right_on="i_item_sk")
    g = pd.DataFrame({"cid": _int(j.ss_customer_sk)})
    for i in range(1, 16):
        g[f"id{i}"] = (j.i_class_id == i).to_numpy(np.int64)
    g["total_cnt"] = np.int64(1)
    g = g.groupby("cid", as_index=False).sum()
    g = g[g.total_cnt > 5]
    return g[["cid"] + [f"id{i}" for i in range(1, 16)]].sort_values(
        "cid").reset_index(drop=True)


def _ref_q28(t):
    pr = t["product_reviews"]
    sk = _int(pr.pr_review_sk)
    out = pd.DataFrame({
        "split": np.where(sk % 10 != 0, "train", "test").astype(object),
        "pr_review_sk": sk,
        "pr_rating": pr.pr_review_rating.to_numpy(np.int32),
        "pr_review_content": pr.pr_review_content.to_numpy()})
    return _sorted(out, ["split", "pr_review_sk"], [True, True])


PANDAS_REFERENCES = {
    "q5": _ref_q5, "q6": _ref_q6, "q7": _ref_q7, "q9": _ref_q9,
    "q11": _ref_q11, "q12": _ref_q12, "q13": _ref_q13, "q14": _ref_q14,
    "q15": _ref_q15, "q16": _ref_q16, "q17": _ref_q17, "q20": _ref_q20,
    "q21": _ref_q21, "q22": _ref_q22, "q23": _ref_q23, "q24": _ref_q24,
    "q25": _ref_q25, "q26": _ref_q26, "q28": _ref_q28,
}


def pandas_reference(qname: str, frames: dict) -> pd.DataFrame:
    """The answer of TPCxBB ``qname`` over ``frames`` (those of
    ``query_frames``), by pandas, with the unrounded values of its
    rounded columns (``ROUNDED``) beside them for ``same_answer``."""
    return PANDAS_REFERENCES[qname](frames)

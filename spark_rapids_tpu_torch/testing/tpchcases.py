"""TPC-H answers as the port's tests and ``chip_smoke.py`` check them: each
query's sort columns, the row comparison, pandas references, and the
frame changes that make Q11, Q20 and Q22 return rows (the generators'
rows give Q20 and Q22 none at any scale factor, and Q11 none from about
SF 1 up, as its fraction 0.0001 is not divided by the scale factor):

  * Q11: ``q11_partsupp`` adds to partsupp, for part 1 and the GERMANY
    supplier of lowest key, enough rows of value 9999 x 1000.0 that the
    part's value passes 0.0001 of the total;

  * Q20: partsupp and lineitem draw their (part, supplier) pairs
    independently, so ``q20_partsupp`` adds one partsupp row
    (availability 9999, cost 1.0) for each distinct (l_partkey,
    l_suppkey) pair of a 1994 line of a "forest" part with a CANADA
    supplier;
  * Q22: every customer has about ten orders, so ``q22_orders`` drops the
    orders of the five customers of lowest key whose c_phone code is in
    the query's list and whose balance is above the query's average.
"""

from __future__ import annotations

import numpy as np
import pandas as pd

F64_RTOL = 1e-9

# each query's sort columns (None: one row)
ORDERS = {"q2": ["s_acctbal", "n_name", "s_name", "p_partkey"],
          "q5": ["revenue"], "q7": ["supp_nation", "cust_nation", "l_year"],
          "q8": ["o_year"], "q9": ["n_name", "o_year"],
          "q11": ["value", "ps_partkey"], "q12": ["l_shipmode"],
          "q13": ["custdist", "c_count"], "q14": None, "q15": ["s_suppkey"],
          "q16": ["supplier_cnt", "p_brand", "p_type", "p_size"],
          "q19": None, "q20": ["s_name"], "q22": ["cntrycode"]}
Q22_CODES = ["13", "31", "23", "29", "30", "18", "17"]


def q11_partsupp(fr: dict) -> pd.DataFrame:
    """partsupp with rows that put part 1 above Q11's threshold."""
    n, s, ps = fr["nation"], fr["supplier"], fr["partsupp"]
    germany = s.s_suppkey[s.s_nationkey.isin(
        n.n_nationkey[n.n_name == "GERMANY"])]
    if not len(germany):
        return ps
    total = (ps.ps_supplycost * ps.ps_availqty)[
        ps.ps_suppkey.isin(germany)].sum()
    value = 9999 * 1000.0
    k = int(2e-4 * total // value) + 1
    extra = pd.DataFrame({
        "ps_partkey": np.ones(k, np.int64),
        "ps_suppkey": np.full(k, int(germany.min()), np.int64),
        "ps_availqty": np.full(k, 9999, np.int32),
        "ps_supplycost": np.full(k, 1000.0)})
    return pd.concat([ps, extra], ignore_index=True)


def q20_partsupp(fr: dict) -> pd.DataFrame:
    """partsupp with a row for each (part, supplier) pair of a 1994 line
    of a "forest" part and a CANADA supplier."""
    n, s, p, li = fr["nation"], fr["supplier"], fr["part"], fr["lineitem"]
    canada = s.s_suppkey[s.s_nationkey.isin(
        n.n_nationkey[n.n_name == "CANADA"])]
    forest = p.p_partkey[p.p_name.str.startswith("forest")]
    m = ((li.l_shipdate >= np.datetime64("1994-01-01"))
         & (li.l_shipdate < np.datetime64("1995-01-01"))
         & li.l_partkey.isin(forest) & li.l_suppkey.isin(canada))
    pairs = li.loc[m, ["l_partkey", "l_suppkey"]].drop_duplicates()
    extra = pd.DataFrame({
        "ps_partkey": pairs.l_partkey.to_numpy(np.int64),
        "ps_suppkey": pairs.l_suppkey.to_numpy(np.int64),
        "ps_availqty": np.full(len(pairs), 9999, np.int32),
        "ps_supplycost": np.ones(len(pairs))})
    return pd.concat([fr["partsupp"], extra], ignore_index=True)


def q22_orders(fr: dict, count: int = 5) -> pd.DataFrame:
    """orders without the orders of the ``count`` customers of lowest key
    whose phone code is in Q22's list and whose balance is above Q22's
    average."""
    c, o = fr["customer"], fr["orders"]
    cand = c[c.c_phone.str[:2].isin(Q22_CODES)]
    avg = cand.c_acctbal[cand.c_acctbal > 0].mean()
    keys = cand.c_custkey[cand.c_acctbal > avg].sort_values()[:count]
    return o[~o.o_custkey.isin(keys)].reset_index(drop=True)


def query_frames(qname: str, frames: dict) -> dict:
    """``frames`` with the change ``qname`` needs (Q11, Q20, Q22), if
    any."""
    fr = dict(frames)
    if qname == "q11":
        fr["partsupp"] = q11_partsupp(fr)
    if qname == "q20":
        fr["partsupp"] = q20_partsupp(fr)
    if qname == "q22":
        fr["orders"] = q22_orders(fr)
    return fr


def in_query_order(df: pd.DataFrame, sort_cols) -> pd.DataFrame:
    """``df`` with the rows of each run tied on ``sort_cols`` (in the
    order they come) ordered by their other non-float columns, so that
    two answers compare row by row."""
    keyed = [c for c in df.columns if c not in sort_cols
             and not pd.api.types.is_float_dtype(df[c].dtype)]
    tie = df.groupby(sort_cols, sort=False, dropna=False).ngroup()
    keys = [df[c].astype(str).to_numpy() for c in reversed(keyed)]
    return df.iloc[np.lexsort(keys + [tie.to_numpy()])].reset_index(
        drop=True)


def same_rows(got, want):
    """Row by row: floats at rtol 1e-9, the rest exact."""
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    for c in got.columns:
        g, w = got[c], want[c]
        if pd.api.types.is_float_dtype(w.dtype):
            np.testing.assert_allclose(g.to_numpy(np.float64),
                                       w.to_numpy(np.float64),
                                       rtol=F64_RTOL, err_msg=c)
        else:
            assert [str(x) for x in g] == [str(x) for x in w], c


# ---------------------------------------------------------------------------
# pandas references of the 14 queries of the expression and cross-join
# slice: each projects before it merges and filters the big tables by key
# first, so that SF10 runs in seconds
# ---------------------------------------------------------------------------

def _day(s: str):
    return np.datetime64(s)


def _revenue(df: pd.DataFrame) -> pd.Series:
    return df.l_extendedprice * (1 - df.l_discount)


def _sorted(df: pd.DataFrame, cols, ascending) -> pd.DataFrame:
    return df.sort_values(cols, ascending=ascending,
                          kind="stable").reset_index(drop=True)


def _ref_q2(t):
    europe = t["region"].r_regionkey[t["region"].r_name == "EUROPE"]
    n = t["nation"][t["nation"].n_regionkey.isin(europe)][
        ["n_nationkey", "n_name"]]
    s = t["supplier"][["s_suppkey", "s_name", "s_nationkey",
                       "s_acctbal"]].merge(n, left_on="s_nationkey",
                                           right_on="n_nationkey")
    p = t["part"]
    p = p[(p.p_size == 15) & p.p_type.str.endswith("BRASS")][
        ["p_partkey", "p_mfgr"]]
    ps = t["partsupp"]
    ps = ps[ps.ps_partkey.isin(p.p_partkey)][
        ["ps_partkey", "ps_suppkey", "ps_supplycost"]]
    m = (ps.merge(s, left_on="ps_suppkey", right_on="s_suppkey")
         .merge(p, left_on="ps_partkey", right_on="p_partkey"))
    low = m.groupby("p_partkey").ps_supplycost.min()
    m = m[m.ps_supplycost == m.p_partkey.map(low)]
    out = m[["s_acctbal", "s_name", "n_name", "p_partkey", "p_mfgr"]]
    return _sorted(out, ["s_acctbal", "n_name", "s_name", "p_partkey"],
                   [False, True, True, True]).head(100)


def _ref_q5(t):
    o = t["orders"]
    o = o[(o.o_orderdate >= _day("1994-01-01"))
          & (o.o_orderdate < _day("1995-01-01"))][["o_orderkey",
                                                    "o_custkey"]]
    asia = t["region"].r_regionkey[t["region"].r_name == "ASIA"]
    n = t["nation"][t["nation"].n_regionkey.isin(asia)][
        ["n_nationkey", "n_name"]]
    c = t["customer"][["c_custkey", "c_nationkey"]].merge(
        n, left_on="c_nationkey", right_on="n_nationkey")
    co = c.merge(o, left_on="c_custkey", right_on="o_custkey")[
        ["o_orderkey", "n_nationkey", "n_name"]]
    li = t["lineitem"]
    li = li[li.l_orderkey.isin(co.o_orderkey)][
        ["l_orderkey", "l_suppkey", "l_extendedprice", "l_discount"]]
    j = (li.merge(co, left_on="l_orderkey", right_on="o_orderkey")
         .merge(t["supplier"][["s_suppkey", "s_nationkey"]],
                left_on=["l_suppkey", "n_nationkey"],
                right_on=["s_suppkey", "s_nationkey"]))
    g = (j.assign(revenue=_revenue(j))
         .groupby("n_name", as_index=False).revenue.sum())
    return _sorted(g, ["revenue"], [False])


def _ref_q7(t):
    li = t["lineitem"]
    li = li[(li.l_shipdate >= _day("1995-01-01"))
            & (li.l_shipdate <= _day("1996-12-31"))][
        ["l_orderkey", "l_suppkey", "l_shipdate", "l_extendedprice",
         "l_discount"]]
    n = t["nation"]
    fg = n[n.n_name.isin(["FRANCE", "GERMANY"])][["n_nationkey", "n_name"]]
    s = t["supplier"][["s_suppkey", "s_nationkey"]].merge(
        fg.rename(columns={"n_nationkey": "sn", "n_name": "supp_nation"}),
        left_on="s_nationkey", right_on="sn")
    c = t["customer"][["c_custkey", "c_nationkey"]].merge(
        fg.rename(columns={"n_nationkey": "cn", "n_name": "cust_nation"}),
        left_on="c_nationkey", right_on="cn")
    o = t["orders"][["o_orderkey", "o_custkey"]].merge(
        c, left_on="o_custkey", right_on="c_custkey")
    j = (li.merge(s, left_on="l_suppkey", right_on="s_suppkey")
         .merge(o, left_on="l_orderkey", right_on="o_orderkey"))
    j = j[j.supp_nation != j.cust_nation]
    j = j.assign(l_year=j.l_shipdate.dt.year.astype(np.int32),
                 revenue=_revenue(j))
    g = j.groupby(["supp_nation", "cust_nation", "l_year"],
                  as_index=False).revenue.sum()
    return _sorted(g, ["supp_nation", "cust_nation", "l_year"],
                   [True, True, True])


def _ref_q8(t):
    p = t["part"]
    pk = p.p_partkey[p.p_type == "ECONOMY ANODIZED STEEL"]
    o = t["orders"]
    o = o[(o.o_orderdate >= _day("1995-01-01"))
          & (o.o_orderdate <= _day("1996-12-31"))][
        ["o_orderkey", "o_custkey", "o_orderdate"]]
    n = t["nation"]
    america = t["region"].r_regionkey[t["region"].r_name == "AMERICA"]
    c = t["customer"]
    c = c[c.c_nationkey.isin(n.n_nationkey[n.n_regionkey.isin(america)])][
        ["c_custkey"]]
    li = t["lineitem"]
    li = li[li.l_partkey.isin(pk)][["l_orderkey", "l_suppkey",
                                    "l_extendedprice", "l_discount"]]
    j = (li.merge(o, left_on="l_orderkey", right_on="o_orderkey")
         .merge(c, left_on="o_custkey", right_on="c_custkey")
         .merge(t["supplier"][["s_suppkey", "s_nationkey"]],
                left_on="l_suppkey", right_on="s_suppkey")
         .merge(n[["n_nationkey", "n_name"]].rename(
             columns={"n_nationkey": "sk", "n_name": "supp_nation"}),
             left_on="s_nationkey", right_on="sk"))
    vol = _revenue(j)
    j = j.assign(vol=vol, brazil=vol.where(j.supp_nation == "BRAZIL", 0.0),
                 o_year=j.o_orderdate.dt.year.astype(np.int32))
    g = j.groupby("o_year", as_index=False).agg(
        brazil_vol=("brazil", "sum"), total_vol=("vol", "sum"))
    out = pd.DataFrame({"o_year": g.o_year,
                        "mkt_share": g.brazil_vol / g.total_vol})
    return _sorted(out, ["o_year"], [True])


def _ref_q9(t):
    p = t["part"]
    pk = p.p_partkey[p.p_name.str.contains("green", regex=False)]
    li = t["lineitem"]
    li = li[li.l_partkey.isin(pk)][
        ["l_orderkey", "l_partkey", "l_suppkey", "l_quantity",
         "l_extendedprice", "l_discount"]]
    ps = t["partsupp"]
    ps = ps[ps.ps_partkey.isin(pk)][["ps_partkey", "ps_suppkey",
                                     "ps_supplycost"]]
    j = (li.merge(t["supplier"][["s_suppkey", "s_nationkey"]],
                  left_on="l_suppkey", right_on="s_suppkey")
         .merge(ps, left_on=["l_suppkey", "l_partkey"],
                right_on=["ps_suppkey", "ps_partkey"])
         .merge(t["orders"][["o_orderkey", "o_orderdate"]],
                left_on="l_orderkey", right_on="o_orderkey")
         .merge(t["nation"][["n_nationkey", "n_name"]],
                left_on="s_nationkey", right_on="n_nationkey"))
    j = j.assign(o_year=j.o_orderdate.dt.year.astype(np.int32),
                 sum_profit=_revenue(j) - j.ps_supplycost * j.l_quantity)
    g = j.groupby(["n_name", "o_year"], as_index=False).sum_profit.sum()
    return _sorted(g, ["n_name", "o_year"], [True, False])


def _ref_q11(t):
    n, s = t["nation"], t["supplier"]
    de = s.s_suppkey[s.s_nationkey.isin(n.n_nationkey[n.n_name
                                                      == "GERMANY"])]
    ps = t["partsupp"]
    ps = ps[ps.ps_suppkey.isin(de)]
    value = ps.ps_supplycost * ps.ps_availqty
    per = value.groupby(ps.ps_partkey).sum()
    per = per[per > value.sum() * 0.0001]
    out = pd.DataFrame({"ps_partkey": per.index.to_numpy(),
                        "value": per.to_numpy()})
    return _sorted(out, ["value", "ps_partkey"], [False, True])


def _ref_q12(t):
    li = t["lineitem"]
    li = li[li.l_shipmode.isin(["MAIL", "SHIP"])
            & (li.l_commitdate < li.l_receiptdate)
            & (li.l_shipdate < li.l_commitdate)
            & (li.l_receiptdate >= _day("1994-01-01"))
            & (li.l_receiptdate < _day("1995-01-01"))][
        ["l_orderkey", "l_shipmode"]]
    j = t["orders"][["o_orderkey", "o_orderpriority"]].merge(
        li, left_on="o_orderkey", right_on="l_orderkey")
    high = j.o_orderpriority.isin(["1-URGENT", "2-HIGH"])
    g = (j.assign(h=high.astype(np.int64), lo=(~high).astype(np.int64))
         .groupby("l_shipmode", as_index=False)
         .agg(high_line_count=("h", "sum"), low_line_count=("lo", "sum")))
    return _sorted(g, ["l_shipmode"], [True])


def _ref_q13(t):
    o = t["orders"]
    com = o.o_comment
    o = o[~(com.str.contains("special", regex=False)
            & com.str.contains("requests", regex=False))]
    per = o.groupby("o_custkey").size()
    c_count = t["customer"].c_custkey.map(per).fillna(0).astype(np.int64)
    g = c_count.value_counts()
    out = pd.DataFrame({"c_count": g.index.to_numpy(np.int64),
                        "custdist": g.to_numpy(np.int64)})
    return _sorted(out, ["custdist", "c_count"], [False, False])


def _ref_q14(t):
    li = t["lineitem"]
    li = li[(li.l_shipdate >= _day("1995-09-01"))
            & (li.l_shipdate < _day("1995-10-01"))][
        ["l_partkey", "l_extendedprice", "l_discount"]]
    j = li.merge(t["part"][["p_partkey", "p_type"]], left_on="l_partkey",
                 right_on="p_partkey")
    rev = _revenue(j)
    promo = rev.where(j.p_type.str.startswith("PROMO"), 0.0)
    return pd.DataFrame({"promo_revenue": [100.0 * promo.sum()
                                           / rev.sum()]})


def _ref_q15(t):
    li = t["lineitem"]
    li = li[(li.l_shipdate >= _day("1996-01-01"))
            & (li.l_shipdate < _day("1996-04-01"))]
    rev = _revenue(li).groupby(li.l_suppkey).sum()
    top = rev[rev == rev.max()]
    s = t["supplier"]
    s = s[s.s_suppkey.isin(top.index)][["s_suppkey", "s_name"]]
    out = s.assign(total_revenue=s.s_suppkey.map(top).to_numpy())
    return _sorted(out, ["s_suppkey"], [True])


def _ref_q16(t):
    s = t["supplier"]
    bad = s.s_suppkey[s.s_comment.str.contains("Customer", regex=False)
                      & s.s_comment.str.contains("Complaints", regex=False)]
    p = t["part"]
    p = p[(p.p_brand != "Brand#45")
          & ~p.p_type.str.startswith("MEDIUM POLISHED")
          & p.p_size.isin([49, 14, 23, 45, 19, 3, 36, 9])][
        ["p_partkey", "p_brand", "p_type", "p_size"]]
    ps = t["partsupp"]
    ps = ps[~ps.ps_suppkey.isin(bad)][["ps_partkey", "ps_suppkey"]]
    j = ps.merge(p, left_on="ps_partkey", right_on="p_partkey")[
        ["p_brand", "p_type", "p_size", "ps_suppkey"]].drop_duplicates()
    g = (j.groupby(["p_brand", "p_type", "p_size"]).size()
         .rename("supplier_cnt").reset_index())
    return _sorted(g, ["supplier_cnt", "p_brand", "p_type", "p_size"],
                   [False, True, True, True])


def _ref_q19(t):
    li = t["lineitem"]
    li = li[li.l_shipmode.isin(["AIR", "REG AIR"])
            & (li.l_shipinstruct == "DELIVER IN PERSON")][
        ["l_partkey", "l_quantity", "l_extendedprice", "l_discount"]]
    j = li.merge(t["part"][["p_partkey", "p_brand", "p_container",
                            "p_size"]], left_on="l_partkey",
                 right_on="p_partkey")
    q, sz, b, c = j.l_quantity, j.p_size, j.p_brand, j.p_container
    cond = (((b == "Brand#12") & c.isin(["SM CASE", "SM BOX"])
             & (q >= 1) & (q <= 11) & (sz >= 1) & (sz <= 5))
            | ((b == "Brand#23") & c.isin(["MED BAG", "MED BOX"])
               & (q >= 10) & (q <= 20) & (sz >= 1) & (sz <= 10))
            | ((b == "Brand#34") & c.isin(["LG CASE", "LG BOX"])
               & (q >= 20) & (q <= 30) & (sz >= 1) & (sz <= 15)))
    rev = _revenue(j)[cond]
    return pd.DataFrame({"revenue": [rev.sum() if len(rev) else np.nan]})


def _ref_q20(t):
    p = t["part"]
    forest = p.p_partkey[p.p_name.str.startswith("forest")]
    li = t["lineitem"]
    li = li[(li.l_shipdate >= _day("1994-01-01"))
            & (li.l_shipdate < _day("1995-01-01"))
            & li.l_partkey.isin(forest)]
    half = (li.groupby(["l_partkey", "l_suppkey"]).l_quantity.sum() * 0.5
            ).rename("half_qty").reset_index()
    ps = t["partsupp"]
    ps = ps[ps.ps_partkey.isin(forest)]
    q = ps.merge(half, left_on=["ps_partkey", "ps_suppkey"],
                 right_on=["l_partkey", "l_suppkey"])
    q = q[q.ps_availqty > q.half_qty]
    n, s = t["nation"], t["supplier"]
    canada = n.n_nationkey[n.n_name == "CANADA"]
    s = s[s.s_suppkey.isin(q.ps_suppkey) & s.s_nationkey.isin(canada)]
    return _sorted(s[["s_name", "s_address"]], ["s_name"], [True])


def _ref_q22(t):
    c = t["customer"][["c_custkey", "c_phone", "c_acctbal"]]
    c = c.assign(cntrycode=c.c_phone.str[:2])
    c = c[c.cntrycode.isin(Q22_CODES)]
    avg = c.c_acctbal[c.c_acctbal > 0.0].mean()
    c = c[(c.c_acctbal > avg) & ~c.c_custkey.isin(t["orders"].o_custkey)]
    g = c.groupby("cntrycode", as_index=False).agg(
        numcust=("c_acctbal", "size"), totacctbal=("c_acctbal", "sum"))
    return _sorted(g, ["cntrycode"], [True])


PANDAS_REFERENCES = {
    "q2": _ref_q2, "q5": _ref_q5, "q7": _ref_q7, "q8": _ref_q8,
    "q9": _ref_q9, "q11": _ref_q11, "q12": _ref_q12, "q13": _ref_q13,
    "q14": _ref_q14, "q15": _ref_q15, "q16": _ref_q16, "q19": _ref_q19,
    "q20": _ref_q20, "q22": _ref_q22}


def pandas_reference(qname: str, frames: dict) -> pd.DataFrame:
    """Query ``qname``'s answer computed by pandas from ``frames`` (already
    changed by ``query_frames``), in the query's column order and sort
    order."""
    return PANDAS_REFERENCES[qname](frames)

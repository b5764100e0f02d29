"""Mortgage answers as the port's tests and ``chip_smoke.py`` check them: a
pandas reference for each of the four queries of ``models/mortgage.py``,
each query's key columns, and the row comparison.

The references follow the queries' SQL semantics, written straight from
what each query computes rather than from its plan:

  * ``etl``: each performance row's 12-month delinquency flag. The query
    expands every row into 12 (``month_y``) and groups the copies by loan
    and ``josh_mody_n = floor((months - 24000 - month_y) / 12)``, then
    joins the groups back on the (year, month) they map to. The reference
    walks the 12 values of ``month_y`` one at a time (``month_y`` is a
    group key, so no group spans two values, and host memory stays about
    1/12 of the expansion's), groups the rows by (loan, josh_mody_n) and
    looks each row's group up by its own month: the row's month and the
    11 that follow it. The loan's delinquency dates and flags are one
    group-by of the performance table; the seller names map through
    ``NAME_MAPPING``, an unmapped name staying as it is.
  * ``aggregates_with_join`` and ``aggregates_with_percentiles`` group by
    ``hash(loan_id)``, an int32 (``ops/hashing``'s numpy twins), so the
    reference groups the loans that share a hash as the query does (about
    a hundred pairs of the 1M loans at SF 500). ``first`` takes a group's
    first row in the acquisition table's order. A float max is NaN where
    a group holds a NaN (Spark orders NaN above every number).
  * The percentiles are the query's own interpolation, x[floor(pos)] *
    (1 - frac) + x[ceil(pos)] * frac with pos = 1 + p (n - 1), over each
    group's sorted rates. Every sum and average is rounded to 4 places,
    HALF_UP (Spark's ``round``, not pandas' half-to-even); where the
    unrounded value lies within the float tolerance of a half unit, the
    order of the adds decides the rounding, and either neighbour is right.

Answers compare row by row after a sort on each query's keys (``KEYS``,
unique in every answer): keys, counts, dates and strings exact, float64
at rtol 1e-9.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import pandas as pd

from spark_rapids_tpu_torch.models.mortgage import NAME_MAPPING
from spark_rapids_tpu_torch.ops import hashing

F64_RTOL = 1e-9

# each answer's unique key columns
KEYS = {
    "etl": ["loan_id", "monthly_reporting_period"],
    "simple_aggregates": ["zip", "monthval"],
    "aggregates_with_join": ["loan_id_hash"],
    "aggregates_with_percentiles": ["loan_id_hash"],
}

# the columns a query rounds (HALF_UP, to 4 places) from float sums
ROUNDED = {"aggregates_with_percentiles": [
    "interest_rate_min", "interest_rate_max", "interest_rate_avg",
    "interest_rate_50p", "interest_rate_75p", "interest_rate_90p",
    "interest_rate_99p"]}
RAW = "__raw_"
PERCENTILES = [("interest_rate_50p", 0.5), ("interest_rate_75p", 0.75),
               ("interest_rate_90p", 0.9), ("interest_rate_99p", 0.99)]


def loan_hash(loan_id: np.ndarray) -> np.ndarray:
    """hash(loan_id) as the query computes it: int32."""
    h = hashing.np_combine_hashes([hashing.np_hash_fixed_width(
        np.asarray(loan_id, np.int64), np.ones(len(loan_id), bool))])
    return np.asarray(h).astype(np.uint32).view(np.int32)


def _round_half_up(x: np.ndarray, scale: int = 4) -> np.ndarray:
    p = 10.0 ** scale
    y = np.floor(np.abs(x) * p + 0.5) / p
    return np.where(x < 0, -y, y)


def _months(period: pd.Series) -> np.ndarray:
    """year * 12 + month of a timestamp column."""
    p = pd.DatetimeIndex(period)
    return (p.year.to_numpy(np.int64) * 12 + p.month.to_numpy(np.int64))


def _group_max_nan(keys: np.ndarray, x: np.ndarray) -> pd.Series:
    """max by key with NaN greatest (Spark's order)."""
    df = pd.DataFrame({"k": keys, "x": x, "nan": np.isnan(x)})
    g = df.groupby("k", sort=False)
    out = g["x"].max()
    return out.where(~g["nan"].any(), np.nan)


def _group_min_nan(keys: np.ndarray, x: np.ndarray) -> pd.Series:
    """min by key with NaN greatest: NaN only where every value is."""
    return pd.DataFrame({"k": keys, "x": x}).groupby("k", sort=False)[
        "x"].min()


# ---------------------------------------------------------------------------
# the four references
# ---------------------------------------------------------------------------

def _ref_acquisition(acq: pd.DataFrame) -> pd.DataFrame:
    mapping = dict(NAME_MAPPING)
    raw = acq["seller_name"].astype(object)
    out = acq.drop(columns=["seller_name"]).copy()
    out["old_name"] = raw.to_numpy()
    out["seller_name"] = [mapping.get(v, v) if v is not None else None
                          for v in raw]
    return out


def _ref_etl(perf: pd.DataFrame, acq: pd.DataFrame) -> pd.DataFrame:
    period = perf["monthly_reporting_period"]
    pidx = pd.DatetimeIndex(period)
    loan = perf["loan_id"].to_numpy(np.int64)
    status = perf["current_loan_delinquency_status"].to_numpy(np.int64)
    upb = perf["current_actual_upb"].to_numpy(np.float64)
    rel = _months(period) - 24000
    n = len(perf)

    # the loan's delinquency dates and flags (one group a loan and quarter;
    # a loan has one quarter)
    lk = pd.DataFrame({"loan": loan, "q": perf["quarter"].to_numpy(object)})
    grp = lk.groupby(["loan", "q"], sort=False).ngroup().to_numpy()
    per_loan = pd.DataFrame({"g": grp, "status": status, "p": period})
    dmax = per_loan.groupby("g")["status"].max()
    dates = {}
    for name, th in (("delinquency_30", 1), ("delinquency_90", 3),
                     ("delinquency_180", 6)):
        dates[name] = per_loan.p.where(per_loan.status >= th).groupby(
            per_loan.g).min()

    # the 12-month flag: month_y = m holds the rows of each (loan,
    # josh_mody_n) group; a row looks up the group of its own month
    d12 = np.zeros(n, np.int64)
    u12 = np.zeros(n, np.float64)
    row_m = np.mod(rel, 12)
    row_j = np.floor_divide(rel, 12)
    for m in range(12):
        jm = np.floor_divide(rel - m, 12)
        key = loan * 4096 + (jm + 2048)
        agg = pd.DataFrame({"k": key, "s": status, "u": upb}).groupby(
            "k", sort=False).agg(s=("s", "max"), u=("u", "min"))
        tgt = np.flatnonzero(row_m == m)
        at = agg.index.get_indexer(loan[tgt] * 4096 + (row_j[tgt] + 2048))
        assert (at >= 0).all()
        d12[tgt] = agg["s"].to_numpy()[at]
        u12[tgt] = agg["u"].to_numpy()[at]

    out = pd.DataFrame({
        "loan_id": loan,
        "monthly_reporting_period": period.to_numpy(),
        "servicer": perf["servicer"].to_numpy(object),
        "interest_rate": perf["interest_rate"].to_numpy(np.float64),
        "current_actual_upb": upb,
        "loan_age": perf["loan_age"].to_numpy(np.float64),
        "current_loan_delinquency_status": status.astype(np.int32),
        "monthly_reporting_period_day": pidx.day.to_numpy(np.int32),
    })
    mx = dmax.to_numpy()[grp]
    out["ever_30"] = mx >= 1
    out["ever_90"] = mx >= 3
    out["ever_180"] = mx >= 6
    for name, s in dates.items():
        out[name] = s.to_numpy()[grp]
    out["upb_12"] = u12
    out["delinquency_12"] = ((d12 > 3).astype(np.int32)
                             + (u12 == 0).astype(np.int32))
    a = _ref_acquisition(acq)
    # the inner join on (loan_id, quarter): every performance row's loan
    # has its acquisition row, in the same quarter
    ai = pd.Index(a["loan_id"].to_numpy(np.int64)).get_indexer(loan)
    keep = ai >= 0
    keep &= (a["quarter"].to_numpy(object)[np.clip(ai, 0, None)]
             == perf["quarter"].to_numpy(object))
    out = out[keep].reset_index(drop=True)
    ai = ai[keep]
    for c in a.columns:
        if c not in ("loan_id", "quarter"):
            out[c] = a[c].to_numpy()[ai]
    return out


def _ref_simple_aggregates(perf: pd.DataFrame,
                           acq: pd.DataFrame) -> pd.DataFrame:
    monthval = pd.DatetimeIndex(perf["monthly_reporting_period"]).month
    mr = pd.DataFrame({"monthval": monthval.to_numpy(np.int32),
                       "loan_id": perf["loan_id"].to_numpy(np.int64),
                       "r": perf["interest_rate"].to_numpy(np.float64)})
    key = mr.loan_id * 16 + mr.monthval
    mx = _group_max_nan(key.to_numpy(), mr.r.to_numpy())
    loans = mx.index.to_numpy() // 16
    months = (mx.index.to_numpy() % 16).astype(np.int32)
    zips = pd.Series(acq["zip"].to_numpy(np.int32),
                     index=acq["loan_id"].to_numpy(np.int64))
    at = zips.index.get_indexer(loans)
    keep = at >= 0
    j = pd.DataFrame({"zip": zips.to_numpy()[at[keep]],
                      "monthval": months[keep],
                      "v": mx.to_numpy()[keep]})
    out = j.groupby(["zip", "monthval"], sort=False)["v"].min().rename(
        "min_max_monthly_rate").reset_index()
    return out


def _ref_aggregates_with_join(perf: pd.DataFrame,
                              acq: pd.DataFrame) -> pd.DataFrame:
    ph = loan_hash(perf["loan_id"].to_numpy())
    p = _group_min_nan(ph, perf["interest_rate"].to_numpy(np.float64))
    ah = loan_hash(acq["loan_id"].to_numpy())
    rate = acq["orig_interest_rate"].to_numpy(np.float64)
    first = pd.DataFrame({"k": ah, "r": rate}).groupby(
        "k", sort=False)["r"].first()
    max_dti = _group_max_nan(ah, acq["dti"].to_numpy(np.float64))
    out = pd.DataFrame({"loan_id_hash": p.index.to_numpy(np.int32),
                        "min_int_rate": p.to_numpy()})
    at = first.index.get_indexer(out.loan_id_hash)
    ok = at >= 0
    out["first_int_rate"] = pd.array(
        np.where(ok, first.to_numpy()[np.clip(at, 0, None)], np.nan),
        dtype="Float64")
    out.loc[~ok, "first_int_rate"] = pd.NA
    md = max_dti.reindex(out.loan_id_hash).to_numpy()
    out["max_dti"] = pd.array(md, dtype="Float64")
    out.loc[~ok, "max_dti"] = pd.NA
    return out


def _ref_aggregates_with_percentiles(perf: pd.DataFrame) -> pd.DataFrame:
    h = loan_hash(perf["loan_id"].to_numpy())
    x = perf["interest_rate"].to_numpy(np.float64)
    order = np.lexsort([x, h])
    hs, xs = h[order], x[order]
    starts = np.flatnonzero(np.r_[True, hs[1:] != hs[:-1]])
    counts = np.diff(np.r_[starts, len(hs)])
    keys = hs[starts]
    sums = np.add.reduceat(xs, starts)
    raw = {"interest_rate_min": xs[starts],
           "interest_rate_max": xs[starts + counts - 1],
           "interest_rate_avg": sums / counts}
    for name, p in PERCENTILES:
        pos = 1 + p * (counts - 1)
        lo = np.floor(pos).astype(np.int64)
        hi = np.ceil(pos).astype(np.int64)
        frac = pos - lo
        v = xs[starts + lo - 1] * (1.0 - frac)
        v = v + np.where(hi != lo, xs[starts + hi - 1] * frac, 0.0)
        raw[name] = v
    out = pd.DataFrame({"loan_id_hash": keys})
    for c in ROUNDED["aggregates_with_percentiles"]:
        out[c] = _round_half_up(raw[c])
        out[RAW + c] = raw[c]
    return out


def pandas_reference(name: str, perf: pd.DataFrame,
                     acq: pd.DataFrame) -> pd.DataFrame:
    """The answer of query ``name`` over the two pandas tables (rounded
    columns carry their unrounded values under ``RAW + column``)."""
    if name == "etl":
        return _ref_etl(perf, acq)
    if name == "simple_aggregates":
        return _ref_simple_aggregates(perf, acq)
    if name == "aggregates_with_join":
        return _ref_aggregates_with_join(perf, acq)
    if name == "aggregates_with_percentiles":
        return _ref_aggregates_with_percentiles(perf)
    raise KeyError(name)


# ---------------------------------------------------------------------------
# comparison
# ---------------------------------------------------------------------------

def _by_keys(df: pd.DataFrame, keys) -> pd.DataFrame:
    cols = []
    for k in reversed(keys):
        s = df[k]
        if pd.api.types.is_datetime64_any_dtype(s.dtype):
            cols.append(s.to_numpy("datetime64[us]").astype(np.int64))
        else:
            cols.append(s.to_numpy(np.int64))
    return df.iloc[np.lexsort(cols)].reset_index(drop=True)


def _floats(s: pd.Series) -> np.ndarray:
    return s.astype("Float64").to_numpy(np.float64, na_value=np.nan)


def _exact(s: pd.Series):
    """(values, null mask) for an exact comparison."""
    null = s.isna().to_numpy()
    if pd.api.types.is_datetime64_any_dtype(s.dtype):
        v = s.to_numpy("datetime64[us]").astype(np.int64)
    elif pd.api.types.is_bool_dtype(s.dtype) or pd.api.types.is_integer_dtype(
            s.dtype):
        v = s.to_numpy(np.int64, na_value=0)
    else:
        v = s.astype(object).to_numpy()
    v = v.copy()
    v[null] = 0 if v.dtype != object else None
    return v, null


def same_answer(name: str, got: pd.DataFrame, want: pd.DataFrame,
                rtol: float = F64_RTOL) -> Dict[str, float]:
    """Row by row after a sort on the query's keys: floats at ``rtol``
    (NULL equal to NULL; a rounded column may take either neighbour where
    the reference's unrounded value is a tie), the rest exact. Returns the
    largest relative float error and the tie count."""
    want = want.copy()
    raws = {c[len(RAW):]: want.pop(c) for c in list(want.columns)
            if c.startswith(RAW)}
    assert list(got.columns) == list(want.columns), (list(got.columns),
                                                     list(want.columns))
    assert len(got) == len(want), (len(got), len(want))
    keys = KEYS[name]
    order_w = _by_keys(want.assign(**{RAW + c: v for c, v in raws.items()}),
                       keys)
    raws = {c: _floats(order_w.pop(RAW + c)) for c in raws}
    want, got = order_w, _by_keys(got, keys)
    worst, ties = 0.0, 0
    for c in got.columns:
        g, w = got[c], want[c]
        if pd.api.types.is_float_dtype(w.dtype) or pd.api.types.is_float_dtype(
                g.dtype):
            gv, wv = _floats(g), _floats(w)
            if c in raws:
                x = np.abs(raws[c]) * 1e4
                tie = np.abs(x - np.floor(x) - 0.5) <= rtol * np.maximum(x, 1)
                assert (np.abs(gv[tie] - wv[tie]) <= 1e-4 * 1.000001).all(), c
                ties += int(tie.sum())
                gv, wv = gv[~tie], wv[~tie]
            np.testing.assert_allclose(gv, wv, rtol=rtol, err_msg=c,
                                       equal_nan=True)
            both = ~np.isnan(wv) & (wv != 0)
            if both.any():
                worst = max(worst, float(np.max(
                    np.abs(gv[both] - wv[both]) / np.abs(wv[both]))))
            continue
        gv, gn = _exact(g)
        wv, wn = _exact(w)
        assert (gn == wn).all(), f"null masks differ in {c!r}"
        bad = np.flatnonzero(gv != wv)
        assert len(bad) == 0, (c, bad[:5], gv[bad[:5]], wv[bad[:5]])
    return {"max_rel_err": worst, "rounding_ties": ties}

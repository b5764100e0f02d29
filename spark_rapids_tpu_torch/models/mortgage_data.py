"""Synthetic FannieMae-shaped mortgage data generator (a copy of the JAX
package's ``models/mortgage_data.py``: the same seeds, 211 and 223, and
``LOANS_PER_SF``, so both packages see the same tables).

The reference's Mortgage ETL reads the public FannieMae acquisition /
performance CSVs (integration_tests/.../mortgage/MortgageSpark.scala:34-118
declares the schemas). This generator produces statistically similar
tables in-memory: loans appearing across many monthly reporting periods
with escalating delinquency states, and acquisition rows with the messy
seller-name variants the ETL's name-normalization join cleans up.

Dates are generated as real date columns (the reference's to_date
"MM/dd/yyyy" parses exist only because the CSVs are stringly typed)."""

from __future__ import annotations

import numpy as np
import pandas as pd

LOANS_PER_SF = 2_000
MONTHS_PER_LOAN = 12

# raw seller spellings -> how often they appear; the ETL maps them to
# clean names via mortgage.NAME_MAPPING
RAW_SELLERS = [
    "WELLS FARGO BANK, N.A.", "WELLS FARGO BANK, NA",
    "JPMORGAN CHASE BANK, NA", "CHASE HOME FINANCE, LLC",
    "BANK OF AMERICA, N.A.", "QUICKEN LOANS INC.",
    "U.S. BANK N.A.", "FLAGSTAR BANK, FSB", "PNC BANK, N.A.",
    "SUNTRUST MORTGAGE INC.", "OTHER", "SOME UNMAPPED LENDER CO",
]

_Q_STARTS = pd.to_datetime(
    ["2007-01-01", "2007-04-01", "2007-07-01", "2007-10-01",
     "2008-01-01", "2008-04-01", "2008-07-01", "2008-10-01"])


def gen_acquisition(sf: float, seed: int = 211) -> pd.DataFrame:
    n = max(40, int(LOANS_PER_SF * sf))
    rng = np.random.default_rng(seed)
    qi = rng.integers(0, len(_Q_STARTS), n)
    orig = _Q_STARTS[qi] + pd.to_timedelta(rng.integers(0, 80, n), unit="D")
    return pd.DataFrame({
        "loan_id": np.arange(1, n + 1, dtype=np.int64),
        "quarter": np.asarray([f"2007Q{i % 4 + 1}" if i < 4
                               else f"2008Q{i % 4 + 1}"
                               for i in qi], dtype=object),
        "seller_name": np.asarray(RAW_SELLERS, dtype=object)[
            rng.integers(0, len(RAW_SELLERS), n)],
        "orig_interest_rate": np.round(rng.uniform(2.5, 7.5, n), 3),
        "orig_upb": rng.integers(50_000, 800_000, n).astype(np.int64),
        "orig_loan_term": rng.integers(120, 481, n).astype(np.int32),
        "orig_date": pd.Series(orig.values.astype("datetime64[s]")),
        "first_pay_date": pd.Series(
            (orig + pd.DateOffset(months=2)).values.astype("datetime64[s]")),
        "orig_ltv": np.round(rng.uniform(40.0, 97.0, n), 1),
        "dti": np.where(rng.random(n) < 0.05, np.nan,
                        np.round(rng.uniform(10.0, 60.0, n), 1)),
        "borrower_credit_score": rng.integers(550, 830, n).astype(np.float64),
        "zip": rng.integers(100, 999, n).astype(np.int32),
    })


def gen_performance(sf: float, seed: int = 223) -> pd.DataFrame:
    n_loans = max(40, int(LOANS_PER_SF * sf))
    rng = np.random.default_rng(seed)
    loan = np.repeat(np.arange(1, n_loans + 1, dtype=np.int64),
                     MONTHS_PER_LOAN)
    month_i = np.tile(np.arange(MONTHS_PER_LOAN), n_loans)
    acq = gen_acquisition(sf, seed=211)
    quarter = np.repeat(acq["quarter"].to_numpy(), MONTHS_PER_LOAN)
    base = np.repeat(acq["orig_date"].values.astype("datetime64[M]"),
                     MONTHS_PER_LOAN)
    period = (base + month_i.astype("timedelta64[M]")).astype("datetime64[s]")
    upb0 = np.repeat(acq["orig_upb"].to_numpy(), MONTHS_PER_LOAN)
    upb = np.maximum(upb0 - month_i * rng.integers(500, 3000, len(loan)),
                     0).astype(np.float64)
    # delinquency: mostly current, some loans spiral up over time
    spiral = np.repeat(rng.random(n_loans) < 0.15, MONTHS_PER_LOAN)
    status = np.where(spiral, np.minimum(month_i, 9),
                      (rng.random(len(loan)) < 0.05).astype(np.int64))
    return pd.DataFrame({
        "loan_id": loan,
        "quarter": quarter,
        "monthly_reporting_period": pd.Series(period),
        "servicer": np.asarray(RAW_SELLERS, dtype=object)[
            rng.integers(0, len(RAW_SELLERS), len(loan))],
        "interest_rate": np.round(
            np.repeat(acq["orig_interest_rate"].to_numpy(), MONTHS_PER_LOAN)
            + rng.normal(0, 0.05, len(loan)), 3),
        "current_actual_upb": upb,
        "loan_age": month_i.astype(np.float64),
        "current_loan_delinquency_status": status.astype(np.int32),
    })

"""Mortgage (FannieMae) ETL workload over the port's DataFrame API (a copy
of the JAX package's ``models/mortgage.py``, so both packages run the same
four queries; ``testing/mortgagecases.py`` holds a pandas reference for
each) — the reference's third benchmark harness
(integration_tests/.../mortgage/MortgageSpark.scala:213-421): seller-name
normalization, the 12-month delinquency windowing ETL, and the three
standalone aggregate benchmarks.

Notes of the JAX package's formulation:
- The reference's explode(lit(0..11)) month expansion becomes a broadcast
  cross join against a 12-row frame (same plan shape Spark produces, and
  the nested-loop join is device-resident here).
- loan anonymization uses the framework hash() (identical on CPU/TPU
  paths); the hex() rendering the reference applies on top is available
  but CPU-only, so the benchmarks group by the int32 hash directly.
- percentile() has no fixed-width sufficient statistics, so
  aggregates_with_percentiles computes exact interpolated percentiles with
  rank/count window functions — an all-device formulation.

The JAX package's ``bench.py`` runs the month expansion's cross join with
``spark.rapids.sql.exec.CartesianProductExec`` set (``ETL_CONFS``); the
port's cartesian rule is on by default, and the conf changes nothing.
"""

from __future__ import annotations

import pandas as pd

from spark_rapids_tpu_torch.sql import functions as F
from spark_rapids_tpu_torch.sql.window import Window

ETL_CONFS = {"spark.rapids.sql.exec.CartesianProductExec": True}

# the four queries by name: (fn, needs the acquisition table)
# (filled in at the end of the module)
QUERIES: dict = {}

# messy raw spelling -> normalized name (the reference ships ~80 variants,
# MortgageSpark.scala:128-209; representative subset with the same shape)
NAME_MAPPING = [
    ("WELLS FARGO BANK, N.A.", "Wells Fargo"),
    ("WELLS FARGO BANK, NA", "Wells Fargo"),
    ("JPMORGAN CHASE BANK, NA", "JP Morgan Chase"),
    ("CHASE HOME FINANCE, LLC", "JP Morgan Chase"),
    ("BANK OF AMERICA, N.A.", "Bank of America"),
    ("QUICKEN LOANS INC.", "Quicken Loans"),
    ("U.S. BANK N.A.", "US Bank"),
    ("FLAGSTAR BANK, FSB", "Flagstar Bank"),
    ("PNC BANK, N.A.", "PNC"),
    ("SUNTRUST MORTGAGE INC.", "Suntrust"),
    ("OTHER", "Other"),
]


def name_mapping_df(session):
    return session.create_dataframe(pd.DataFrame({
        "from_seller_name": [a for a, _ in NAME_MAPPING],
        "to_seller_name": [b for _, b in NAME_MAPPING],
    }), 1)


def prepare_performance(perf):
    """Month/year/day breakout of the reporting period
    (CreatePerformanceDelinquency.prepare; the to_date parses are not
    needed — the generator types dates natively)."""
    p = F.col("monthly_reporting_period")
    return (perf
            .with_column("monthly_reporting_period_month", F.month(p))
            .with_column("monthly_reporting_period_year", F.year(p))
            .with_column("monthly_reporting_period_day", F.dayofmonth(p)))


def create_performance_delinquency(session, df):
    """The 12-month delinquency/UPB windowing ETL
    (CreatePerformanceDelinquency.apply, MortgageSpark.scala:229-298)."""
    status = F.col("current_loan_delinquency_status")
    period = F.col("monthly_reporting_period")
    agg_df = (df.select(
        F.col("quarter"), F.col("loan_id"), status,
        F.when(status >= 1, period).alias("delinquency_30"),
        F.when(status >= 3, period).alias("delinquency_90"),
        F.when(status >= 6, period).alias("delinquency_180"))
        .group_by("quarter", "loan_id")
        .agg(F.max("current_loan_delinquency_status").alias("delinquency_12"),
             F.min("delinquency_30").alias("delinquency_30"),
             F.min("delinquency_90").alias("delinquency_90"),
             F.min("delinquency_180").alias("delinquency_180"))
        .select(F.col("quarter"), F.col("loan_id"),
                (F.col("delinquency_12") >= 1).alias("ever_30"),
                (F.col("delinquency_12") >= 3).alias("ever_90"),
                (F.col("delinquency_12") >= 6).alias("ever_180"),
                F.col("delinquency_30"), F.col("delinquency_90"),
                F.col("delinquency_180")))

    joined = (df
              .with_column_renamed("monthly_reporting_period", "timestamp")
              .with_column_renamed("monthly_reporting_period_month",
                                   "timestamp_month")
              .with_column_renamed("monthly_reporting_period_year",
                                   "timestamp_year")
              .with_column_renamed("current_loan_delinquency_status",
                                   "delinquency_12")
              .with_column_renamed("current_actual_upb", "upb_12")
              .select("quarter", "loan_id", "timestamp", "delinquency_12",
                      "upb_12", "timestamp_month", "timestamp_year")
              .join(agg_df, on=["loan_id", "quarter"], how="left"))

    months = 12
    month_y = session.create_dataframe(
        pd.DataFrame({"month_y": list(range(months))}), 1)
    mons = F.col("timestamp_year") * 12 + F.col("timestamp_month")
    test_df = (joined.join(month_y)  # broadcast cross join = explode(0..11)
               .select(
        F.col("quarter"),
        F.floor((mons - 24000) / months).alias("josh_mody"),
        F.floor((mons - 24000 - F.col("month_y")) / months)
        .alias("josh_mody_n"),
        F.col("ever_30"), F.col("ever_90"), F.col("ever_180"),
        F.col("delinquency_30"), F.col("delinquency_90"),
        F.col("delinquency_180"),
        F.col("loan_id"), F.col("month_y"), F.col("delinquency_12"),
        F.col("upb_12"))
        .group_by("quarter", "loan_id", "josh_mody_n", "ever_30", "ever_90",
                  "ever_180", "delinquency_30", "delinquency_90",
                  "delinquency_180", "month_y")
        .agg(F.max("delinquency_12").alias("delinquency_12"),
             F.min("upb_12").alias("upb_12")))
    base = 24000 + F.col("josh_mody_n") * months
    tmp = F.pmod(base + F.col("month_y"), 12)
    test_df = (test_df
               .with_column("timestamp_year",
                            F.floor((base + (F.col("month_y") - 1)) / 12))
               .with_column("timestamp_month_tmp", tmp)
               .with_column("timestamp_month",
                            F.when(F.col("timestamp_month_tmp") == 0, 12)
                            .otherwise(F.col("timestamp_month_tmp")))
               .with_column("delinquency_12",
                            (F.col("delinquency_12") > 3).cast("int")
                            + (F.col("upb_12") == 0).cast("int"))
               .drop("timestamp_month_tmp", "josh_mody_n", "month_y"))

    out = (df.with_column_renamed("monthly_reporting_period_month",
                                  "timestamp_month")
           .with_column_renamed("monthly_reporting_period_year",
                                "timestamp_year"))
    # align key dtypes: floor() yields int64, year()/month() int32
    test_df = test_df.with_column(
        "timestamp_year", F.col("timestamp_year").cast("int"))
    return (out.join(test_df,
                     on=["quarter", "loan_id", "timestamp_year",
                         "timestamp_month"], how="left")
            .drop("timestamp_year", "timestamp_month"))


def create_acquisition(session, df):
    """Seller-name normalization via broadcast mapping join
    (CreateAcquisition, MortgageSpark.scala:301-315)."""
    mapping = name_mapping_df(session)
    return (df.join(mapping, left_on=["seller_name"],
                    right_on=["from_seller_name"], how="left")
            .drop("from_seller_name")
            .with_column("old_name", F.col("seller_name"))
            .with_column("seller_name",
                         F.coalesce(F.col("to_seller_name"),
                                    F.col("seller_name")))
            .drop("to_seller_name"))


def run_etl(session, perf, acq):
    """The full Mortgage ETL (Run/CleanAcquisitionPrime,
    MortgageSpark.scala:317-347)."""
    p = create_performance_delinquency(session, prepare_performance(perf))
    a = create_acquisition(session, acq)
    return p.join(a, on=["loan_id", "quarter"], how="inner").drop("quarter")


def simple_aggregates(session, perf, acq):
    """max-rate-per-month -> join -> min-per-zip (SimpleAggregates,
    MortgageSpark.scala:349-365)."""
    max_rate = (perf
                .with_column("monthval",
                             F.month(F.col("monthly_reporting_period")))
                .group_by("monthval", "loan_id")
                .agg(F.max("interest_rate").alias("max_monthly_rate")))
    joined = max_rate.join(acq.select(F.col("loan_id").alias("a_loan_id"),
                                      "zip"),
                           left_on=["loan_id"], right_on=["a_loan_id"])
    return (joined.group_by("zip", "monthval")
            .agg(F.min("max_monthly_rate").alias("min_max_monthly_rate")))


def _anon(df):
    return (df.with_column("loan_id_hash", F.hash("loan_id"))
            .drop("loan_id"))


def aggregates_with_join(session, perf, acq):
    """Anonymized per-loan aggregates joined across the two tables
    (AggregatesWithJoin, MortgageSpark.scala:391-421)."""
    p = (_anon(perf).group_by("loan_id_hash")
         .agg(F.min("interest_rate").alias("min_int_rate")))
    a = (_anon(acq).group_by("loan_id_hash")
         .agg(F.first("orig_interest_rate", ignorenulls=True)
              .alias("first_int_rate"),
              F.coalesce(F.max("dti"), F.lit(0.0)).alias("max_dti")))
    a = a.select(F.col("loan_id_hash").alias("a_hash"), "first_int_rate",
                 "max_dti")
    return p.join(a, left_on=["loan_id_hash"], right_on=["a_hash"],
                  how="left").drop("a_hash")


def aggregates_with_percentiles(session, perf):
    """Exact interpolated percentiles of interest_rate per anonymized loan
    (AggregatesWithPercentiles, MortgageSpark.scala:367-389). percentile()
    is not decomposable into fixed-width partial aggregates, so it is
    computed with rank/count windows: for percentile p over n ordered
    values, pos = 1 + p*(n-1); rows at rank floor(pos)/ceil(pos)
    contribute with linear-interpolation weights and a plain sum finishes
    the job on device."""
    ps = [("interest_rate_50p", 0.5), ("interest_rate_75p", 0.75),
          ("interest_rate_90p", 0.9), ("interest_rate_99p", 0.99)]
    base = _anon(perf).select("loan_id_hash", "interest_rate")
    w = Window.partition_by("loan_id_hash").order_by("interest_rate")
    ranked = (base
              .with_column("rn", F.row_number().over(w))
              .with_column("n", F.count("interest_rate").over(
                  Window.partition_by("loan_id_hash"))))
    aggs = [F.round(F.min("interest_rate"), 4).alias("interest_rate_min"),
            F.round(F.max("interest_rate"), 4).alias("interest_rate_max"),
            F.round(F.avg("interest_rate"), 4).alias("interest_rate_avg")]
    x, rn = F.col("interest_rate"), F.col("rn")
    for name, p in ps:
        pos = 1 + p * (F.col("n") - 1)
        lo, hi = F.floor(pos), F.ceil(pos)
        frac = pos - lo
        contrib = (F.when(rn == lo, x * (1.0 - frac)).otherwise(0.0)
                   + F.when((rn == hi) & (hi != lo), x * frac).otherwise(0.0))
        aggs.append(F.round(F.sum(contrib), 4).alias(name))
    return ranked.group_by("loan_id_hash").agg(*aggs)


QUERIES.update({
    "etl": (run_etl, True),
    "simple_aggregates": (simple_aggregates, True),
    "aggregates_with_join": (aggregates_with_join, True),
    "aggregates_with_percentiles": (aggregates_with_percentiles, False),
})


def run_query(name: str, session, perf, acq):
    """Query ``name`` of QUERIES over the two tables' DataFrames."""
    fn, needs_acq = QUERIES[name]
    return fn(session, perf, acq) if needs_acq else fn(session, perf)

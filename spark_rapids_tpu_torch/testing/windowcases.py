"""The window cases shared by the port's CPU tests, its card tests and
``chip_smoke.py``: the 22 cases of the JAX package's
``tests/test_window.py`` on the same seeded frame, plus partition keys the
JAX tests lack. Each case is a function of (functions module, Window
class, DataFrame) and so runs through either package's session (their
APIs match).

``frame(extra, n)`` is the JAX tests' frame of ``n`` rows (a dictionary
string key ``k`` with NULLs, small integer keys ``g``/``ts``/``q``, a
nullable float ``v``) plus the columns a case's ``extra`` adds: a unique
order key, a nullable order key, dates, timestamps, a float order key, and
``_extra_keys``' char-slab string key with NULLs (80 values, too many for a
dictionary at 300 rows) and nullable integer key.

``CASES``: name -> (extra, query, approx), ``approx`` where the JAX tests
compare at rtol 1e-6 (float sums and averages over frames, differences of
prefix sums). ``FALLBACKS``: the four cases the JAX package tags off its
device, name -> (extra, query).
"""

import numpy as np
import pandas as pd

N = 300


def frame(extra=None, n: int = N) -> pd.DataFrame:
    """The JAX package's window tests' ``_df`` frame of ``n`` rows (seed
    42), plus the columns ``extra`` draws from the same generator
    afterwards."""
    N = n
    rng = np.random.default_rng(42)
    df = pd.DataFrame({
        "k": pd.Series(np.asarray(["a", "b", "c", None], dtype=object)[
            np.arange(N) % 4]),
        "g": rng.integers(0, 8, N),
        "ts": rng.integers(0, 50, N),
        "v": pd.Series(rng.uniform(-10, 10, N)).astype("Float64")
        .mask(pd.Series(rng.random(N) < 0.15)),
        "q": rng.integers(1, 100, N),
    })
    if extra is not None:
        extra(df, rng)
    return df


def _unique_u(df, rng):
    df["u"] = np.arange(len(df))


def _nullable_order(df, rng):
    df["tsn"] = pd.Series(df["ts"]).astype("Int64").mask(
        pd.Series(rng.random(len(df)) < 0.2))


def _dates(df, rng):
    df["dt"] = (rng.integers(18000, 18100, len(df))
                .astype("datetime64[D]").astype("datetime64[s]"))


def _datetimes(df, rng):
    df["u"] = np.arange(len(df))
    df["dt"] = (rng.integers(0, 10**6, len(df)) * 10**9
                ).astype("datetime64[ns]")


def _float_order(df, rng):
    df["fv"] = rng.uniform(0, 20, len(df))


def _extra_keys(df, rng):
    """A slab string key with NULLs and a nullable integer key."""
    i = np.arange(len(df))
    keys = np.asarray([f"partition-key-{j:03d}-of-the-slab"
                       for j in range(80)], dtype=object)[i % 80]
    df["sk"] = pd.Series(np.where(i % 11 == 0, None, keys), dtype=object)
    df["gn"] = pd.Series(df["g"] % 3).astype("Int64").mask(
        pd.Series(rng.random(len(df)) < 0.25))
    df["u"] = np.arange(len(df))


# name -> (extra columns, query(M, Win, df), approx); M is the functions
# module and Win the Window class of one package
CASES = {
    "row_number": (None, lambda M, Win, d: d.with_column(
        "rn", M.row_number().over(
            Win.partition_by("g").order_by("ts", "q"))), False),
    "rank_dense_rank": (None, lambda M, Win, d: d.with_column(
        "r", M.rank().over(Win.partition_by("k").order_by("ts")))
        .with_column("dr", M.dense_rank().over(
            Win.partition_by("k").order_by("ts"))), False),
    "cumulative_sum": (None, lambda M, Win, d: d.with_column(
        "cum", M.sum("v").over(Win.partition_by("g").order_by("ts"))),
        True),
    "cumulative_min_max": (None, lambda M, Win, d: d.with_column(
        "mn", M.min("v").over(Win.partition_by("g").order_by("ts")))
        .with_column("mx", M.max("q").over(
            Win.partition_by("g").order_by("ts"))), True),
    "whole_partition_agg": (None, lambda M, Win, d: d.with_column(
        "tot", M.sum("q").over(Win.partition_by("k")))
        .with_column("n", M.count("v").over(Win.partition_by("k"))), False),
    "bounded_row_frame": (None, lambda M, Win, d: d.with_column(
        "ma", M.avg("v").over(Win.partition_by("g").order_by("ts", "q")
                              .rows_between(-2, Win.currentRow)))
        .with_column("cnt3", M.count("v").over(
            Win.partition_by("g").order_by("ts", "q")
            .rows_between(-2, Win.currentRow))), True),
    "lead_lag": (None, lambda M, Win, d: d.with_column(
        "nxt", M.lead("q", 1).over(Win.partition_by("g").order_by("ts", "q")))
        .with_column("prv", M.lag("v", 2).over(
            Win.partition_by("g").order_by("ts", "q"))), True),
    "lead_lag_strings": (_unique_u, lambda M, Win, d: d.with_column(
        "nk", M.lead("k", 1).over(Win.partition_by("g").order_by("ts", "u")))
        .with_column("pk", M.lag("k", 2).over(
            Win.partition_by("g").order_by("ts", "u"))), False),
    "lead_lag_default": (None, lambda M, Win, d: d.with_column(
        "nxt", M.lead("q", 1, default=-1).over(
            Win.partition_by("g").order_by("ts", "q")))
        .with_column("prv", M.lag("v", 2, default=0.5).over(
            Win.partition_by("g").order_by("ts", "q"))), True),
    "bounded_row_frame_min_max": (None, lambda M, Win, d: d.with_column(
        "mn", M.min("v").over(Win.partition_by("g").order_by("ts", "q")
                              .rows_between(-2, Win.currentRow)))
        .with_column("mx", M.max("q").over(
            Win.partition_by("g").order_by("ts", "q").rows_between(-1, 3))),
        True),
    "one_sided_row_frame_min_max": (None, lambda M, Win, d: d.with_column(
        "mn", M.min("v").over(Win.partition_by("g").order_by("ts", "q")
                              .rows_between(Win.unboundedPreceding,
                                            Win.currentRow)))
        .with_column("mx", M.max("q").over(
            Win.partition_by("g").order_by("ts", "q")
            .rows_between(Win.currentRow, Win.unboundedFollowing))), True),
    "wide_bounded_row_frame_min_max": (None, lambda M, Win, d: d.with_column(
        "mn", M.min("v").over(Win.partition_by("g").order_by("ts", "q")
                              .rows_between(-40, 3)))
        .with_column("mx", M.max("q").over(
            Win.partition_by("g").order_by("ts", "q").rows_between(-40, 3))),
        True),
    "bounded_range_frame": (None, lambda M, Win, d: d
                            .with_column("rs", M.sum("v").over(_rng_w(Win)))
                            .with_column("rc", M.count("v").over(_rng_w(Win)))
                            .with_column("rmn", M.min("v").over(_rng_w(Win)))
                            .with_column("rmx", M.max("q").over(_rng_w(Win)))
                            .with_column("ra", M.avg("v").over(_rng_w(Win))),
                            True),
    "bounded_range_nullable_order": (_nullable_order, lambda M, Win, d:
                                     d.with_column("rs", M.sum("q").over(
                                         Win.partition_by("g")
                                         .order_by("tsn")
                                         .range_between(-4, 0))), True),
    "bounded_range_date_order": (_dates, lambda M, Win, d: d.with_column(
        "wk", M.sum("q").over(Win.partition_by("g").order_by(
            M.to_date(M.col("dt"))).range_between(-7, 0))), False),
    "bounded_range_one_sided": (None, lambda M, Win, d: d.with_column(
        "a", M.sum("q").over(Win.partition_by("g").order_by("ts")
                             .range_between(Win.unboundedPreceding, 3)))
        .with_column("b", M.min("q").over(
            Win.partition_by("g").order_by("ts")
            .range_between(-5, Win.unboundedFollowing))), False),
    "string_min_max_whole_partition": (None, lambda M, Win, d: d
                                       .with_column("mn", M.min("k").over(
                                           Win.partition_by("g")))
                                       .with_column("mx", M.max("k").over(
                                           Win.partition_by("g")))
                                       .with_column("c", M.count("k").over(
                                           Win.partition_by("g"))), False),
    "over_strings_partition": (None, lambda M, Win, d: d.with_column(
        "rn", M.row_number().over(Win.partition_by("k").order_by("q"))),
        False),
    # partition keys the JAX tests lack
    "slab_string_partition": (_extra_keys, lambda M, Win, d: d
                              .with_column("rn", M.row_number().over(
                                  Win.partition_by("sk").order_by("u")))
                              .with_column("s", M.sum("q").over(
                                  Win.partition_by("sk")))
                              .with_column("mx", M.max("k").over(
                                  Win.partition_by("sk"))), False),
    "slab_and_dict_partition": (_extra_keys, lambda M, Win, d: d
                                .with_column("r", M.rank().over(
                                    Win.partition_by("sk", "k")
                                    .order_by("ts")))
                                .with_column("nk", M.lead("sk", 1).over(
                                    Win.partition_by("k").order_by("u"))),
                                False),
    "null_numeric_partition": (_extra_keys, lambda M, Win, d: d
                               .with_column("dr", M.dense_rank().over(
                                   Win.partition_by("gn").order_by("ts")))
                               .with_column("c", M.count("v").over(
                                   Win.partition_by("gn").order_by("u")
                                   .rows_between(-3, 3))), False),
}


def _rng_w(Win):
    return Win.partition_by("g").order_by("ts").range_between(-5, 3)


# the JAX package's fall-back cases: (extra columns, query)
FALLBACKS = {
    "lead_lag_datetime_default": (_datetimes, lambda M, Win, d: d.with_column(
        "p", M.lag("dt", 1, default=pd.Timestamp("2020-01-01")).over(
            Win.partition_by("g").order_by("u")))),
    "float_order_range": (_float_order, lambda M, Win, d: d.with_column(
        "m", M.sum("q").over(Win.partition_by("g").order_by("fv")
                             .range_between(-2, 2)))),
    "descending_range": (None, lambda M, Win, d: d.with_column(
        "m", M.sum("q").over(Win.partition_by("g").order_by(
            M.col("ts").desc()).range_between(-3, 1)))),
    "string_min_cumulative": (None, lambda M, Win, d: d.with_column(
        "mn", M.min("k").over(Win.partition_by("g").order_by("ts")))),
}

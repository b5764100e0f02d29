"""The expressions and aggregates TPCxBB reaches, through the port's
``TpuSparkSession`` on the CPU, against the JAX package's session on the
same seeded frame (nulls, NaN, negative values, zero divisors):
``isNull``/``isNotNull``, ``coalesce``, ``cast`` between the numeric
types, bool and date, ``round`` (HALF_UP) and ``bround`` (HALF_EVEN),
``%`` and ``pmod``; the variances, standard deviations and ``corr``,
grouped and global; ``count_distinct`` beside other aggregates; and the
fused count distinct (``exec/aggfuse.py``) against the unfused chain.

Each runs in test mode (no operator may stay on the CPU) and through the
port's CPU operators. Keys, counts and integers exact; float64 at rtol
1e-9.
"""

import numpy as np
import pandas as pd
import pytest

from spark_rapids_tpu.sql import functions as RF
from spark_rapids_tpu_torch.exec import aggfuse
from spark_rapids_tpu_torch.session import TpuSparkSession
from spark_rapids_tpu_torch.sql import functions as F
from spark_rapids_tpu_torch.testing.tpcxbbcases import same_rows
from tests.querytest import with_tpu_session


def _frame(n: int = 400, seed: int = 7) -> pd.DataFrame:
    rng = np.random.default_rng(seed)

    def nullable(values, rate, dtype):
        s = pd.Series(values).astype(dtype)
        s[rng.random(n) < rate] = pd.NA
        return s
    x = rng.normal(0.0, 50.0, n).round(3)
    x[rng.random(n) < 0.03] = np.nan
    halves = rng.integers(-40, 40, n) / 4.0  # exact .25/.5/.75 values
    return pd.DataFrame({
        "g": rng.integers(0, 12, n).astype(np.int64),
        "a": nullable(rng.integers(-30, 30, n), 0.15, "Int64"),
        "b": nullable(rng.integers(-7, 7, n), 0.15, "Int32"),
        "x": x,
        "y": nullable(rng.normal(3.0, 2.0, n), 0.1, "Float64"),
        "h": halves,
        "t": rng.random(n) < 0.5,
        "d": (np.datetime64("1998-01-01") + rng.integers(0, 900, n)
              .astype("timedelta64[D]")).astype("datetime64[s]"),
        "s": np.asarray(["p", "q", None, "rr"], dtype=object)[
            rng.integers(0, 4, n)],
        "w": np.asarray([f"w{i:04d}" for i in rng.integers(0, 700, n)],
                        dtype=object),
    })


FRAME = _frame()


def _port(**conf):
    b = (TpuSparkSession.builder().device("cpu")
         .config("spark.rapids.sql.test.enabled", True))
    for k, v in conf.items():
        b.config(k, v)
    return b.get_or_create()


def _check(query, order=None, **conf):
    """The port's device operators and CPU operators against the JAX
    session: ``query(session, functions)`` over FRAME, rows sorted by
    ``order`` (default: every column)."""
    want = with_tpu_session(lambda rs: query(rs.create_dataframe(FRAME),
                                             RF), conf=conf)
    assert len(want) > 0
    outs = [query(_port(**conf).create_dataframe(FRAME), F).collect(),
            query(_port(**{"spark.rapids.sql.enabled": False})
                  .create_dataframe(FRAME), F).collect()]
    order = order or list(want.columns)
    want = want.sort_values(order, kind="stable").reset_index(drop=True)
    for got in outs:
        got = got.sort_values(order, kind="stable").reset_index(drop=True)
        same_rows(got, want)
    return outs[0]


# each case: (name, projection of (df, functions))
PROJECTIONS = {
    "is_null": lambda fn: [fn.col("a").isNull(), fn.col("x").isNull(),
                           fn.col("s").isNull(), fn.col("y").isNotNull(),
                           fn.col("s").isNotNull()],
    "coalesce": lambda fn: [fn.coalesce(fn.col("a"), fn.col("b")),
                            fn.coalesce(fn.col("y"), fn.col("x"),
                                        fn.lit(-1.0)),
                            fn.coalesce(fn.col("b"), fn.lit(0))],
    "cast_numeric": lambda fn: [fn.col("a").cast("double"),
                                fn.col("x").cast("int"),
                                fn.col("x").cast("long"),
                                fn.col("y").cast("float"),
                                fn.col("a").cast("short"),
                                fn.col("h").cast("int")],
    "cast_bool": lambda fn: [fn.col("t").cast("int"),
                             fn.col("b").cast("boolean"),
                             fn.col("x").cast("boolean")],
    "cast_date": lambda fn: [fn.col("d").cast("date"),
                             fn.col("d").cast("long")],
    "round": lambda fn: [fn.round(fn.col("h"), 0), fn.round(fn.col("x"), 2),
                         fn.round(fn.col("y"), 1), fn.round(fn.col("a"), 1),
                         fn.round(fn.col("h") / 10, 1)],
    "bround": lambda fn: [fn.bround(fn.col("h"), 0),
                          fn.bround(fn.col("x"), 1)],
    "remainder": lambda fn: [fn.col("a") % fn.col("b"), fn.col("a") % 7,
                             fn.col("x") % fn.col("h")],
    "pmod": lambda fn: [fn.pmod(fn.col("a"), fn.col("b")),
                        fn.pmod(fn.col("a"), 10),
                        fn.pmod(fn.col("x"), fn.col("h"))],
}


@pytest.mark.parametrize("name", sorted(PROJECTIONS))
def test_expression_matches_reference_session(session, name):
    def query(df, fn):
        cols = PROJECTIONS[name](fn)
        return df.select(fn.col("w"), *[c.alias(f"c{i}")
                                        for i, c in enumerate(cols)])
    _check(query)


def test_cast_to_string_stays_off_the_device():
    """Since the string slice (A.5) an integer renders to a string on the
    device; a double still renders on the CPU, with the JAX package's
    reason, and test mode refuses it."""
    df = _port().create_dataframe(FRAME).select(
        F.col("a").cast("string").alias("z"))
    got = df.collect()
    assert [None if pd.isna(v) else v for v in got.z] == [
        None if pd.isna(v) else str(int(v)) for v in FRAME.a]
    df = _port().create_dataframe(FRAME).select(
        F.col("y").cast("string").alias("z"))
    assert "formatting is not supported on TPU" in df.explain()
    with pytest.raises(AssertionError, match="did not run"):
        df.collect()


AGGS = {
    "moments": lambda fn: [fn.stddev_samp("x").alias("sd"),
                           fn.stddev_pop("a").alias("sdp"),
                           fn.var_samp("y").alias("vs"),
                           fn.var_pop("b").alias("vp"),
                           fn.avg("a").alias("m")],
    "corr": lambda fn: [fn.corr("a", "y").alias("r1"),
                        fn.corr("b", "h").alias("r2"),
                        fn.count("*").alias("n")],
    "count_distinct": lambda fn: [fn.count_distinct("b").alias("nd"),
                                  fn.count("a").alias("na"),
                                  fn.sum("a").alias("sa"),
                                  fn.max("y").alias("my")],
    "count_distinct_string": lambda fn: [fn.count_distinct("s").alias("nd"),
                                         fn.sum("h").alias("sh")],
}


@pytest.mark.parametrize("grouped", [True, False])
@pytest.mark.parametrize("name", sorted(AGGS))
def test_aggregate_matches_reference_session(session, name, grouped):
    """Grouped by ``g`` (12 groups, some of one row after the filter) and
    global. The moments of x hold NaN in some groups (NaN propagates, as
    in the JAX package). Measured against the JAX session at this size,
    the largest relative error of a variance or corr is 1e-13 or below,
    well inside rtol 1e-9."""
    def query(df, fn):
        df = df.filter((fn.col("g") < 11) | (fn.col("b") == 3))
        if grouped:
            return df.group_by("g").agg(*AGGS[name](fn))
        return df.agg(*AGGS[name](fn))
    _check(query, order=["g"] if grouped else None)


def _distinct_counts(df, fn, keys):
    return df.select(*keys).distinct().group_by(keys[0]).agg(
        fn.count("*").alias("n"))


@pytest.mark.parametrize("keys", [["g", "b"], ["g", "s"], ["s", "w"],
                                  ["b", "g", "t"]])
def test_fused_count_distinct_matches_unfused_chain(session, keys):
    """``distinct().group_by(k).count()``: the fused pass (hash group ids
    over B3's plain build where every key is fixed-width or a dictionary;
    the sorted pass for the char-slab key w) equals the unfused chain
    (``agg.fuseCountDistinct`` false) and the JAX session."""
    fuse = "spark.rapids.sql.agg.fuseCountDistinct"
    aggfuse.reset_routes()
    fused = _check(lambda df, fn: _distinct_counts(df, fn, keys))
    route = "sorted" if "w" in keys else "hash"
    assert aggfuse.ROUTES[route] == 1 and sum(aggfuse.ROUTES.values()) == 1
    s = _port(**{fuse: False})
    df = _distinct_counts(s.create_dataframe(FRAME), F, keys)
    assert not any(isinstance(n, aggfuse.TpuCountDistinctExec)
                   for n in s.physical_plan(df._plan).walk())
    unfused = df.collect().sort_values(keys[0]).reset_index(drop=True)
    same_rows(fused.sort_values(keys[0]).reset_index(drop=True), unfused)

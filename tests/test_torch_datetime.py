"""The date parts and ``floor``/``ceil`` through the port's
``TpuSparkSession`` on the CPU, against the JAX package's session on the
same seeded frame.

Date parts: year, month, dayofmonth, dayofweek, quarter, dayofyear and
weekofyear over timestamps and dates, hour, minute and second over
timestamps; the frame holds timestamps before 1970 (negative
microseconds, where the split into days and time of day floors), 29
February of leap years, the last days of years (ISO weeks 52/53/1) and
NULLs. ``floor``/``ceil``: negatives, -0.0, NaN (0, Java's cast), ±inf and
values past int64 (saturating), integers, and the exact integer-division
rewrite of ``floor(a / b)`` (NULL where ``b`` is 0). Each runs in test mode
through the port's device operators and through its CPU operators. All
exact.
"""

import numpy as np
import pandas as pd
import pytest

from spark_rapids_tpu.sql import functions as RF
from spark_rapids_tpu_torch.session import TpuSparkSession
from spark_rapids_tpu_torch.sql import functions as F
from tests.querytest import with_tpu_session
from spark_rapids_tpu_torch.testing.signals import release_sigusr1  # noqa: F401

N = 400


def _frame() -> pd.DataFrame:
    rng = np.random.default_rng(11)
    micros = rng.integers(-4 * 10**15, 4 * 10**15, N)
    special = np.array(["1968-02-29T23:59:59.999999", "1969-12-31T23:00:00",
                        "1970-01-01T00:00:00", "2000-02-29T12:34:56.5",
                        "2004-12-31T01:02:03", "2005-01-01T00:00:00",
                        "2008-12-29T00:00:00", "2010-01-03T23:59:59",
                        "1900-03-01T00:00:01", "1600-02-29T06:00:00"],
                       dtype="datetime64[us]").astype(np.int64)
    micros[:len(special)] = special
    ts = pd.Series(micros.astype("datetime64[us]"))
    ts[rng.random(N) < 0.1] = pd.NaT
    x = rng.normal(0, 20, N)
    x[:8] = [np.nan, np.inf, -np.inf, -0.0, -2.5, 2.5, 1e30, -1e30]
    return pd.DataFrame({
        "ts": ts,
        "x": x,
        "a": rng.integers(-50, 50, N).astype(np.int64),
        "b": rng.integers(-4, 5, N).astype(np.int32),
        "n": pd.Series(rng.integers(-9, 9, N)).astype("Int64").mask(
            pd.Series(rng.random(N) < 0.2)),
        "id": np.arange(N),
    })


FRAME = _frame()

_DATE_PARTS = ["year", "month", "dayofmonth", "dayofweek", "quarter",
               "dayofyear", "weekofyear"]

CASES = {}
for _p in _DATE_PARTS:
    CASES[f"{_p}_ts"] = (lambda p: lambda M: getattr(M, p)(M.col("ts")))(_p)
    CASES[f"{_p}_date"] = (lambda p: lambda M: getattr(M, p)(
        M.to_date(M.col("ts"))))(_p)
for _p in ["hour", "minute", "second"]:
    CASES[f"{_p}_ts"] = (lambda p: lambda M: getattr(M, p)(M.col("ts")))(_p)
CASES.update({
    "floor_float": lambda M: M.floor(M.col("x")),
    "ceil_float": lambda M: M.ceil(M.col("x")),
    "floor_int": lambda M: M.floor(M.col("a")),
    "ceil_nullable_int": lambda M: M.ceil(M.col("n")),
    "floor_int_div": lambda M: M.floor(M.col("a") / M.col("b")),
    "ceil_int_div": lambda M: M.ceil(M.col("a") / M.col("b")),
    "floor_int_div_nullable": lambda M: M.floor((M.col("n") - 24000)
                                                / 12),
    "floor_float_div": lambda M: M.floor(M.col("x") / M.col("b")),
})


def _query(M, s, df):
    return s.create_dataframe(df, 2).select(
        M.col("id"), *[fn(M).alias(name) for name, fn in CASES.items()])


@pytest.fixture(scope="module")
def results():
    out = {"jax": with_tpu_session(lambda rs: _query(RF, rs, FRAME))}
    for key, conf in (("device", {"spark.rapids.sql.test.enabled": True}),
                      ("cpu", {"spark.rapids.sql.enabled": False})):
        b = TpuSparkSession.builder().device("cpu")
        for k, v in conf.items():
            b.config(k, v)
        out[key] = _query(F, b.get_or_create(), FRAME).collect()
    return out


def _values(s: pd.Series) -> list:
    return [None if pd.isna(v) else int(v) for v in s]


@pytest.mark.parametrize("name", list(CASES))
def test_expression_matches_reference_session(name, results):
    want = results["jax"].sort_values("id")[name]
    assert want.notna().sum() > N // 2
    for key in ("device", "cpu"):
        got = results[key].sort_values("id")[name]
        assert _values(got) == _values(want), key


def test_floor_ceil_edges():
    """NaN gives 0, ±inf and values past int64 saturate, -0.0 gives 0,
    and an integer division by 0 is NULL: on the device and the host."""
    got = (results_of_first_rows())
    assert list(got["f"][:8]) == [0, (1 << 63) - 1, -(1 << 63), 0, -3, 2,
                                  (1 << 63) - 1, -(1 << 63)]
    assert list(got["c"][:8]) == [0, (1 << 63) - 1, -(1 << 63), 0, -2, 3,
                                  (1 << 63) - 1, -(1 << 63)]


def results_of_first_rows():
    b = (TpuSparkSession.builder().device("cpu")
         .config("spark.rapids.sql.test.enabled", True).get_or_create())
    return b.create_dataframe(FRAME).select(
        F.floor("x").alias("f"), F.ceil("x").alias("c")).collect()


def test_date_parts_match_pandas_calendar(results):
    """Held to pandas' calendar too, on the rows pandas can hold."""
    got = results["device"].sort_values("id").reset_index(drop=True)
    ts = pd.DatetimeIndex(FRAME["ts"])
    ok = ~ts.isna()
    for name, want in (("year_ts", ts.year), ("month_ts", ts.month),
                       ("dayofmonth_ts", ts.day), ("hour_ts", ts.hour),
                       ("minute_ts", ts.minute), ("second_ts", ts.second),
                       ("quarter_ts", ts.quarter),
                       ("dayofyear_ts", ts.dayofyear),
                       ("weekofyear_ts", ts.isocalendar().week),
                       ("dayofweek_ts", (ts.dayofweek + 1) % 7 + 1)):
        assert (got[name][ok].to_numpy(np.int64)
                == np.asarray(want, dtype=np.float64)[ok]).all(), name

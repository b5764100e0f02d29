"""Date arithmetic and unix time through the port's ``TpuSparkSession`` on
the CPU, against the JAX package's session on the same seeded frame
(``testing/exprcases.py``): date_add, date_sub, datediff, last_day,
add_months (the day clamped to the month's end), months_between, trunc
(year, month, quarter, week), next_day, unix_timestamp of timestamps,
dates and strings in both device formats (as a slab, a dictionary and
plain chars, padded, with invalid days, hours past 23 and garbage), and
from_unixtime. The timestamps fall before 1970, on 29 February and at
month and year ends. Each case runs in test mode through the port's
device operators and through its CPU operators; all exact.

Also the device tags the JAX package sets, reason for reason: date_add
and date_sub over a timestamp (they take ``to_date(ts)``), an
unix_timestamp format other than the two fixed ones, trunc and next_day
of an unknown unit (NULL on the CPU); and ``ops/strings.string_to_unix_ts``
over the three string forms against the host rule, value by value.
"""

import pandas as pd
import pytest

from spark_rapids_tpu.sql import functions as RF
from spark_rapids_tpu_torch.columnar.batch import DeviceBatch
from spark_rapids_tpu_torch.ops import strings
from spark_rapids_tpu_torch.sql import functions as F
from spark_rapids_tpu_torch.sql.exprs.evalbridge import make_context
from spark_rapids_tpu_torch.testing import exprcases as E
from tests.test_torch_exprs_tail import (
    _DATE_WORDS, assert_same_reasons, port_session, run_all,
)
from spark_rapids_tpu_torch.testing.signals import release_sigusr1  # noqa: F401

N = 500
NAMES = [n for n in E.CASES if n.startswith(_DATE_WORDS)]
FRAME = E.frame(N, seed=7)


@pytest.fixture(scope="module")
def results():
    return run_all(NAMES, FRAME)


@pytest.mark.parametrize("name", NAMES)
def test_case_matches_reference_session(name, results):
    want = results["jax_cpu" if name in E.NUMPY_HELD else "jax"][name]
    assert want.notna().sum() > N // 10
    for key in ("device", "cpu"):
        err = E.same_values(results[key][name], want, False)
        assert not err, f"{key}: {err}"


def test_add_months_clamps_and_months_between_whole_months():
    df = pd.DataFrame({"d": pd.to_datetime(
        ["2000-01-31", "2001-01-31", "1999-12-31", "2000-02-29"]),
        "e": pd.to_datetime(["2000-02-29", "2001-02-28", "2000-02-29",
                             "2000-03-31"])})
    for conf in ({"spark.rapids.sql.test.enabled": True},
                 {"spark.rapids.sql.enabled": False}):
        out = port_session(**conf).create_dataframe(df).select(
            F.add_months(F.to_date(F.col("d")), 1).alias("am"),
            F.months_between(F.col("e"), F.col("d")).alias("mb")).collect()
        assert [str(x)[:10] for x in out.am] == [
            "2000-02-29", "2001-02-28", "2000-01-31", "2000-03-29"]
        # last day to last day is a whole month
        assert list(out.mb) == [1.0, 1.0, 2.0, 1.0]


@pytest.mark.parametrize("case", ["date_add_ts", "date_sub_ts",
                                  "unix_fmt", "trunc_unit", "next_day_unit"])
def test_device_tags_match_reference(case, session):
    df = pd.DataFrame({"ts": pd.to_datetime(["2001-02-03 04:05:06"]),
                       "s": ["2001-02-03"]})
    build = {
        "date_add_ts": lambda M: M.date_add(M.col("ts"), 1),
        "date_sub_ts": lambda M: M.date_sub(M.col("ts"), 1),
        "unix_fmt": lambda M: M.unix_timestamp(M.col("s"), "dd-MM-yyyy"),
        "trunc_unit": lambda M: M.trunc(M.col("ts"), "decade"),
        "next_day_unit": lambda M: M.next_day(M.col("ts"), "someday"),
    }[case]
    session.set_conf("spark.rapids.sql.enabled", True)
    want = session.create_dataframe(df).select(
        build(RF).alias("o")).explain()
    q = port_session().create_dataframe(df).select(build(F).alias("o"))
    assert_same_reasons(q.explain(), want)
    session.set_conf("spark.rapids.sql.enabled", False)
    want_rows = session.create_dataframe(df).select(
        build(RF).alias("o")).collect()
    got_rows = q.collect()
    assert E.same_values(got_rows.o, want_rows.o, False) == ""


def test_unsupported_format_token_refused():
    with pytest.raises(ValueError, match="unsupported unix_timestamp"):
        F.unix_timestamp(F.col("s"), "yyyy-MM-dd'T'HH")


@pytest.mark.parametrize("form", ["dict", "slab", "plain"])
@pytest.mark.parametrize("with_time", [False, True])
def test_string_to_unix_ts_every_form(form, with_time):
    vals = list(FRAME.sd) + [" 2000-02-29 ", "2000-02-29\t", "0000-01-01",
                             "9999-12-31 23:59:59", "1969-12-31 23:59:59"]
    if form == "dict":
        vals = vals[-40:]
    df = pd.DataFrame({"s": pd.Series(vals, dtype=object)})
    stride = 0 if form == "plain" else 64
    b = DeviceBatch.from_pandas(df, {} if form == "dict" else None,
                                device="cpu", slab_stride=stride)
    col = b.columns[0]
    assert {"dict": col.dict_values is not None, "slab": col.has_slab,
            "plain": col.is_plain}[form]
    ctx = make_context(b)
    secs, ok = strings.string_to_unix_ts(ctx, ctx.cols[0], with_time)
    for i, v in enumerate(vals):
        want = (strings._host_parse_unix_ts(v.encode(), with_time)
                if v is not None else (0, False))
        assert bool(ok[i]) == want[1], (v, bool(ok[i]))
        if want[1]:
            assert int(secs[i]) == want[0], v

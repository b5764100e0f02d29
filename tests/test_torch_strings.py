"""String comparisons and the expression set of the TPC-H queries through
the port's ``TpuSparkSession`` against the JAX package's session, on the
CPU.

The frame and the cases are ``testing/stringcases.py``'s (its docstring
lists them): char-slab and dictionary string columns with nulls, empty
strings, common prefixes of 8 and 9 bytes and a literal longer than any
slab's stride. Every case runs in one projection through the port's
session (``device="cpu"``: the device operators' torch code), through its
CPU operators (``spark.rapids.sql.enabled=false``) and through the JAX
package's session in test mode. Results are exact, nulls included.
A LIKE with ``_`` or an interior ``%`` is tagged off the device with its
reason (test mode raises), and gives the JAX package's answer on the CPU;
a string-valued CASE WHEN runs on the device.
"""

import numpy as np
import pandas as pd
import pytest

from spark_rapids_tpu.sql import functions as RF
from spark_rapids_tpu_torch.session import TpuSparkSession
from spark_rapids_tpu_torch.sql import functions as F
from spark_rapids_tpu_torch.testing import stringcases
from tests.querytest import with_tpu_session
from spark_rapids_tpu_torch.testing.signals import release_sigusr1  # noqa: F401

N = 600
LONG = stringcases.LONG


def _conditional(M):
    """The conditional-expression module of ``M``'s package."""
    if M is F:
        from spark_rapids_tpu_torch.sql.exprs import conditional
    else:
        from spark_rapids_tpu.sql.exprs import conditional
    return conditional


CASES = stringcases.cases(_conditional)


@pytest.fixture(scope="module")
def frame():
    return stringcases.string_frame(N)


def _project(M, s, df, names):
    return stringcases.projection(M, s, df, CASES, names)


def _port(df, names, **conf):
    b = (TpuSparkSession.builder().device("cpu")
         .config("spark.rapids.sql.test.enabled",
                 conf.get("spark.rapids.sql.enabled", True)))
    for k, v in conf.items():
        b.config(k, v)
    s = b.get_or_create()
    return _project(F, s, df, names).collect()


@pytest.fixture(scope="module")
def results(frame):
    names = list(CASES)
    return {
        "device": _port(frame, names),
        "cpu": _port(frame, names, **{"spark.rapids.sql.enabled": False}),
        "jax": with_tpu_session(lambda rs: _project(RF, rs, frame, names)),
    }


def _values(s: pd.Series) -> list:
    return [None if pd.isna(v) else str(v) for v in s]


@pytest.mark.parametrize("name", list(CASES))
def test_expression_matches_reference(name, results, frame):
    """The port's session (device operators and CPU operators) gives the
    JAX session's values, nulls included, row by row."""
    want = results["jax"]
    assert list(want.id) == list(frame.id)
    assert _values(results["device"][name]) == _values(want[name])
    assert _values(results["cpu"][name]) == _values(want[name])


def test_columns_take_the_forms_under_test(frame):
    """``s`` and ``s2`` upload as char slabs, ``d`` and ``d2`` as
    dictionaries, so both routes of every operation run."""
    from spark_rapids_tpu_torch.columnar.batch import DeviceBatch
    b = DeviceBatch.from_pandas(frame[["s", "s2", "d", "d2"]], device="cpu",
                                slab_stride=64)
    assert [c.has_slab for c in b.columns] == [True, True, False, False]
    assert all(c.char_stride < len(LONG) for c in b.columns[:2])


def test_motivating_filters_over_a_slab_and_a_dictionary(session):
    """The three filters that raised before the repair, over 1000
    distinct names (a char slab) and over 100 (a dictionary): the JAX
    session's row counts (1, 112 and 1000 over the slab)."""
    for n in (1000, 100):
        df = pd.DataFrame({"k": [f"name{i}" for i in range(n)],
                           "v": np.arange(n, dtype=np.int64)})
        s = (TpuSparkSession.builder().device("cpu")
             .config("spark.rapids.sql.test.enabled", True).get_or_create())
        for cond, rows in ((lambda M: M.col("k") == "name7", 1),
                           (lambda M: M.col("k") < "name2", 112),
                           (lambda M: M.col("k") == M.col("k"), 1000)):
            got = s.create_dataframe(df).filter(cond(F)).collect()
            want = with_tpu_session(
                lambda rs: rs.create_dataframe(df).filter(cond(RF)))
            assert sorted(got.v) == sorted(want.v)
            if n == 1000:
                assert len(got) == rows


@pytest.mark.parametrize("pattern", ["ab_d%", "a%h"])
def test_general_like_stays_on_cpu(pattern, frame):
    """A LIKE with ``_`` or an interior ``%`` is tagged off the device
    with the JAX package's reason: test mode raises with it; without test
    mode the host's regex gives the JAX package's answer."""
    s = (TpuSparkSession.builder().device("cpu")
         .config("spark.rapids.sql.test.enabled", True).get_or_create())
    df = s.create_dataframe(frame).filter(F.col("s").like(pattern))
    text = df.explain()
    assert "needs general regex, which is not supported on TPU" in text
    with pytest.raises(AssertionError, match="general regex"):
        df.collect()
    s.set_conf("spark.rapids.sql.test.enabled", False)
    got = df.collect()
    want = with_tpu_session(
        lambda rs: rs.create_dataframe(frame).filter(
            RF.col("s").like(pattern)),
        allow_non_tpu=["CpuFilterExec"])
    assert list(got.id) == list(want.id)
    assert len(got) > 0


def test_string_case_when_stays_on_cpu(frame):
    """A string-valued CASE WHEN, tagged off the device before the
    row-select string kernel was ported (``ops/strings.select_strings``),
    now runs on the device in test mode, over a char slab and a literal's
    one-value dictionary, and gives the JAX package's values; so do the
    CPU operators."""
    def q(M, sess):
        return sess.create_dataframe(frame).select(
            M.col("id"), M.when(M.col("x") > 4, M.col("s"))
            .otherwise(M.lit("none")).alias("r"))
    want = with_tpu_session(lambda rs: q(RF, rs))
    for conf in ({"spark.rapids.sql.test.enabled": True},
                 {"spark.rapids.sql.enabled": False}):
        b = TpuSparkSession.builder().device("cpu")
        for k, v in conf.items():
            b.config(k, v)
        df = q(F, b.get_or_create())
        assert "ROADMAP A.5" not in df.explain()
        got = df.collect()
        assert list(got.id) == list(want.id)
        assert _values(got.r) == _values(want.r)

"""The window stage through the port's ``TpuSparkSession`` against the JAX
package's session, on the CPU.

The cases are the 22 of the JAX package's ``tests/test_window.py``, on the
same seeded frames (``testing/windowcases.py``: a dictionary string key
with NULLs, small integer keys, a nullable float), plus partition keys
the JAX tests lack: a char-slab string key (80 values over 300 rows, too
many for a dictionary) with NULLs, a dictionary key and a slab key
together, and a numeric partition key that is NULL on some rows. Each
case runs through the port's device operators (``device="cpu"``: their
torch code) in test mode, through its CPU operators
(``spark.rapids.sql.enabled=false``) and through the JAX session in test
mode. Rows are compared as a set (the
JAX tests' ``assert_tpu_and_cpu_equal``); keys, counts, ranks, dates and
strings exact. A float sum, average or min over a frame is held at the
tolerance of the JAX package's own window tests, rtol 1e-6
(``approx=True``): a float sum frame is a difference of prefix sums, and
its last bits depend on the order of the adds.

Four cases fall back to the CPU in the JAX package (a datetime lead/lag
default, a bounded RANGE over a float or a descending order, a cumulative
string min): the port tags the same window column off the device with the
JAX package's reason, word for word, and its CPU operator computes the
JAX package's answer.
"""

import pytest

from spark_rapids_tpu.sql import functions as RF
from spark_rapids_tpu.sql.window import Window as RW
from spark_rapids_tpu_torch.session import TpuSparkSession
from spark_rapids_tpu_torch.sql import functions as F
from spark_rapids_tpu_torch.sql.window import Window as W
from spark_rapids_tpu_torch.testing.windowcases import (
    CASES, FALLBACKS, N, frame,
)
from tests.querytest import assert_frames_equal, with_tpu_session
from spark_rapids_tpu_torch.testing.signals import release_sigusr1  # noqa: F401


def _port_session(**conf) -> TpuSparkSession:
    b = TpuSparkSession.builder().device("cpu")
    for k, v in conf.items():
        b.config(k, v)
    return b.get_or_create()


def _run_port(query, df, **conf):
    s = _port_session(**conf)
    return query(F, W, s.create_dataframe(df, 3))


def _reasons(text: str) -> list:
    return sorted(r.strip() for line in text.splitlines() if "<--" in line
                  for r in line.split("<--", 1)[1].split(";")
                  if "window column" in r)


@pytest.mark.parametrize("name", list(CASES))
def test_window_matches_reference_session(session, name):
    extra, query, approx = CASES[name]
    df = frame(extra)
    want = with_tpu_session(lambda rs: query(RF, RW, rs.create_dataframe(
        df, 3)))
    assert len(want) == N
    dev = _run_port(query, df, **{"spark.rapids.sql.test.enabled": True})
    cpu = _run_port(query, df, **{"spark.rapids.sql.enabled": False})
    for got in (dev.collect(), cpu.collect()):
        assert_frames_equal(got, want, ignore_order=True, approx=approx)


@pytest.mark.parametrize("name", list(FALLBACKS))
def test_window_fallback_matches_reference_reason(session, name):
    extra, query = FALLBACKS[name]
    df = frame(extra)
    allow = {"spark.rapids.sql.test.allowedNonTpu": "CpuWindowExec"}
    want = with_tpu_session(lambda rs: query(RF, RW, rs.create_dataframe(
        df, 2)), allow_non_tpu=["CpuWindowExec"])
    from spark_rapids_tpu.session import TpuSparkSession as RS
    rs = RS.active()
    ref_text = query(RF, RW, rs.create_dataframe(df, 2)).explain()
    port = _run_port(query, df, **{"spark.rapids.sql.test.enabled": True},
                     **allow)
    text = port.explain()
    assert _reasons(text) == _reasons(ref_text) != []
    with pytest.raises(AssertionError, match="did not run on the TPU"):
        _run_port(query, df,
                  **{"spark.rapids.sql.test.enabled": True}).collect()
    for got in (port.collect(), _run_port(
            query, df, **{"spark.rapids.sql.enabled": False}).collect()):
        assert_frames_equal(got, want, ignore_order=True, approx=True)


def test_with_column_window_may_not_shadow():
    """A window column named like an existing one raises, as in the JAX
    package; ``select`` computes window expressions of two specs under
    one projection."""
    df = frame()
    s = _port_session(**{"spark.rapids.sql.test.enabled": True})
    d = s.create_dataframe(df)
    with pytest.raises(ValueError, match="shadow"):
        d.with_column("q", F.row_number().over(W.partition_by("g")))
    got = d.select("q", F.row_number().over(
        W.partition_by("g").order_by("q", "ts")).alias("rn"),
        (F.count("q").over(W.partition_by("k")) + 1).alias("c1")).collect()
    want = (df.assign(rn=df.sort_values(["q", "ts"], kind="stable")
                      .groupby("g").cumcount() + 1)
            .assign(c1=df.groupby("k", dropna=False)["q"]
                    .transform("count") + 1))
    assert_frames_equal(got, want[["q", "rn", "c1"]], ignore_order=True)

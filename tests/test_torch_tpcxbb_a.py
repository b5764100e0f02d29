"""TPCxBB Q5, Q6, Q7, Q9, Q11, Q12 and Q13 through the port's
``TpuSparkSession`` against the JAX package's session, on the CPU (Q14-Q20
are in ``test_torch_tpcxbb_b.py``, Q21-Q28 in ``test_torch_tpcxbb_c.py``;
the helpers here serve all three).

Each query (``models/tpcxbb.QUERIES``) runs at the JAX package's default
confs in test mode (no operator may stay on the CPU) through the port's
session (``device="cpu"``: the device operators' torch code and the
kernels' plain versions), through its CPU operators
(``spark.rapids.sql.enabled=false``) and through the JAX package's
session, and against the pandas references of ``testing/tpcxbbcases.py``
(which ``chip_smoke.py`` holds the card to), on the same seeded frames of
``models/tpcxbb_data.py`` at SF 0.05, the size of the JAX package's own
TPCxBB tests. Keys, counts, dates and strings exact, float64 at rtol
1e-9, in the query's order with rows tied on the sort key as a set; every
query returns rows. Q7's store_sales gains 12 sales in July 2004 of an
item priced above its category's average (``tpcxbbcases.query_frames``):
at SF 0.05 no state reaches its 10 otherwise.

Q11 (corr over float sums) and Q15 (a least-squares slope from sums with
cancellation) are the float cases that could differ in the last bits
between spellings (ROADMAP caution C.3): at this size the largest
relative error against pandas is 5e-15 for Q11 and 0 for Q15, and 3e-13
and 2e-12 at SF 0.5, inside rtol 1e-9.
"""

import pytest

from spark_rapids_tpu.models import tpcxbb as ref_tpcxbb
from spark_rapids_tpu_torch.exec import tpujoin
from spark_rapids_tpu_torch.models import tpcxbb
from spark_rapids_tpu_torch.models import tpcxbb_data as D
from spark_rapids_tpu_torch.session import TpuSparkSession
from spark_rapids_tpu_torch.testing import tpcxbbcases
from tests.querytest import with_tpu_session
from spark_rapids_tpu_torch.testing.signals import release_sigusr1  # noqa: F401

SF = 0.05

_FRAMES: dict = {}


def tpcxbb_frames(sf: float = SF) -> dict:
    """Every table at ``sf`` (generated once a process)."""
    if sf not in _FRAMES:
        _FRAMES[sf] = {n: f(sf, None) for n, f in D.ALL_TABLES.items()}
    return _FRAMES[sf]


def _tables(s, fr):
    return {n: s.create_dataframe(df) for n, df in fr.items()}


def check_query(qname: str) -> None:
    """The port's device operators and CPU operators against the JAX
    session and pandas, in test mode at the default confs."""
    fr = tpcxbbcases.query_frames(qname, tpcxbb_frames())
    want = with_tpu_session(
        lambda rs: ref_tpcxbb.QUERIES[qname](rs, _tables(rs, fr)))
    assert len(want) > 0
    pand = tpcxbbcases.pandas_reference(qname, fr)
    for conf in ({"spark.rapids.sql.test.enabled": True},
                 {"spark.rapids.sql.enabled": False}):
        b = TpuSparkSession.builder().device("cpu")
        for k, v in conf.items():
            b.config(k, v)
        s = b.get_or_create()
        tpujoin.reset_routes()
        got = tpcxbb.QUERIES[qname](s, _tables(s, fr)).collect()
        tpcxbbcases.same_answer(qname, got, want)
        tpcxbbcases.same_answer(qname, got, pand)
        if qname == "q7" and "spark.rapids.sql.test.enabled" in conf:
            # its join of item with the category averages on i_category
            assert tpujoin.ROUTES["union"] > 0


@pytest.mark.parametrize("qname", ["q5", "q6", "q7", "q9", "q11", "q12",
                                   "q13"])
def test_tpcxbb_query_matches_reference_session(qname):
    check_query(qname)


def test_tpcxbb_suite_split_matches_reference():
    """The 19 queries and the 11 the reference does not run (UDTF, UDF,
    python), as in the JAX package."""
    assert sorted(tpcxbb.QUERIES) == sorted(ref_tpcxbb.QUERIES)
    assert tpcxbb.UNSUPPORTED == ref_tpcxbb.UNSUPPORTED
    assert sorted(tpcxbbcases.PANDAS_REFERENCES) == sorted(tpcxbb.QUERIES)
    assert sorted(tpcxbbcases.ORDERS) == sorted(tpcxbb.QUERIES)


def test_tpcxbb_generators_match_reference():
    """The port's copy of the generators gives the JAX package's rows."""
    import pandas as pd
    from spark_rapids_tpu.models import tpcxbb_data as RD
    for name, fn in D.ALL_TABLES.items():
        pd.testing.assert_frame_equal(fn(SF, None),
                                      RD.ALL_TABLES[name](SF, None))

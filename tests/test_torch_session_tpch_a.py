"""TPC-H Q2, Q5, Q7, Q8, Q9, Q11 and Q12 through the port's
``TpuSparkSession`` against the JAX package's session, on the CPU (Q13-Q22
are in ``test_torch_session_tpch_b.py``; the helpers here serve both).

Each query (``models/tpch.QUERIES``) runs at the JAX package's default
confs in test mode (no operator may stay on the CPU) through the port's
session (``device="cpu"``: the device operators' torch code and the
kernels' plain versions), through its CPU operators
(``spark.rapids.sql.enabled=false``) and through the JAX package's
session, and against the pandas references of ``testing/tpchcases.py``
(which ``chip_smoke.py`` holds the card to), on the same seeded frames of
``models/tpch_data.py``: SF 0.002,
but SF 0.01 for Q7 and Q11, which return 1 and 0 rows at SF 0.002 (4 and
259 at 0.01), and for a second Q19, whose one row is NULL at SF 0.002.
Keys, counts, dates and strings exact, float64 at rtol 1e-9, in the
query's order with rows tied on the sort key as a set; every query must
return rows.

Frames are changed so that queries return rows (``testing/tpchcases.py``
``query_frames``): Q20's partsupp gains a row for each (part, supplier)
pair of a 1994 line of a "forest" part with a CANADA supplier, and Q22's
orders lose every order of five customers whose c_phone code is in its
list and whose balance is above its average (the generators' rows give
neither query rows at any scale); Q11's partsupp gains rows for part 1
and a GERMANY supplier that pass its threshold (at SF10 it has none
without them; at SF 0.01 they add one row to its 259).
"""

import pytest

from spark_rapids_tpu.models import tpch as ref_tpch
from spark_rapids_tpu_torch.models import tpch
from spark_rapids_tpu_torch.models import tpch_data as G
from spark_rapids_tpu_torch.session import TpuSparkSession
from spark_rapids_tpu_torch.testing import tpchcases
from spark_rapids_tpu_torch.testing.tpchcases import (
    ORDERS, in_query_order, same_rows,
)
from tests.querytest import with_tpu_session

SF = 0.002
SF_LARGE = 0.01

_FRAMES: dict = {}


def tpch_frames(sf: float) -> dict:
    """Every table at ``sf`` (generated once a process)."""
    if sf not in _FRAMES:
        _FRAMES[sf] = {n: f(sf) for n, f in G.ALL_TABLES.items()}
    return _FRAMES[sf]


def query_frames(qname: str, sf: float) -> dict:
    return tpchcases.query_frames(qname, tpch_frames(sf))


def _tables(s, fr):
    return {n: s.create_dataframe(df) for n, df in fr.items()}


def check_query(qname: str, sf: float) -> None:
    """The port's device operators and CPU operators against the JAX
    session, in test mode at the default confs."""
    fr = query_frames(qname, sf)
    want = with_tpu_session(
        lambda rs: ref_tpch.QUERIES[qname](rs, _tables(rs, fr)))
    assert len(want) > 0
    pand = tpchcases.pandas_reference(qname, fr)
    for conf in ({"spark.rapids.sql.test.enabled": True},
                 {"spark.rapids.sql.enabled": False}):
        b = TpuSparkSession.builder().device("cpu")
        for k, v in conf.items():
            b.config(k, v)
        s = b.get_or_create()
        got = tpch.QUERIES[qname](s, _tables(s, fr)).collect()
        if ORDERS[qname] is not None:
            got = in_query_order(got, ORDERS[qname])
            want = in_query_order(want, ORDERS[qname])
            pand = in_query_order(pand, ORDERS[qname])
        same_rows(got, want)
        same_rows(got, pand)


@pytest.mark.parametrize("qname,sf", [
    ("q2", SF), ("q5", SF), ("q7", SF_LARGE), ("q8", SF), ("q9", SF),
    ("q11", SF_LARGE), ("q12", SF)])
def test_tpch_query_matches_reference_session(qname, sf):
    check_query(qname, sf)

"""TPC-H Q13, Q14, Q15, Q16, Q19, Q20 and Q22 through the port's
``TpuSparkSession`` against the JAX package's session, on the CPU, as
``test_torch_session_tpch_a.py`` runs Q2-Q12 (its docstring states the
scales, the comparison and the frame changes that make Q11, Q20 and Q22
return rows). Q19 runs at SF
0.002 and at SF 0.01, where its sum is not NULL; Q20's and Q22's frame
changes are checked to give rows that the unchanged frames do not.
"""

import pytest

from spark_rapids_tpu_torch.models import tpch
from spark_rapids_tpu_torch.session import TpuSparkSession
from tests.test_torch_session_tpch_a import (
    SF, SF_LARGE, _tables, check_query, query_frames, tpch_frames,
)


@pytest.mark.parametrize("qname,sf", [
    ("q13", SF), ("q14", SF), ("q15", SF), ("q16", SF), ("q19", SF),
    ("q19", SF_LARGE), ("q20", SF), ("q22", SF)])
def test_tpch_query_matches_reference_session(qname, sf):
    check_query(qname, sf)


@pytest.mark.parametrize("qname", ["q20", "q22"])
def test_frame_changes_give_rows(qname):
    """The changed frames give Q20 and Q22 rows; the generators' frames
    give none."""
    s = (TpuSparkSession.builder().device("cpu")
         .config("spark.rapids.sql.test.enabled", True).get_or_create())
    plain = tpch.QUERIES[qname](s, _tables(s, tpch_frames(SF))).collect()
    changed = tpch.QUERIES[qname](
        s, _tables(s, query_frames(qname, SF))).collect()
    assert len(plain) == 0 and len(changed) > 0


def test_q19_at_sf_large_is_not_null():
    s = (TpuSparkSession.builder().device("cpu")
         .config("spark.rapids.sql.test.enabled", True).get_or_create())
    got = tpch.QUERIES["q19"](s, _tables(s, tpch_frames(SF_LARGE))).collect()
    assert len(got) == 1 and got.revenue.notna().all()


def test_q15_revenue_view_executes_once():
    """Q15 reads its revenue view from two branches: the plan shares one
    ``TpuReuseSubtreeExec``, as the JAX package's reuse pass does, whose
    aggregation runs once an execution (its partial and final aggregates,
    beside the maximum's two), so the view's sums and their maximum come
    from the same bits."""
    from spark_rapids_tpu_torch.exec.reuse import TpuReuseSubtreeExec
    from spark_rapids_tpu_torch.ops import aggregate
    s = (TpuSparkSession.builder().device("cpu")
         .config("spark.rapids.sql.test.enabled", True).get_or_create())
    df = tpch.QUERIES["q15"](s, _tables(s, tpch_frames(SF)))
    shared = {id(n) for n in s.physical_plan(df._plan).walk()
              if isinstance(n, TpuReuseSubtreeExec)}
    assert len(shared) == 1
    aggregate.reset_branches()
    assert len(df.collect()) == 1
    assert sum(aggregate.BRANCHES.values()) == 4

"""The aggregation branches through the port's ``TpuSparkSession`` against
the JAX package's session and pandas, on the CPU.

TPC-H Q3 and the Q18 group-by at the JAX package's default confs (no hash
branch: their unbounded keys take the sorted-payload branch), and Q10,
Q17, Q18 and Q21 (``models/tpch.py``) at SF 0.002 in test mode, through
the port's session (``device="cpu"``: the device operators run the
kernels' plain versions), through its CPU operators
(``spark.rapids.sql.enabled=false``) and through the JAX package's session
on the same frames. Q18's lineitem frame gets ten 45-unit lines for each
of a few orders, so that some orders pass its 300-unit filter. Also
``distinct``, ``GroupedData.count``, ``drop``, ``with_column_renamed`` and
string min/max/first/last, grouped and global, over dictionary and
char-slab strings. Keys, counts, dates and strings exact, float64 at rtol
1e-9; ordered queries in their order, rows tied on the sort key as a set.
"""

import numpy as np
import pandas as pd
import pytest

from spark_rapids_tpu.models import tpch as ref_tpch
from spark_rapids_tpu.sql import functions as RF
from spark_rapids_tpu_torch.models import tpch
from spark_rapids_tpu_torch.models import tpch_data as G
from spark_rapids_tpu_torch.ops import aggregate
from spark_rapids_tpu_torch.session import TpuSparkSession
from spark_rapids_tpu_torch.sql import functions as F
from tests.querytest import with_tpu_session
from tests.test_torch_joins import _assert_ordered

SF = 0.002
F64_RTOL = 1e-9

# the query's sort columns (None: one row, or compared by key)
ORDERS = {"q3": ["revenue", "o_orderdate"],
          "q10": ["revenue", "c_custkey"],
          "q17": None,
          "q18": ["o_totalprice", "o_orderdate"],
          "q21": ["numwait", "s_name"]}


@pytest.fixture(scope="module")
def frames():
    fr = {"lineitem": G.gen_lineitem(SF), "orders": G.gen_orders(SF),
          "customer": G.gen_customer(SF), "supplier": G.gen_supplier(SF),
          "part": G.gen_part(SF), "nation": G.gen_nation(),
          "region": G.gen_region()}
    # ten 45-unit lines for each of four orders: 450 > 300 units
    li = fr["lineitem"]
    keys = fr["orders"].o_orderkey.to_numpy()[[3, 77, 500, 1234]]
    extra = li.iloc[np.repeat(np.arange(4), 10)].copy()
    extra["l_orderkey"] = np.repeat(keys, 10)
    extra["l_quantity"] = 45.0
    fr["lineitem"] = pd.concat([li, extra], ignore_index=True)
    return fr


def _port_session(**conf):
    b = (TpuSparkSession.builder().device("cpu")
         .config("spark.rapids.sql.test.enabled", True))
    for k, v in conf.items():
        b.config(k, v)
    return b.get_or_create()


def _tables(s, fr):
    return {n: s.create_dataframe(df) for n, df in fr.items()}


def _ref(query, fr, conf=None):
    return with_tpu_session(lambda rs: query(rs, _tables(rs, fr)), conf=conf)


def _by_key(got, want, keys):
    """Rows compared by key: keys and integers exact, floats at 1e-9."""
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    got = got.sort_values(keys).reset_index(drop=True)
    want = want.sort_values(keys).reset_index(drop=True)
    for c in got.columns:
        g, w = got[c], want[c]
        if pd.api.types.is_float_dtype(w.dtype):
            np.testing.assert_allclose(g.to_numpy(np.float64),
                                       w.to_numpy(np.float64),
                                       rtol=F64_RTOL, err_msg=c)
        else:
            assert [str(x) for x in g] == [str(x) for x in w], c


def _same(got, want, qname):
    if ORDERS[qname] is None:
        _by_key(got, want, list(want.columns))
    else:
        _assert_ordered(got, want, ORDERS[qname])


@pytest.mark.parametrize("qname", sorted(ORDERS))
def test_query_matches_reference_session(qname, frames):
    """Q3, Q10, Q17, Q18 and Q21 at the JAX package's default confs: the
    port's device operators, then its CPU operators, against the JAX
    package's session."""
    s = _port_session()
    aggregate.reset_branches()
    got = tpch.QUERIES[qname](s, _tables(s, frames)).collect()
    assert aggregate.BRANCHES["hash"] == 0
    if qname in ("q3", "q10", "q18", "q21"):  # unbounded group keys
        assert aggregate.BRANCHES["sorted_payload"] > 0
    want = _ref(ref_tpch.QUERIES[qname], frames)
    assert len(want) > 0
    _same(got, want, qname)
    cpu = _port_session(**{"spark.rapids.sql.enabled": False})
    _same(tpch.QUERIES[qname](cpu, _tables(cpu, frames)).collect(), want,
          qname)


def test_q18_groupby_at_default_confs_and_with_hash_agg(frames):
    """The Q18 group-by (every group, and its 300-unit filter) on the
    sorted-payload branch at the default confs and on the hash branch under
    ``HASH_AGG_CONFS``: the same rows as the JAX session's."""
    def groups(F_, t, having):
        g = (t["lineitem"].group_by("l_orderkey")
             .agg(F_.sum("l_quantity").alias("sum_qty")))
        return g.filter(F_.col("sum_qty") > 300) if having else g
    li = {"lineitem": frames["lineitem"]}
    for having in (False, True):
        want = _ref(lambda rs, t: groups(RF, t, having), li)
        assert len(want) >= (4 if having else 1000)
        for conf, branch in (({}, "sorted_payload"),
                             (tpch.HASH_AGG_CONFS, "hash")):
            s = _port_session(**conf)
            aggregate.reset_branches()
            got = groups(F, _tables(s, li), having).collect()
            assert aggregate.BRANCHES[branch] > 0
            _by_key(got, want, ["l_orderkey"])
    s = _port_session()
    _by_key(tpch.q18_groupby(s, _tables(s, li)).collect(),
            _ref(lambda rs, t: groups(RF, t, True), li), ["l_orderkey"])


def test_distinct_count_drop_and_rename(frames):
    li = frames["lineitem"]
    cases = {
        "distinct": lambda F_, t: t["lineitem"].select(
            "l_orderkey", "l_suppkey").distinct(),
        "distinct_strings": lambda F_, t: t["customer"].select(
            "c_mktsegment", "c_phone").distinct(),
        "count": lambda F_, t: t["lineitem"].group_by("l_suppkey").count(),
        "drop_rename": lambda F_, t: (
            t["lineitem"].drop("l_comment", "l_tax")
            .with_column_renamed("l_suppkey", "supp")
            .group_by("supp").agg(F_.max("l_quantity").alias("mq"))),
    }
    for name, q in cases.items():
        want = _ref(lambda rs, t: q(RF, t), frames)
        for conf in ({}, {"spark.rapids.sql.enabled": False}):
            s = _port_session(**conf)
            got = q(F, _tables(s, frames)).collect()
            _by_key(got, want, list(want.columns))
    want = li[["l_orderkey", "l_suppkey"]].drop_duplicates()
    s = _port_session()
    got = cases["distinct"](F, _tables(s, frames)).collect()
    _by_key(got, want.reset_index(drop=True), ["l_orderkey", "l_suppkey"])


def _grouped_strings(F_, t):
    return (t["customer"].group_by("c_nationkey")
            .agg(F_.min("c_name").alias("min_name"),
                 F_.max("c_phone").alias("max_phone"),
                 F_.first("c_mktsegment").alias("first_seg"),
                 F_.last("c_name").alias("last_name"),
                 F_.count("c_phone").alias("n")))


def _global_strings(F_, t):
    return t["customer"].agg(F_.min("c_name").alias("min_name"),
                             F_.max("c_phone").alias("max_phone"),
                             F_.max("c_mktsegment").alias("max_seg"))


@pytest.mark.parametrize("shape", ["grouped", "global"])
def test_string_reductions_through_the_session(shape, frames):
    """String min/max/first/last, grouped (the sorted-space branch) and
    global, over char slabs (c_name, c_phone) and a dictionary
    (c_mktsegment): the port's device and CPU operators against the JAX
    session, and min/max against pandas."""
    cust = frames["customer"]
    q = _grouped_strings if shape == "grouped" else _global_strings
    keys = ["c_nationkey"] if shape == "grouped" else ["min_name"]
    want = _ref(lambda rs, t: q(RF, t), frames)
    for conf in ({}, {"spark.rapids.sql.enabled": False}):
        s = _port_session(**conf)
        aggregate.reset_branches()
        got = q(F, _tables(s, frames)).collect()
        if not conf:
            assert aggregate.BRANCHES["sorted_space" if shape == "grouped"
                                      else "single"] > 0
        _by_key(got, want, keys)
    if shape == "grouped":
        g = cust.groupby("c_nationkey")
        got = got.sort_values("c_nationkey")
        assert list(got.min_name) == list(g.c_name.min())
        assert list(got.max_phone) == list(g.c_phone.max())
    else:
        assert list(got.iloc[0]) == [cust.c_name.min(), cust.c_phone.max(),
                                     cust.c_mktsegment.max()]


def test_tags_promise_only_what_runs(frames):
    """Every operator of the new queries is tagged for the device, as the
    JAX package tags it, and the device run then raises nothing."""
    s = _port_session()
    for qname in ("q10", "q17", "q18", "q21"):
        text = tpch.QUERIES[qname](s, _tables(s, frames)).explain()
        assert "!" not in text, text

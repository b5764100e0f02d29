"""The port's ``TpuSparkSession`` against the JAX package's, on the CPU.

TPC-H Q1, Q6 and the Q18 group-by (``models/tpch.py``) at SF 0.002 run
through the port's session (``device="cpu"``: the device operators run
the kernels' plain versions) and through the JAX package's session (its
default jnp spelling, test mode on, with the same ``tpch.HASH_AGG_CONFS``;
once more with its defaults, which take its sorted-payload branch for the
Q18 key, as an independent witness), and against pandas. Keys and counts
exact, float64 sums and averages at rtol 1e-9 (sums are taken in another
order), group-by outputs compared by key. The CPU path
(``spark.rapids.sql.enabled=false``) gives the same answers; the explain
lines name the same operators with the same ``*`` marks as the JAX
package's; without the hash branch (the JAX package's defaults) the Q18
group-by takes the sorted-payload branch, equal too.
"""

import numpy as np
import pandas as pd
import pytest

from spark_rapids_tpu.models import tpch as ref_tpch
from spark_rapids_tpu.sql import functions as RF
from spark_rapids_tpu_torch.models import q1_step as Q
from spark_rapids_tpu_torch.models import tpch
from spark_rapids_tpu_torch.models import tpch_data as G
from spark_rapids_tpu_torch.obs.syncledger import SYNCS
from spark_rapids_tpu_torch.session import TpuSparkSession
from spark_rapids_tpu_torch.sql import functions as F
from tests.querytest import with_tpu_session

SF = 0.002
F64_RTOL = 1e-9
QUERIES = ["q1", "q6", "q18_groupby", "q18_groupby_all"]


@pytest.fixture(scope="module")
def lineitem():
    return G.gen_lineitem(SF)


def _port_query(qname):
    if qname == "q18_groupby_all":  # the group-by without its filter
        return lambda s, t: (t["lineitem"].group_by("l_orderkey")
                             .agg(F.sum("l_quantity").alias("sum_qty")))
    return tpch.QUERIES[qname]


def _ref_query(qname):
    if qname.startswith("q18_groupby"):
        def q(s, t):
            g = (t["lineitem"].group_by("l_orderkey")
                 .agg(RF.sum("l_quantity").alias("sum_qty")))
            return g if qname.endswith("_all") else g.filter(
                RF.col("sum_qty") > 300)
        return q
    return ref_tpch.QUERIES[qname]


def _port_session(**conf):
    b = TpuSparkSession.builder().device("cpu")
    for k, v in dict(tpch.HASH_AGG_CONFS, **conf).items():
        b.config(k, v)
    return b.get_or_create()


def _run_port(qname, df, **conf):
    s = _port_session(**conf)
    return _port_query(qname)(s, {"lineitem": s.create_dataframe(df)}
                              ).collect()


def _run_ref(qname, df, conf=tpch.HASH_AGG_CONFS):
    return with_tpu_session(lambda s: _ref_query(qname)(
        s, {"lineitem": s.create_dataframe(df)}), conf=conf)


def _pandas(qname, df):
    if qname == "q1":
        f = df[df.l_shipdate <= np.datetime64("1998-09-02")]
        ep, d, t = f.l_extendedprice, f.l_discount, f.l_tax
        f = f.assign(disc_price=ep * (1 - d), charge=ep * (1 - d) * (1 + t))
        return f.groupby(["l_returnflag", "l_linestatus"], as_index=False).agg(
            sum_qty=("l_quantity", "sum"),
            sum_base_price=("l_extendedprice", "sum"),
            sum_disc_price=("disc_price", "sum"),
            sum_charge=("charge", "sum"), avg_qty=("l_quantity", "mean"),
            avg_price=("l_extendedprice", "mean"),
            avg_disc=("l_discount", "mean"),
            count_order=("l_quantity", "size"))
    if qname == "q6":
        sd = df.l_shipdate
        m = ((sd >= np.datetime64("1994-01-01"))
             & (sd < np.datetime64("1995-01-01"))
             & (df.l_discount >= 0.05) & (df.l_discount <= 0.07)
             & (df.l_quantity < 24.0))
        return pd.DataFrame({"revenue": [
            (df.l_extendedprice[m] * df.l_discount[m]).sum()]})
    g = (df.groupby("l_orderkey", as_index=False)
         .agg(sum_qty=("l_quantity", "sum")))
    return g if qname.endswith("_all") else g[g.sum_qty > 300]


def _assert_same(got: pd.DataFrame, want: pd.DataFrame, keys):
    """Same columns and rows, compared by key: keys and integers exact,
    floats at rtol 1e-9."""
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    if keys:
        got = got.sort_values(keys).reset_index(drop=True)
        want = want.sort_values(keys).reset_index(drop=True)
    for c in got.columns:
        g, w = got[c].to_numpy(), want[c].to_numpy()
        if np.asarray(w).dtype.kind == "f":
            np.testing.assert_allclose(g.astype(np.float64),
                                       w.astype(np.float64),
                                       rtol=F64_RTOL, atol=0, err_msg=c)
        else:
            assert [str(x) for x in g] == [str(x) for x in w], c


_KEYS = {"q1": ["l_returnflag", "l_linestatus"], "q6": [],
         "q18_groupby": ["l_orderkey"], "q18_groupby_all": ["l_orderkey"]}


@pytest.mark.parametrize("qname", QUERIES)
def test_session_query_matches_reference_and_pandas(session, lineitem,
                                                    qname):
    """Device operators (plain kernel versions), test mode on: no
    operator falls back, and the answer equals the JAX package's session
    and pandas."""
    got = _run_port(qname, lineitem,
                    **{"spark.rapids.sql.test.enabled": True})
    if qname == "q18_groupby_all":
        assert len(got) > 1000
    _assert_same(got, _run_ref(qname, lineitem), _KEYS[qname])
    _assert_same(got, _pandas(qname, lineitem), _KEYS[qname])
    if qname == "q1":  # the query's own order
        assert list(got.l_returnflag + got.l_linestatus) == sorted(
            got.l_returnflag + got.l_linestatus)


@pytest.mark.parametrize("qname", QUERIES)
def test_session_query_matches_reference_default_confs(session, lineitem,
                                                       qname):
    """The JAX package's session with its own defaults (no hash branch)
    gives the port's answer too."""
    got = _run_port(qname, lineitem,
                    **{"spark.rapids.sql.test.enabled": True})
    _assert_same(got, _run_ref(qname, lineitem, conf=None), _KEYS[qname])


@pytest.mark.parametrize("qname", QUERIES)
def test_session_cpu_path_matches_device_path(lineitem, qname):
    dev = _run_port(qname, lineitem)
    cpu = _run_port(qname, lineitem, **{"spark.rapids.sql.enabled": False})
    _assert_same(cpu, dev, _KEYS[qname])


@pytest.mark.parametrize("ratio", [0.1, 0.99, 1.0])
def test_session_partial_skip_decisions(lineitem, ratio):
    """The partial aggregate's skip decided at run time, towards skipping
    and towards updating, or turned off (ratio 1.0); in 2^11-row batches,
    twice (the second execution decides from the session's ratio cache):
    every route gives the same groups."""
    want = _pandas("q18_groupby_all", lineitem)
    s = _port_session(**{"spark.rapids.sql.agg.skipAggPassReductionRatio":
                         ratio, "spark.rapids.sql.batchSizeRows": 1 << 11})
    q = _port_query("q18_groupby_all")(
        s, {"lineitem": s.create_dataframe(lineitem)})
    for _ in range(2):
        _assert_same(q.collect(), want, ["l_orderkey"])
    assert len(s.agg_ratio_cache) == (0 if ratio >= 1.0 else 1)


def _explain_ops(text: str):
    """(mark, operator name) of each operator line of an explain tree."""
    out = []
    for line in text.splitlines():
        s = line.strip()
        if s[:1] in "*!" and "Exec" in s:
            out.append((s[0], s[2:].split("(")[0]))
    return out


@pytest.mark.parametrize("qname", ["q1", "q6", "q18_groupby"])
def test_session_explain_matches_reference(session, lineitem, qname):
    s = _port_session()
    port = _explain_ops(_port_query(qname)(
        s, {"lineitem": s.create_dataframe(lineitem)}).explain())
    saved = dict(session.conf._settings)
    try:
        for k, v in tpch.HASH_AGG_CONFS.items():
            session.set_conf(k, v)
        ref = _explain_ops(_ref_query(qname)(
            session, {"lineitem": session.create_dataframe(lineitem)})
            .explain())
    finally:
        session.conf._settings = saved
    assert port == ref
    assert port and all(mark == "*" for mark, _op in port)


def test_session_q18_without_hash_agg_raises(lineitem):
    """At the JAX package's default confs (no hash branch) the Q18 key takes
    the sorted-payload branch in both packages: the same rows as the JAX
    session's and pandas'."""
    from spark_rapids_tpu_torch.ops import aggregate
    s = (TpuSparkSession.builder().device("cpu")
         .config("spark.rapids.sql.test.enabled", True).get_or_create())
    for qname in ("q18_groupby", "q18_groupby_all"):
        aggregate.reset_branches()
        got = _port_query(qname)(
            s, {"lineitem": s.create_dataframe(lineitem)}).collect()
        assert aggregate.BRANCHES["sorted_payload"] > 0
        assert aggregate.BRANCHES["hash"] == 0
        _assert_same(got, _run_ref(qname, lineitem, conf={}),
                     ["l_orderkey"])
        _assert_same(got, _pandas(qname, lineitem), ["l_orderkey"])


def test_session_syncs_match_the_runners(lineitem):
    """Warm executions with cached scans make no host sync before the
    collect but their exchanges' capacity shrink and its speculation, as
    the query runners make none: one ``exchange.shrink`` a run for each
    exchange over a partial or final aggregate (Q1's two, Q6's and the
    Q18 group-by's one) until two runs agree on its counts, then one
    ``speculation.verify`` a run. The Q18 group-by's integer key takes the
    dense composite from the plan's second run (its ok flag deferred to
    the verify), which changes the partials' counts, so its shrink learns
    over runs two and three. The first Q18 execution makes one counted
    sync per sampled batch (the runtime partial skip)."""
    batch = 1 << 12
    s = _port_session(**{"spark.rapids.sql.cacheDeviceScans": True,
                         "spark.rapids.sql.batchSizeRows": batch})
    t = {"lineitem": s.create_dataframe(lineitem)}
    runners = {"q1": Q.q1_from_batches, "q6": Q.q6_from_batches,
               "q18_groupby": Q.q18_agg_from_batches}
    cols = {"q1": Q.Q1_COLUMNS, "q6": Q.Q6_COLUMNS,
            "q18_groupby": Q.Q18_COLUMNS}
    warm = {"q1": [{"exchange.shrink": 2}, {"speculation.verify": 1}],
            "q6": [{"exchange.shrink": 1}, {"speculation.verify": 1}],
            "q18_groupby": [{"exchange.shrink": 1,
                             "speculation.verify": 1}] * 2
            + [{"speculation.verify": 1}]}
    for qname, runner in runners.items():
        df = tpch.QUERIES[qname](s, t)
        df.collect_batches()  # uploads, and learns the skip decision
        for want in warm[qname]:
            before = dict(SYNCS.syncs)
            df.collect_batches()
            assert {k: v - before.get(k, 0) for k, v in SYNCS.syncs.items()
                    if v != before.get(k, 0)} == want, qname
        batches = Q.upload_batches(lineitem, cols[qname], batch, "cpu")
        before = SYNCS.total()
        runner(batches)
        assert SYNCS.total() - before == 0, qname
    first = tpch.q18_groupby(_port_session(**{
        "spark.rapids.sql.batchSizeRows": batch}),
        {"lineitem": s.create_dataframe(lineitem)})
    before = dict(SYNCS.syncs)
    first.collect_batches()
    grew = {k: v - before.get(k, 0) for k, v in SYNCS.syncs.items()
            if v != before.get(k, 0)}
    # one upload a batch, one sample a batch until the skip decides, and
    # the exchange's shrink of the partials
    assert set(grew) == {"scan.upload", "agg.runtimeSkip",
                         "exchange.shrink"}
    assert grew["scan.upload"] == -(-len(lineitem) // batch)
    assert 1 <= grew["agg.runtimeSkip"] <= 3
    assert grew["exchange.shrink"] == 1


def test_session_range_union_limit_coalesce_expand():
    """The operators of the slice no query above reaches, device against
    CPU path: Range, Union, the limits, Coalesce, Expand (via a Project)
    and a round-robin exchange, on the device since the exchange's
    buckets route came (``repartition(n)``)."""
    from spark_rapids_tpu_torch.sql import plan as lp
    from spark_rapids_tpu_torch.session import DataFrame
    for enabled in (True, False):
        s = _port_session(**{"spark.rapids.sql.enabled": enabled})
        a = s.range(0, 50, 3, num_partitions=3)
        b = s.range(100, 90, -2, num_partitions=2)
        u = a.union(b).coalesce(2).filter(F.col("id") > 5)
        assert sorted(u.collect().id) == sorted(
            [i for i in range(0, 50, 3) if i > 5] + list(range(100, 90, -2)))
        top = u.order_by(F.col("id").desc()).limit(4).collect()
        assert list(top.id) == [100, 98, 96, 94]
        assert len(u.limit(3).collect()) == 3
        e = DataFrame(s, lp.LogicalExpand(a._plan, [
            [("id", F.col("id").expr), ("g", F.lit(0).expr)],
            [("id", (F.col("id") * 2).expr), ("g", F.lit(1).expr)]]))
        got = (e.select("g", (F.col("id") + 0).alias("id")).collect()
               .sort_values(["g", "id"]).reset_index(drop=True))
        want = pd.DataFrame({"id": list(range(0, 50, 3))
                             + [2 * i for i in range(0, 50, 3)],
                             "g": [0] * 17 + [1] * 17})
        assert list(got.id) == list(want.id)
        assert list(got.g) == list(want.g)
        # a round-robin exchange: two partitions of the device's buckets
        r = a.repartition(2).filter(F.col("id") > 5).collect()
        assert sorted(r.id) == [i for i in range(0, 50, 3) if i > 5]
    text = a.repartition(2).explain()
    assert "* CpuShuffleExchangeExec(roundrobin)" in text


def test_session_hash_slot_budget_binds_only_the_hash_branch():
    """With the hash branch on, a batch past agg.hash.maxTableSlots still
    aggregates on a dictionary key (the dictionary branch comes first, as
    Q4's o_orderpriority at SF10); on a key of the hash branch the partial
    batch splits by key hash into slices whose tables fit, each on the
    hash branch (``_bucketed_update``), and the final merge, past the
    bound, takes the sorted-payload branch, as in the JAX package."""
    n = 3000
    df = pd.DataFrame({
        "k": np.array(["a", "b", "c"], dtype=object)[np.arange(n) % 3],
        "u": np.arange(n, dtype=np.int64) * 7919 % 100_003,
        "v": np.arange(n, dtype=np.int64)})
    s = _port_session(**{"spark.rapids.sql.agg.hash.maxTableSlots": 1024,
                         "spark.rapids.sql.test.enabled": True})
    got = (s.create_dataframe(df).group_by("k")
           .agg(F.sum("v").alias("sv")).collect())
    want = df.groupby("k", as_index=False).agg(sv=("v", "sum"))
    _assert_same(got, want, ["k"])
    from spark_rapids_tpu_torch.ops import aggregate
    aggregate.reset_branches()
    got = (s.create_dataframe(df).group_by("u")
           .agg(F.sum("v").alias("sv")).collect())
    assert aggregate.BRANCHES["sorted_payload"] > 0
    assert aggregate.BRANCHES["hash"] > 0
    want = df.groupby("u", as_index=False).agg(sv=("v", "sum"))
    _assert_same(got, want, ["u"])

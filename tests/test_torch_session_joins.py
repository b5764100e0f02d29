"""Joins through the port's ``TpuSparkSession`` against the JAX package's
session and pandas, on the CPU.

TPC-H Q3 and Q4 (``models/tpch.py``) at SF 0.002, uploaded, run through
the port's session (``device="cpu"``: the device operators run the
kernels' plain versions), through the JAX package's session (its default
jnp spelling, test mode on, the same confs) and through pandas, with
``spark.rapids.sql.autoBroadcastJoinThreshold`` at its default (every
table of SF 0.002 broadcasts) and at -1 (hash exchanges and shuffled
joins). Every join type, shuffled and broadcast, on small frames with
null keys, duplicate keys, an empty build side, int32, int64 and
timestamp keys and a two-key join; USING joins; a string-key join (off
the device, with its reason); cross joins (the cartesian product) and
condition joins (the broadcast nested-loop join, off by default). Keys, counts, dates and strings exact,
float64 at rtol 1e-9; joins compare as row sets (the port's hash probe
emits rows in another order than the JAX package's sort probe), Q3's
top 10 in the query's order with ties as a set.
"""

import numpy as np
import pandas as pd
import pytest

from spark_rapids_tpu.models import tpch as ref_tpch
from spark_rapids_tpu.sql import functions as RF
from spark_rapids_tpu_torch.exec import tpujoin
from spark_rapids_tpu_torch.models import tpch
from spark_rapids_tpu_torch.models import tpch_data as G
from spark_rapids_tpu_torch.obs.syncledger import SYNCS
from spark_rapids_tpu_torch.ops import joins as join_ops
from spark_rapids_tpu_torch.ops import kernels as K
from spark_rapids_tpu_torch.session import TpuSparkSession
from spark_rapids_tpu_torch.sql import functions as F
from tests.querytest import with_cpu_session, with_tpu_session
from tests.test_torch_joins import _assert_ordered, _pandas_q3, _pandas_q4
from spark_rapids_tpu_torch.testing.signals import release_sigusr1  # noqa: F401

SF = 0.002
THRESHOLD = "spark.rapids.sql.autoBroadcastJoinThreshold"
MODES = {"broadcast": {}, "shuffled": {THRESHOLD: -1}}
JOIN_TYPES = ["inner", "left", "right", "full", "leftsemi", "leftanti"]


@pytest.fixture(scope="module")
def frames():
    return {"lineitem": G.gen_lineitem(SF), "orders": G.gen_orders(SF),
            "customer": G.gen_customer(SF)}


def _port_session(**conf):
    b = TpuSparkSession.builder().device("cpu")
    for k, v in dict(tpch.HASH_AGG_CONFS, **conf).items():
        b.config(k, v)
    return b.get_or_create()


def _tables(s, fr, num_partitions=1):
    return {n: s.create_dataframe(df, num_partitions) for n, df in fr.items()}


def _explain_ops(text: str):
    """(mark, operator name) of each operator line of an explain tree."""
    out = []
    for line in text.splitlines():
        s = line.strip()
        if s[:1] in "*!" and "Exec" in s:
            out.append((s[0], s[2:].split("(")[0]))
    return out


def _check_query(qname, got, want):
    if qname == "q3":
        _assert_ordered(got, want[list(got.columns)],
                        ["revenue", "o_orderdate"])
    else:
        assert list(got.o_orderpriority) == list(want.o_orderpriority)
        assert list(got.order_count) == list(want.order_count)


def _pandas_query(qname, fr):
    if qname == "q3":
        return _pandas_q3(fr).head(10)
    return _pandas_q4(fr)


# ---------------------------------------------------------------------------
# Q3 and Q4
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("qname", ["q3", "q4"])
def test_join_query_matches_reference_and_pandas(session, frames, qname,
                                                 mode):
    """Test mode on (no operator falls back); the explain names the
    broadcasts, or the shuffled joins; the answer equals the JAX
    package's session and pandas."""
    conf = dict(MODES[mode], **{"spark.rapids.sql.test.enabled": True})
    s = _port_session(**conf)
    df = tpch.QUERIES[qname](s, _tables(s, frames))
    ops = [op for _m, op in _explain_ops(df.explain())]
    joins = 2 if qname == "q3" else 1
    assert ops.count("CpuJoinExec") == joins
    assert ops.count("CpuBroadcastExchangeExec") == (
        joins if mode == "broadcast" else 0)
    got = df.collect()
    want = _pandas_query(qname, frames)
    assert len(want) > 1
    _check_query(qname, got, want)
    ref = with_tpu_session(lambda rs: ref_tpch.QUERIES[qname](
        rs, _tables(rs, frames)), conf=dict(tpch.HASH_AGG_CONFS,
                                            **MODES[mode]))
    _check_query(qname, got, ref)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("qname", ["q3", "q4"])
def test_join_query_explain_matches_reference(session, frames, qname, mode):
    s = _port_session(**MODES[mode])
    port = _explain_ops(tpch.QUERIES[qname](s, _tables(s, frames)).explain())
    saved = dict(session.conf._settings)
    try:
        for k, v in dict(tpch.HASH_AGG_CONFS, **MODES[mode]).items():
            session.set_conf(k, v)
        ref = _explain_ops(ref_tpch.QUERIES[qname](
            session, _tables(session, frames)).explain())
    finally:
        session.conf._settings = saved
    assert port == ref
    assert port and all(mark == "*" for mark, _op in port)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("qname", ["q3", "q4"])
def test_join_query_cpu_path_matches_device_path(frames, qname, mode):
    dev = tpch.QUERIES[qname](*_with_tables(_port_session(**MODES[mode]),
                                            frames)).collect()
    cpu = tpch.QUERIES[qname](*_with_tables(_port_session(
        **dict(MODES[mode], **{"spark.rapids.sql.enabled": False})),
        frames)).collect()
    _check_query(qname, cpu, dev)


def _with_tables(s, fr):
    return s, _tables(s, fr)


@pytest.mark.parametrize("mode", list(MODES))
def test_join_query_syncs(frames, mode):
    """Warm executions over cached scans with capacity speculation off
    (the runs read their sizes exactly): Q3 makes one counted sync a join
    (its expansion totals, with the dense route's verification flag);
    Q4's semi join takes the dense route (l_orderkey's scan statistics
    bound it) and makes one, its verification, read once for all stream
    batches; a broadcast join over P stream partitions makes one a
    partition. Both queries also make one ``exchange.shrink`` for each of
    their two exchanges over a padded producer (the partial aggregate's
    and the final aggregate's range exchange), which read their live rows
    so the consumers run at the real size.
    ``test_join_query_syncs_speculated`` holds the default confs."""
    s = _port_session(**dict(MODES[mode], **{
        "spark.rapids.sql.cacheDeviceScans": True,
        "spark.rapids.sql.adaptiveCapacity.enabled": False}))
    for parts in (1, 4):
        t = _tables(s, frames, parts)
        for qname, most in (("q3", 2), ("q4", 1)):
            df = tpch.QUERIES[qname](s, t)
            df.collect_batches()  # uploads, and learns the skip decision
            before = SYNCS.total()
            df.collect_batches()
            syncs = SYNCS.total() - before
            # Q3's broadcast joins both stream customer's P partitions;
            # Q4's verification is read once for its shared build
            per_join = parts if mode == "broadcast" and qname == "q3" \
                else 1
            assert syncs == most * per_join + 2, (qname, parts)


@pytest.mark.parametrize("mode", list(MODES))
def test_join_query_syncs_speculated(frames, mode):
    """The default confs: once a plan's join sizes and shrink counts are
    cached and its shrink counts proved stable over two runs, a warm run
    makes one counted sync, ``speculation.verify``, for every join and
    exchange of every partition; the answer stays the cold run's."""
    s = _port_session(**dict(MODES[mode], **{
        "spark.rapids.sql.cacheDeviceScans": True}))
    for parts in (1, 4):
        t = _tables(s, frames, parts)
        for qname in ("q3", "q4"):
            df = tpch.QUERIES[qname](s, t)
            want = df.collect()
            # a broadcast semi join's P stream partitions learn their
            # dense flags one run each (its build verifies once a run)
            for _ in range(2 + (parts if qname == "q4" else 0)):
                df.collect_batches()
            before = dict(SYNCS.syncs)
            df.collect_batches()
            grew = {k: v - before.get(k, 0) for k, v in SYNCS.syncs.items()
                    if v != before.get(k, 0)}
            assert grew == {"speculation.verify": 1}, (qname, parts, grew)
            _check_query(qname, want, df.collect())
            assert s.capacity_spec_reruns == 0


# ---------------------------------------------------------------------------
# Join types on small frames
# ---------------------------------------------------------------------------

def _nullable(values, null, dtype):
    s = pd.Series(values).astype(dtype)
    s[null] = pd.NA if dtype != "datetime64[s]" else pd.NaT
    return s


def _key_column(rng, n, lo, hi, kind):
    v = rng.integers(lo, hi, n)
    null = rng.random(n) < 0.15
    if kind == "date":
        days = np.datetime64("1995-01-01", "s") + v * np.timedelta64(86400,
                                                                     "s")
        return _nullable(days, null, "datetime64[s]")
    return _nullable(v, null, "Int32" if kind == "int32" else "Int64")


def _join_sides(kind):
    """Left and right frames: keys lk(,lk2) and rk(,rk2) with nulls and
    duplicates, a float, a nullable int and a string payload each."""
    rng = np.random.default_rng(17)
    nl, nr = 40, 0 if kind == "empty_build" else 30
    keykind = kind if kind in ("int32", "date") else "int64"

    def side(p, n, lo, hi):
        cols = {f"{p}k": _key_column(rng, n, lo, hi, keykind)}
        if kind == "two_keys":
            cols[f"{p}k2"] = _nullable(rng.integers(0, 3, n),
                                       rng.random(n) < 0.1, "Int32")
        cols[f"{p}f"] = rng.standard_normal(n)
        cols[f"{p}v"] = _nullable(rng.integers(-50, 50, n),
                                  rng.random(n) < 0.2, "Int64")
        cols[f"{p}s"] = np.array(["ab", "c", "de", None], dtype=object)[
            rng.integers(0, 4, n)]
        return pd.DataFrame(cols)
    return side("l", nl, 0, 12), side("r", nr, 5, 18)


def _keys(kind):
    return (["lk", "lk2"], ["rk", "rk2"]) if kind == "two_keys" else (
        ["lk"], ["rk"])


def _cell(x):
    if x is None or x is pd.NA or x is pd.NaT:
        return "NULL"
    if isinstance(x, float) and np.isnan(x):
        return "NULL"
    if isinstance(x, (pd.Timestamp, np.datetime64)):
        return str(pd.Timestamp(x))
    if isinstance(x, (int, float, np.integer, np.floating)):
        return repr(float(x))
    return str(x)


def _rows(df):
    """The frame's rows as a sorted list of string tuples (nulls as
    'NULL', numbers through float64)."""
    return sorted(tuple(_cell(x) for x in row)
                  for row in df.astype(object).itertuples(index=False))


def _pandas_join(l_df, r_df, jt, lkeys, rkeys):
    """pandas oracle: null keys never match."""
    lk = l_df.assign(_li=np.arange(len(l_df)))
    rk = r_df.assign(_ri=np.arange(len(r_df)))
    lnn = lk[lk[lkeys].notna().all(axis=1)]
    rnn = rk[rk[rkeys].notna().all(axis=1)]
    inner = lnn.merge(rnn, left_on=lkeys, right_on=rkeys)
    if jt in ("leftsemi", "leftanti"):
        hit = l_df.index.isin(inner._li)
        return l_df[hit if jt == "leftsemi" else ~hit]
    parts = [inner]
    if jt in ("left", "full"):
        parts.append(lk[~lk._li.isin(inner._li)])
    if jt in ("right", "full"):
        parts.append(rk[~rk._ri.isin(inner._ri)])
    out = pd.concat(parts, ignore_index=True).drop(columns=["_li", "_ri"])
    return out[list(l_df.columns) + list(r_df.columns)]


@pytest.mark.parametrize("kind", ["int64", "int32", "date", "two_keys",
                                  "empty_build"])
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("jt", JOIN_TYPES)
def test_join_type_matches_reference_and_pandas(session, jt, mode, kind):
    l_df, r_df = _join_sides(kind)
    lkeys, rkeys = _keys(kind)
    conf = dict(MODES[mode], **{"spark.rapids.sql.test.enabled": True})
    s = _port_session(**conf)
    df = s.create_dataframe(l_df).join(s.create_dataframe(r_df),
                                       left_on=lkeys, right_on=rkeys, how=jt)
    ops = [op for _m, op in _explain_ops(df.explain())]
    assert ("CpuBroadcastExchangeExec" in ops) == (
        mode == "broadcast" and jt != "full")
    got = df.collect()
    want = _pandas_join(l_df, r_df, jt, lkeys, rkeys)
    assert list(got.columns) == list(want.columns)
    assert _rows(got) == _rows(want)
    ref = with_tpu_session(lambda rs: rs.create_dataframe(l_df).join(
        rs.create_dataframe(r_df), left_on=lkeys, right_on=rkeys, how=jt),
        conf=MODES[mode])
    assert _rows(got) == _rows(ref)
    if kind != "empty_build" and jt in ("inner", "full"):
        assert len(want) > 5


@pytest.mark.parametrize("how", ["inner", "left", "right", "leftsemi",
                                 "leftanti", "left_outer", "semi"])
def test_using_join_matches_reference(session, how):
    """join(on=...): one output column per key (the right side's value
    for a right join), as Spark resolves USING."""
    l_df, r_df = _join_sides("two_keys")
    l_df = l_df.rename(columns={"lk": "k", "lk2": "k2"})
    r_df = r_df.rename(columns={"rk": "k", "rk2": "k2"})
    s = _port_session(**{"spark.rapids.sql.test.enabled": True})
    got = s.create_dataframe(l_df).join(s.create_dataframe(r_df),
                                        on=["k", "k2"], how=how).collect()
    ref = with_tpu_session(lambda rs: rs.create_dataframe(l_df).join(
        rs.create_dataframe(r_df), on=["k", "k2"], how=how))
    assert list(got.columns) == list(ref.columns)
    assert _rows(got) == _rows(ref)
    assert len(got) > 0


def test_unported_joins_raise(session):
    """The joins this test pinned as raising before they were ported (the
    cross join, the condition join and, with a string-capable Coalesce on
    the device, the full outer USING join) now give the JAX package's
    rows."""
    s = _port_session()
    a_df = pd.DataFrame({"k": [1, 2], "x": [3, 4]})
    b_df = pd.DataFrame({"k2": [2, 3], "y": [5, 3]})
    a, b = s.create_dataframe(a_df), s.create_dataframe(b_df)
    bk = b_df.rename(columns={"k2": "k"})
    for got, ref in ((a.join(b), lambda rs: rs.create_dataframe(a_df).join(
                          rs.create_dataframe(b_df))),
                     (a.join(b, on=F.col("x") < F.col("y")),
                      lambda rs: rs.create_dataframe(a_df).join(
                          rs.create_dataframe(b_df),
                          on=RF.col("x") < RF.col("y"))),
                     (a.join(s.create_dataframe(bk), on="k", how="full"),
                      lambda rs: rs.create_dataframe(a_df).join(
                          rs.create_dataframe(bk), on="k", how="full"))):
        want = with_cpu_session(ref)
        assert _rows(got.collect()) == _rows(want)
        assert len(want) > 0


def _cross_sides():
    rng = np.random.default_rng(5)
    left = pd.DataFrame({"a": rng.integers(0, 20, 40),
                         "ls": rng.choice(["x", "y", "zz"], 40),
                         "lf": rng.uniform(0, 1, 40)})
    left.loc[3, "a"] = None
    left["a"] = left["a"].astype("Int64")
    right = pd.DataFrame({"b": rng.integers(0, 20, 7),
                          "rs": [f"r{i}" for i in range(7)]})
    return left, right


@pytest.mark.parametrize("parts", [1, 3])
def test_cross_join_matches_reference(session, parts):
    """``on=None``: every left row with every right row, through a
    single-partition exchange on each side and the cartesian product (on
    the device in test mode), equal to the JAX session and pandas; one
    counted sync a join in a warm execution (cached scans)."""
    l_df, r_df = _cross_sides()
    s = _port_session(**{"spark.rapids.sql.test.enabled": True,
                         "spark.rapids.sql.cacheDeviceScans": True})
    df = s.create_dataframe(l_df, parts).join(s.create_dataframe(r_df))
    assert "* CpuCartesianProductExec" in df.explain()
    got = df.collect()
    want = with_tpu_session(lambda rs: rs.create_dataframe(l_df, parts)
                            .join(rs.create_dataframe(r_df)))
    pand = l_df.merge(r_df, how="cross")
    assert list(got.columns) == list(want.columns) == list(pand.columns)
    assert _rows(got) == _rows(want) == _rows(pand)
    plan = s.physical_plan(df._plan)
    assert any(isinstance(n, tpujoin.TpuCartesianProductExec)
               for n in plan.walk())
    before = SYNCS.total()
    df.collect_batches()
    assert SYNCS.total() - before == 1


def test_cross_join_prunes_and_filters(session):
    """A cross join under a filter on both sides' columns and a
    projection (the TPC-H scalar-subquery shape): pruned inputs, the
    JAX session's rows."""
    l_df, r_df = _cross_sides()
    s = _port_session(**{"spark.rapids.sql.test.enabled": True})

    def q(M, sess):
        total = sess.create_dataframe(r_df).agg(
            M.avg("b").alias("avg_b"))
        return (sess.create_dataframe(l_df).join(total)
                .filter(M.col("a") > M.col("avg_b")).select("a", "ls"))
    got = q(F, s).collect()
    want = with_tpu_session(lambda rs: q(RF, rs))
    assert _rows(got) == _rows(want)
    assert len(got) > 0


@pytest.mark.parametrize("enabled", [False, True])
def test_condition_join_nested_loop_rule(session, enabled):
    """A join on a condition plans a broadcast nested-loop join. Its rule
    is off by default, as in the JAX package: the plan stays on the CPU
    with the conf named as the reason (test mode raises); with
    ``spark.rapids.sql.exec.BroadcastNestedLoopJoinExec=true`` it runs on
    the device (the cross product, then one B1 filter). Both equal the
    JAX session's rows and pandas'."""
    l_df, r_df = _cross_sides()
    key = "spark.rapids.sql.exec.BroadcastNestedLoopJoinExec"
    conf = {"spark.rapids.sql.test.enabled": True}
    if enabled:
        conf[key] = True
    s = _port_session(**conf)

    def q(M, sess):
        return sess.create_dataframe(l_df, 2).join(
            sess.create_dataframe(r_df),
            on=(M.col("a") < M.col("b")) & (M.col("ls") != "zz"))
    df = q(F, s)
    text = df.explain()
    if enabled:
        assert "* CpuBroadcastNestedLoopJoinExec(inner)" in text
        got = df.collect()
        assert any(isinstance(n, tpujoin.TpuBroadcastNestedLoopJoinExec)
                   for n in s.physical_plan(df._plan).walk())
    else:
        assert (f"BroadcastNestedLoopJoinExec is disabled by conf {key}"
                in text)
        with pytest.raises(AssertionError, match="disabled by conf"):
            df.collect()
        s.set_conf("spark.rapids.sql.test.enabled", False)
        got = df.collect()
    ref_conf = {key: True} if enabled else None
    want = with_tpu_session(
        lambda rs: q(RF, rs), conf=ref_conf,
        allow_non_tpu=None if enabled else [
            "CpuBroadcastNestedLoopJoinExec", "CpuBroadcastExchangeExec"])
    pand = l_df.merge(r_df, how="cross")
    pand = pand[(pand.a < pand.b).fillna(False) & (pand.ls != "zz")]
    assert _rows(got) == _rows(want) == _rows(pand)
    assert len(got) > 0


def test_string_key_join_stays_on_cpu(session):
    """A string key, once tagged off the device (ROADMAP A.4), now takes
    the union-lexsort probe: in test mode, broadcast and shuffled, the
    join runs on the device and gives the JAX package's answer and that
    of the port's CPU operators."""
    l_df, r_df = _join_sides("int64")
    for mode in MODES:
        s = _port_session(**dict(MODES[mode], **{
            "spark.rapids.sql.test.enabled": True}))
        df = s.create_dataframe(l_df).join(s.create_dataframe(r_df),
                                           left_on="ls", right_on="rs")
        assert "! " not in df.explain()
        tpujoin.reset_routes()
        got = df.collect()
        assert tpujoin.ROUTES["union"] > 0
        cpu = _port_session(**{"spark.rapids.sql.enabled": False})
        on_cpu = cpu.create_dataframe(l_df).join(
            cpu.create_dataframe(r_df), left_on="ls",
            right_on="rs").collect()
        ref = with_tpu_session(lambda rs: rs.create_dataframe(l_df).join(
            rs.create_dataframe(r_df), left_on="ls", right_on="rs"),
            conf=MODES[mode])
        want = with_cpu_session(lambda rs: rs.create_dataframe(l_df).join(
            rs.create_dataframe(r_df), left_on="ls", right_on="rs"))
        assert _rows(got) == _rows(on_cpu) == _rows(ref) == _rows(want)
        assert len(got) > 5


def test_broadcast_builds_once_per_execution(monkeypatch):
    """A broadcast join over four stream partitions builds its table once
    an execution (one B3 call, or one dense table where the scan
    statistics bound the key, as here) and probes it from every
    partition."""
    l_df, r_df = _join_sides("int64")
    builds = []

    def counting(real):
        def run(*args, **kwargs):
            builds.append(1)
            return real(*args, **kwargs)
        return run
    monkeypatch.setattr(K, "hash_join_build", counting(K.hash_join_build))
    monkeypatch.setattr(join_ops, "dense_build",
                        counting(join_ops.dense_build))
    s = _port_session(**{"spark.rapids.sql.test.enabled": True})
    df = s.create_dataframe(l_df, 4).join(s.create_dataframe(r_df),
                                          left_on="lk", right_on="rk")
    assert "CpuBroadcastExchangeExec" in df.explain()
    for _ in range(2):
        before = len(builds)
        got = df.collect()
        assert len(builds) - before == 1
    assert _rows(got) == _rows(_pandas_join(l_df, r_df, "inner", ["lk"],
                                            ["rk"]))
    plan = s.physical_plan(df._plan)
    assert any(isinstance(n, tpujoin.TpuBroadcastHashJoinExec)
               for n in plan.walk())

"""Adaptive query execution (``sql/adaptive/``) of the port, on the CPU,
against the JAX package.

The JAX package's ``tests/test_adaptive.py`` (25 cases) runs here against
the port's modules and session (``device="cpu"``): the rules' planning
math, the canonical hash, stage cutting, coalescing, broadcast demotion,
skew splitting, the shuffle-skew record, the shuffle manager's ranged
reads, the planner's hardened estimates and the partial-NULL merge
regression, each query through the port's device operators and its CPU
operators (and, for the workload cases, the JAX session) on the same
seeded frames. Then exact parity: ``hash_partition_ids`` bit-equal to the
JAX package's over every fixed-width dtype with nulls and over strings,
and ``rules.*`` the same specs and decision records on the same sizes;
and with default confs the converted plans of TPC-H Q1, Q6, Q3, Q2, Q11
and Q17 hold the JAX session's operator sequence (Q2, Q11 and Q17 one
reuse node over their shared base).
"""

import numpy as np
import pandas as pd
import pytest

from spark_rapids_tpu.sql import functions as RF
from spark_rapids_tpu_torch.session import TpuSparkSession
from spark_rapids_tpu_torch.sql import functions as F
from spark_rapids_tpu_torch.testing.datagen import gen_skewed_join_frames
from tests.querytest import assert_frames_equal, with_tpu_session

AQE_ON = {"spark.rapids.sql.adaptive.enabled": True}


def _session(**conf):
    b = TpuSparkSession.builder().device("cpu").config(
        "spark.rapids.sql.test.enabled", True)
    for k, v in conf.items():
        b.config(k, v)
    return b.get_or_create()


def _on(s, q, conf=None):
    saved = dict(s.conf._settings)
    try:
        for k, v in (conf or {}).items():
            s.set_conf(k, v)
        return q(s).collect()
    finally:
        s.conf._settings = saved


def _cpu(s, q, conf=None):
    return _on(s, q, dict(conf or {}, **{
        "spark.rapids.sql.enabled": False,
        "spark.rapids.sql.test.enabled": False}))


def _tpu_and_cpu(q, conf, ignore_order=True):
    """A fresh session's device run of ``q`` (the session kept for its
    ``last_aqe``) equal to its CPU run."""
    s = _session()
    tpu = _on(s, q, conf)
    aqe = s.last_aqe
    assert_frames_equal(tpu, _cpu(s, q, conf), ignore_order=ignore_order,
                        approx=True)
    s.last_aqe = aqe
    return tpu, s


# ---------------------------------------------------------------------------
# rule planning math (pure, no execution)
# ---------------------------------------------------------------------------

def test_coalesce_groups_merges_adjacent_below_target():
    from spark_rapids_tpu_torch.sql.adaptive.rules import coalesce_groups
    groups = coalesce_groups([10, 10, 10, 100, 10, 10], min_size=30)
    assert groups == [[0, 1, 2], [3], [4, 5]]
    groups = coalesce_groups([10, 10, 10], min_size=100, isolated={1})
    assert groups == [[0], [1], [2]]
    assert coalesce_groups([1, 1, 1], min_size=100) == [[0, 1, 2]]
    assert coalesce_groups([], min_size=10) == []


def test_split_map_ranges_targets_chunks():
    from spark_rapids_tpu_torch.sql.adaptive.rules import split_map_ranges
    assert split_map_ranges([10, 10, 10, 10], target=20) == [(0, 2), (2, 4)]
    assert split_map_ranges([5, 5], target=100) == [(0, 2)]
    assert split_map_ranges([30, 1, 30], target=20) == [(0, 1), (1, 3)]


def test_skewed_partitions_needs_both_factor_and_threshold():
    from spark_rapids_tpu_torch.sql.adaptive.rules import skewed_partitions
    sizes = [10, 10, 10, 200]
    assert skewed_partitions(sizes, factor=5.0, threshold=50) == {3}
    assert skewed_partitions(sizes, factor=5.0, threshold=1000) == set()
    assert skewed_partitions([], 5.0, 1) == set()


def test_broadcast_sides_by_join_type():
    from spark_rapids_tpu_torch.sql.adaptive.rules import broadcast_sides
    assert broadcast_sides("inner") == (True, True)
    assert broadcast_sides("left") == (False, True)
    assert broadcast_sides("right") == (True, False)
    assert broadcast_sides("leftsemi") == (False, True)
    assert broadcast_sides("full") == (False, False)


class _Conf:
    adaptive_coalesce_enabled = True
    adaptive_coalesce_min_size = 40
    adaptive_skew_enabled = True
    adaptive_skew_factor = 3.0
    adaptive_skew_threshold = 50


def _stages(mod, stats_mod, lmaps, rmaps):
    left = mod.ShuffleStage(1, None, ("hash", [0], len(lmaps[0])),
                            [[None] * len(lmaps[0])] * len(lmaps),
                            stats_mod.MapOutputStatistics(lmaps))
    right = mod.ShuffleStage(2, None, ("hash", [0], len(rmaps[0])),
                             [[None] * len(rmaps[0])] * len(rmaps),
                             stats_mod.MapOutputStatistics(rmaps))
    return left, right


def test_join_specs_align_and_cover_all_partitions():
    from spark_rapids_tpu_torch.sql.adaptive import stages, stats
    from spark_rapids_tpu_torch.sql.adaptive.rules import join_specs
    from spark_rapids_tpu_torch.sql.adaptive.stages import (
        CoalescedSpec, PartialSpec,
    )
    lmaps = [[10, 10, 100, 10], [10, 10, 100, 10], [10, 10, 100, 10]]
    rmaps = [[5, 5, 5, 5]]
    left, right = _stages(stages, stats, lmaps, rmaps)
    ls, rs = join_specs(left, right, "inner", _Conf())
    assert len(ls) == len(rs)
    partials = [s for s in ls if isinstance(s, PartialSpec)]
    assert partials and all(s.pid == 2 for s in partials)
    for lspec, rspec in zip(ls, rs):
        if isinstance(lspec, PartialSpec):
            assert isinstance(rspec, CoalescedSpec) and rspec.pids == (2,)
    covered = []
    for s in ls:
        covered.extend(s.pids if isinstance(s, CoalescedSpec) else [s.pid])
    assert sorted(set(covered)) == [0, 1, 2, 3]
    ranges = sorted((s.map_lo, s.map_hi) for s in partials)
    assert ranges[0][0] == 0 and ranges[-1][1] == 3
    for (_a, b), (c, _d) in zip(ranges, ranges[1:]):
        assert b == c


def test_canonical_hash_partition_is_dtype_stable():
    """Masked (Float64) and plain (float64) frames with equal values land
    every row in the same partition: join sides mix dtypes."""
    from spark_rapids_tpu_torch.sql.adaptive.stats import hash_partition_ids
    plain = pd.DataFrame({"k": np.array([1.0, 2.0, -0.0, 0.0])})
    masked = pd.DataFrame({"k": pd.array([1.0, 2.0, -0.0, 0.0],
                                         dtype="Float64")})
    np.testing.assert_array_equal(hash_partition_ids(plain, [0], 8),
                                  hash_partition_ids(masked, [0], 8))


# ---------------------------------------------------------------------------
# exact parity with the JAX package
# ---------------------------------------------------------------------------

def _parity_frame(rng, n=500):
    def nulls(s):
        return s.mask(pd.Series(rng.random(n) < 0.15))
    return pd.DataFrame({
        "i8": nulls(pd.Series(rng.integers(-100, 100, n)).astype("Int8")),
        "i16": nulls(pd.Series(rng.integers(-3e4, 3e4, n)).astype("Int16")),
        "i32": nulls(pd.Series(rng.integers(-2e9, 2e9, n)).astype("Int32")),
        "i64": nulls(pd.Series(rng.integers(-2**62, 2**62, n))
                     .astype("Int64")),
        "f32": nulls(pd.Series(rng.normal(size=n).astype(np.float32))
                     .astype("Float32")),
        "f64": nulls(pd.Series(np.where(rng.random(n) < 0.1, -0.0,
                                        rng.normal(size=n)))
                     .astype("Float64")),
        "b": nulls(pd.Series(rng.random(n) < 0.5).astype("boolean")),
        "d": pd.Series(pd.to_datetime("1995-01-01") + pd.to_timedelta(
            rng.integers(0, 3000, n), unit="D")).dt.date,
        "ts": pd.Series(pd.to_datetime("1995-01-01") + pd.to_timedelta(
            rng.integers(0, 10**9, n), unit="s")),
        "s": nulls(pd.Series([f"v{x}" for x in rng.integers(0, 50, n)],
                             dtype=object)),
    })


@pytest.mark.parametrize("col", ["i8", "i16", "i32", "i64", "f32", "f64",
                                 "b", "d", "ts", "s"])
def test_hash_partition_ids_bit_equal_to_reference(rng, col):
    from spark_rapids_tpu.sql.adaptive import stats as ref_stats
    from spark_rapids_tpu_torch.sql.adaptive import stats
    df = _parity_frame(rng)
    idx = [list(df.columns).index(col)]
    for n in (2, 7, 64):
        np.testing.assert_array_equal(
            stats.hash_partition_ids(df, idx, n),
            ref_stats.hash_partition_ids(df, idx, n))
    both = [idx[0], list(df.columns).index("i32")]
    np.testing.assert_array_equal(stats.hash_partition_ids(df, both, 5),
                                  ref_stats.hash_partition_ids(df, both, 5))
    for a, b in zip(stats.split_frame(df, both, 5),
                    ref_stats.split_frame(df, both, 5)):
        pd.testing.assert_frame_equal(a, b)


@pytest.mark.parametrize("join_type", ["inner", "left", "right", "leftsemi",
                                       "full"])
def test_rules_same_specs_and_decisions_as_reference(join_type):
    from spark_rapids_tpu.sql.adaptive import rules as ref_rules
    from spark_rapids_tpu.sql.adaptive import stages as ref_stages
    from spark_rapids_tpu.sql.adaptive import stats as ref_stats
    from spark_rapids_tpu_torch.sql.adaptive import rules, stages, stats
    rng = np.random.default_rng(3)
    lmaps = rng.integers(0, 60, (4, 8)).tolist()
    lmaps[1][5] = lmaps[2][5] = 900
    rmaps = rng.integers(0, 60, (3, 8)).tolist()
    rmaps[0][2] = rmaps[2][2] = 700
    pl, pr = _stages(stages, stats, lmaps, rmaps)
    rl, rr = _stages(ref_stages, ref_stats, lmaps, rmaps)
    got_d, want_d = [], []
    got = rules.join_specs(pl, pr, join_type, _Conf(), got_d)
    want = ref_rules.join_specs(rl, rr, join_type, _Conf(), want_d)
    assert [list(map(repr, g)) for g in got] == \
        [list(map(repr, w)) for w in want]
    assert got_d == want_d
    got_d, want_d = [], []
    assert (list(map(repr, rules.solo_specs(pl, _Conf(), got_d)))
            == list(map(repr, ref_rules.solo_specs(rl, _Conf(), want_d))))
    assert got_d == want_d
    assert rules.broadcast_sides(join_type) == \
        ref_rules.broadcast_sides(join_type)
    sizes = pl.stats.bytes_by_partition
    assert rules.skewed_partitions(sizes, 2.0, 100) == \
        ref_rules.skewed_partitions(sizes, 2.0, 100)
    assert rules.coalesce_groups(sizes, 150, {5}) == \
        ref_rules.coalesce_groups(sizes, 150, {5})
    assert rules.split_map_ranges(pl.stats.partition_map_sizes(5), 500) == \
        ref_rules.split_map_ranges(rl.stats.partition_map_sizes(5), 500)


_PLAN_FRAMES: dict = {}


@pytest.mark.parametrize("qname", ["q1", "q6", "q3", "q2", "q11", "q17"])
def test_default_plans_match_reference_operator_sequence(qname):
    """With default confs (capacity speculation, both filter fusions,
    dense keys, shared-subtree pruning) the converted plan's operator
    classes, in tree order, are the JAX session's; Q2, Q11 and Q17 hold
    one reuse node over their shared base, and the answers agree."""
    from spark_rapids_tpu.models import tpch as ref_tpch
    from spark_rapids_tpu.session import TpuSparkSession as RefSession
    from spark_rapids_tpu_torch.models import tpch
    from spark_rapids_tpu_torch.models import tpch_data as G
    from spark_rapids_tpu_torch.testing import tpchcases
    if not _PLAN_FRAMES:
        _PLAN_FRAMES.update({n: f(0.002) for n, f in G.ALL_TABLES.items()})
    fr = tpchcases.query_frames(qname, _PLAN_FRAMES)
    rs = RefSession.active()
    rs.capture_plans = True
    try:
        want = with_tpu_session(lambda r: ref_tpch.QUERIES[qname](
            r, {n: r.create_dataframe(d) for n, d in fr.items()}))
        ref_plan = rs.captured_plans[-1]
    finally:
        rs.capture_plans = False
        rs.captured_plans.clear()
    s = _session()
    got = tpch.QUERIES[qname](s, {n: s.create_dataframe(d)
                                  for n, d in fr.items()}).collect()
    assert ([type(n).__name__ for n in s.last_plan.walk()]
            == [type(n).__name__ for n in ref_plan.walk()])
    assert_frames_equal(got, want, ignore_order=True, approx=True)
    reuse = {id(n) for n in s.last_plan.walk()
             if type(n).__name__ == "TpuReuseSubtreeExec"}
    assert len(reuse) == (1 if qname in ("q2", "q11", "q17") else 0)


# ---------------------------------------------------------------------------
# stage cutting
# ---------------------------------------------------------------------------

def _join_agg(fns, s, n_left=120, n_right=8):
    left = pd.DataFrame({"k": np.arange(n_left) % n_right,
                         "v": np.arange(n_left, dtype=np.float64)})
    right = pd.DataFrame({"k2": np.arange(n_right),
                          "w": np.arange(n_right, dtype=np.float64) * 3})
    lt = s.create_dataframe(left, 3)
    rt = s.create_dataframe(right, 2)
    return (lt.join(rt, left_on=["k"], right_on=["k2"])
            .group_by("k").agg(fns.sum(fns.col("v") * fns.col("w"))
                               .alias("sv"))
            .order_by("k"))


def _join_agg_query(s):
    return _join_agg(F, s)


def test_aqe_off_is_legacy_plan():
    s = _session()
    _cpu(s, _join_agg_query)
    legacy = s.last_plan.tree_string()
    _cpu(s, _join_agg_query, {"spark.rapids.sql.adaptive.enabled": False})
    assert s.last_plan.tree_string() == legacy
    # the CPU path never adapts; the device path cuts stages
    _on(s, _join_agg_query, AQE_ON)
    adaptive = s.last_plan.tree_string()
    assert "AqeShuffleReadExec" in adaptive
    _on(s, _join_agg_query)
    assert "AqeShuffleReadExec" not in s.last_plan.tree_string()


def test_aqe_stage_cutting_counts():
    """The join + aggregate query cuts into 3 stages (two join sides and
    the aggregate's exchange) with the broadcast disabled statically, one
    counted ``aqe.stageFetch`` a stage, equal to the JAX session."""
    from spark_rapids_tpu_torch.obs.syncledger import SYNCS
    conf = dict(AQE_ON, **{"spark.rapids.sql.autoBroadcastJoinThreshold":
                           -1})
    before = SYNCS.syncs.get("aqe.stageFetch", 0)
    out, s = _tpu_and_cpu(_join_agg_query, conf, ignore_order=False)
    assert len(out) == 8
    assert s.last_aqe is not None and s.last_aqe["stages"] == 3
    assert SYNCS.syncs.get("aqe.stageFetch", 0) - before == 3
    ref = with_tpu_session(lambda r: _join_agg(RF, r), conf=conf)
    assert_frames_equal(out, ref, approx=True)


def test_aqe_coalesces_small_partitions():
    """Tiny shuffles under minPartitionSize collapse to one read task, and
    the decision is journaled (the flight recorder)."""
    from spark_rapids_tpu_torch.obs.events import EVENTS
    conf = dict(AQE_ON, **{
        "spark.rapids.sql.autoBroadcastJoinThreshold": -1,
        "spark.rapids.sql.shuffle.partitions": 4})
    s = _session()
    _on(s, _join_agg_query, conf)
    coalesces = [d for d in s.last_aqe["decisions"]
                 if d["rule"] == "coalesce"]
    assert coalesces and all(d["toPartitions"] < d["fromPartitions"]
                             for d in coalesces)
    kinds = [e["kind"] for e in EVENTS.flight_events()]
    assert "aqeStageStats" in kinds and "aqeCoalesce" in kinds \
        and "shuffleSkew" in kinds


# ---------------------------------------------------------------------------
# dynamic broadcast conversion
# ---------------------------------------------------------------------------

def _demotable(fns, s):
    big = pd.DataFrame({"k": np.arange(600) % 40,
                        "v": np.arange(600, dtype=np.float64)})
    dim = pd.DataFrame({"k2": np.arange(40), "tag": np.arange(40) % 4,
                        "w": np.arange(40, dtype=np.float64)})
    lt = s.create_dataframe(big, 3)
    rt = s.create_dataframe(dim, 2).filter(fns.col("tag") == 0)
    return (lt.join(rt, left_on=["k"], right_on=["k2"])
            .agg(fns.sum(fns.col("v") + fns.col("w")).alias("s")))


def _demotable_query(s):
    return _demotable(F, s)


def test_aqe_broadcast_demotion():
    conf = dict(AQE_ON, **{"spark.rapids.sql.autoBroadcastJoinThreshold":
                           700})
    out, s = _tpu_and_cpu(_demotable_query, conf)
    demotions = [d for d in s.last_aqe["decisions"]
                 if d["rule"] == "broadcastDemotion"]
    assert demotions, s.last_aqe["decisions"]
    d = demotions[0]
    assert d["measuredBytes"] <= 700 and d["elidedStreamShuffle"]
    assert "TpuBroadcastExchangeExec" in s.last_aqe["plan"]
    # the stream side's shuffle was elided: the only stage is the build
    assert s.last_aqe["stages"] == 1
    ref = with_tpu_session(lambda r: _demotable(RF, r), conf=conf)
    assert_frames_equal(out, ref, approx=True)


def test_aqe_no_demotion_when_measured_above_threshold():
    conf = dict(AQE_ON, **{"spark.rapids.sql.autoBroadcastJoinThreshold":
                           64})
    s = _session()
    _on(s, _demotable_query, conf)
    assert not [d for d in s.last_aqe["decisions"]
                if d["rule"] == "broadcastDemotion"]


# ---------------------------------------------------------------------------
# skew-join splitting
# ---------------------------------------------------------------------------

def _skew_conf():
    return dict(AQE_ON, **{
        "spark.rapids.sql.autoBroadcastJoinThreshold": -1,
        "spark.rapids.sql.shuffle.partitions": 4,
        "spark.rapids.sql.adaptive.skewJoin.skewedPartitionThreshold": 2048,
        "spark.rapids.sql.adaptive.coalesce.minPartitionSize": 4096})


def _skew(fns, s):
    rng = np.random.default_rng(7)
    fact, dim = gen_skewed_join_frames(rng, n_fact=8000, n_dim=100,
                                       hot_prob=0.8)
    lt = s.create_dataframe(fact, 4)
    rt = s.create_dataframe(dim.rename(columns={"k": "k2"}), 2)
    return (lt.join(rt, left_on=["k"], right_on=["k2"])
            .group_by("k").agg(fns.sum(fns.col("v") + fns.col("w"))
                               .alias("sv"))
            .order_by("k"))


def _skew_query(s):
    return _skew(F, s)


def test_aqe_skew_split():
    out, s = _tpu_and_cpu(_skew_query, _skew_conf(), ignore_order=False)
    assert len(out) == 100
    splits = [d for d in s.last_aqe["decisions"]
              if d["rule"] == "skewSplit"]
    assert splits, s.last_aqe["decisions"]
    assert splits[0]["splits"] >= 2 and splits[0]["side"] == "left"


def test_aqe_skew_split_disabled_by_conf():
    conf = _skew_conf()
    conf["spark.rapids.sql.adaptive.skewJoin.enabled"] = False
    s = _session()
    _on(s, _skew_query, conf)
    assert not [d for d in s.last_aqe["decisions"]
                if d["rule"] == "skewSplit"]


# ---------------------------------------------------------------------------
# oracle equivalence of AQE on vs off on workload queries
# ---------------------------------------------------------------------------

def _tpch_q3(fns_tpch, s, sf=0.02):
    from spark_rapids_tpu_torch.models import tpch_data as G
    frames = _Q3_FRAMES.setdefault(sf, {
        "lineitem": G.gen_lineitem(sf), "orders": G.gen_orders(sf),
        "customer": G.gen_customer(sf)})
    return fns_tpch.q3(s, {n: s.create_dataframe(d, 3)
                           for n, d in frames.items()})


_Q3_FRAMES: dict = {}


def test_aqe_tpch_oracle_equivalence():
    """A multi-join TPC-H query: AQE on against AQE off, on the device,
    the CPU operators and the JAX session under AQE."""
    from spark_rapids_tpu.models import tpch as ref_tpch
    from spark_rapids_tpu_torch.models import tpch
    conf = dict(AQE_ON, **{"spark.rapids.sql.autoBroadcastJoinThreshold":
                           -1})
    s = _session()
    off = _cpu(s, lambda _s: _tpch_q3(tpch, s))
    on = _on(s, lambda _s: _tpch_q3(tpch, s), conf)
    assert_frames_equal(on, off, ignore_order=True, approx=True)
    assert s.last_aqe["stages"] >= 3
    ref = with_tpu_session(lambda r: _tpch_q3(ref_tpch, r), conf=conf)
    assert_frames_equal(on, ref, ignore_order=True, approx=True)


@pytest.mark.parametrize("qname", ["q6", "q17"])
def test_aqe_tpcxbb_oracle_equivalence(qname):
    from spark_rapids_tpu_torch.models import tpcxbb_data
    from spark_rapids_tpu_torch.models.tpcxbb import QUERIES
    from spark_rapids_tpu_torch.testing import tpcxbbcases
    bb = {name: fn(0.05, None)
          for name, fn in tpcxbb_data.ALL_TABLES.items()}
    fr = tpcxbbcases.query_frames(qname, bb)
    s = _session()

    def run(_s):
        tables = {name: s.create_dataframe(df, 3 if len(df) > 100 else 1)
                  for name, df in fr.items()}
        return QUERIES[qname](s, tables)
    off = _cpu(s, run)
    on = _on(s, run, AQE_ON)
    assert_frames_equal(on, off, ignore_order=True, approx=True)


# ---------------------------------------------------------------------------
# shuffle-skew observability (AQE-independent)
# ---------------------------------------------------------------------------

def test_shuffle_skew_gauges_without_aqe():
    from spark_rapids_tpu_torch.obs.metrics import REGISTRY
    from spark_rapids_tpu_torch.obs.shuffleobs import skew_summary
    assert skew_summary([]) is None
    s1 = skew_summary([10, 10, 100])
    assert s1["maxMedianRatio"] == 10.0 and s1["totalBytes"] == 120
    before = REGISTRY.value("shuffle.skew.shuffles")
    s = _session()
    _cpu(s, _skew_query, {
        "spark.rapids.sql.adaptive.enabled": False,
        "spark.rapids.sql.autoBroadcastJoinThreshold": -1,
        "spark.rapids.sql.shuffle.partitions": 4})
    assert REGISTRY.value("shuffle.skew.shuffles") > before
    assert float(REGISTRY.value("shuffle.skew.maxMedianRatio")) > 1.0


def test_shuffle_skew_in_profile_report():
    s = _session()
    _cpu(s, _join_agg_query, {
        "spark.rapids.sql.adaptive.enabled": False,
        "spark.rapids.sql.autoBroadcastJoinThreshold": -1})
    doc = s.profile_json()
    assert doc is not None
    sk = doc["summary"].get("shuffleSkew") or {}
    assert any(k.startswith("shuffle.skew.shuffles") for k in sk), sk
    assert "shuffle.skew.maxMedianRatio" in sk


# ---------------------------------------------------------------------------
# manager-path statistics and coalesced/ranged reads
# ---------------------------------------------------------------------------

def test_map_statistics_aggregation():
    from spark_rapids_tpu_torch.shuffle.manager import (
        MapStatus, aggregate_map_statistics,
    )
    stats = aggregate_map_statistics([
        MapStatus("e0", 1, 0, [10, 0, 30]),
        MapStatus("e0", 1, 1, [5, 20, 30]),
    ])
    assert stats.bytes_by_partition == [15, 20, 60]
    assert stats.total_bytes == 95
    assert stats.partition_map_sizes(2) == [30, 30]
    assert stats.num_maps == 2 and stats.num_partitions == 3


def test_manager_coalesced_and_ranged_reads():
    from spark_rapids_tpu_torch.columnar import dtypes
    from spark_rapids_tpu_torch.columnar.batch import DeviceBatch, Schema
    from spark_rapids_tpu_torch.shuffle.manager import (
        CachingShuffleReader, CachingShuffleWriter, ShuffleEnv,
    )
    from spark_rapids_tpu_torch.shuffle.transport import InProcessTransport
    env = ShuffleEnv("exec-0", InProcessTransport("exec-0"))
    try:
        schema = Schema(["a"], [dtypes.INT64])

        def batch(vals):
            return DeviceBatch.from_pandas(
                pd.DataFrame({"a": np.asarray(vals, np.int64)}), {},
                device="cpu", schema=schema)
        statuses = []
        for mid in range(2):
            w = CachingShuffleWriter(env, 1, mid)
            statuses.append(w.write([[batch([mid * 10 + 0])],
                                     [batch([mid * 10 + 1])],
                                     [batch([mid * 10 + 2])]]))
        reader = CachingShuffleReader(env)
        got = list(reader.read_coalesced(1, [0, 1], statuses))
        vals = sorted(int(b.to_pandas()["a"][0]) for b in got)
        assert vals == [0, 1, 10, 11]
        got = list(reader.read_partial(1, 2, statuses, 1, 2))
        assert [int(b.to_pandas()["a"][0]) for b in got] == [12]
    finally:
        env.close()


# ---------------------------------------------------------------------------
# static broadcast planning hardening
# ---------------------------------------------------------------------------

def _plan_of(s, df):
    from spark_rapids_tpu_torch.sql.planner import Planner
    return Planner(s.conf).plan(df._plan)


def test_planner_none_estimate_falls_back_to_shuffle():
    from spark_rapids_tpu_torch.exec import cpu
    s = _session()
    a = s.create_dataframe(pd.DataFrame({"k": [1, 2], "w": [1.0, 2.0]}), 1)
    b = s.create_dataframe(pd.DataFrame({"k": [3], "w": [3.0]}), 1)
    left = s.create_dataframe(
        pd.DataFrame({"k2": [1, 2, 3], "v": [1.0, 2.0, 3.0]}), 1)
    j = left.join(a.union(b), left_on=["k2"], right_on=["k"])
    assert j._plan.children[1].estimated_size_bytes() is None
    joins = [n for n in _plan_of(s, j).walk()
             if isinstance(n, cpu.CpuJoinExec)]
    assert joins and type(joins[0]) is cpu.CpuJoinExec


def test_planner_threshold_minus_one_disables_broadcast():
    from spark_rapids_tpu_torch.exec import cpu
    s = _session()
    tiny = s.create_dataframe(pd.DataFrame({"k": [1], "w": [1.0]}), 1)
    left = s.create_dataframe(
        pd.DataFrame({"k2": [1, 1, 2], "v": [1.0, 2.0, 3.0]}), 1)
    j = left.join(tiny, left_on=["k2"], right_on=["k"])
    s.set_conf("spark.rapids.sql.autoBroadcastJoinThreshold", -1)
    joins = [n for n in _plan_of(s, j).walk()
             if isinstance(n, cpu.CpuJoinExec)]
    assert joins and type(joins[0]) is cpu.CpuJoinExec
    s.reset_conf()
    assert any(isinstance(n, cpu.CpuBroadcastHashJoinExec)
               for n in _plan_of(s, j).walk())


def test_planner_raising_estimate_reads_as_unknown():
    from spark_rapids_tpu_torch.sql.planner import _estimated_size

    class Boom:
        def estimated_size_bytes(self):
            raise OSError("stat failed")

    class Weird:
        def estimated_size_bytes(self):
            return "lots"
    assert _estimated_size(Boom()) is None
    assert _estimated_size(Weird()) is None


# ---------------------------------------------------------------------------
# partial-NULL aggregates across the exchange
# ---------------------------------------------------------------------------

def test_partial_null_sum_merges_across_exchange():
    """A keyless final aggregate over a grouped intermediate with an EMPTY
    partition: its partial sum is NULL, and the exchange must not turn it
    into a NaN value that poisons the merge."""
    per = pd.DataFrame({"c": ["Y"], "total": [7292.0]})

    def run(s):
        d = s.create_dataframe(per, 1)
        g = d.group_by("c").agg(F.sum("total").alias("total"))
        return g.agg(F.sum("total").alias("t"))
    out, _s = _tpu_and_cpu(run, {"spark.rapids.sql.shuffle.partitions": 2})
    assert float(out["t"][0]) == 7292.0
    assert not out["t"].isna().any()


def test_nan_value_survives_masked_concat():
    from spark_rapids_tpu_torch.columnar import dtypes
    from spark_rapids_tpu_torch.columnar.batch import Schema
    from spark_rapids_tpu_torch.exec.cpu import concat_host_frames
    from spark_rapids_tpu_torch.sql.exprs.hostutil import host_unary_values
    schema = Schema(["x"], [dtypes.FLOAT64])
    plain = pd.DataFrame({"x": np.array([np.nan, 1.0])})
    masked = pd.DataFrame({"x": pd.array([2.0, None], dtype="Float64")})
    out = concat_host_frames([plain, masked], schema)
    vals, validity, _ = host_unary_values(out["x"])
    np.testing.assert_array_equal(validity, [True, True, True, False])
    assert np.isnan(vals[0]) and vals[1] == 1.0 and vals[2] == 2.0


def test_tpcxbb_q17_null_semantics():
    """TPCxBB Q17's one surviving channel row through the join chain: the
    keyless promotional and total sums are real values."""
    from spark_rapids_tpu_torch.models import tpcxbb_data
    from spark_rapids_tpu_torch.models.tpcxbb import QUERIES
    bb = {name: fn(0.05, None)
          for name, fn in tpcxbb_data.ALL_TABLES.items()}

    def run(s):
        tables = {name: s.create_dataframe(df, 3 if len(df) > 100 else 1)
                  for name, df in bb.items()}
        return QUERIES["q17"](s, tables)
    out, _s = _tpu_and_cpu(run, {"spark.rapids.sql.shuffle.partitions": 2})
    assert not out["promotional"].isna().any()
    assert not out["total"].isna().any()


def test_port_session_answers_equal_reference_under_aqe_and_fusion():
    """The port's answers equal the JAX session's with
    ``adaptive.enabled`` and ``fusion.stageEnabled`` both on."""
    conf = dict(AQE_ON, **{
        "spark.rapids.sql.fusion.stageEnabled": True,
        "spark.rapids.sql.autoBroadcastJoinThreshold": -1,
        "spark.rapids.sql.shuffle.partitions": 3})
    s = _session()
    got = _on(s, lambda _s: _join_agg(F, s), conf)
    assert s.last_aqe["stages"] == 3
    want = with_tpu_session(lambda r: _join_agg(RF, r), conf=conf)
    assert_frames_equal(got, want, approx=True)


def test_aqe_left_demotion_streams_the_partitioned_right_side():
    """AQE demotes the smaller measured side, here the LEFT side of an
    inner join, whose right side is a materialized stage read in four
    partitions (coalescing off): the broadcast join streams its right
    side against the left build (the JAX package's operator asserts a
    one-partition right side there) and answers as the CPU operators."""
    rng = np.random.default_rng(17)
    dim = pd.DataFrame({"k": np.arange(50, dtype=np.int64),
                        "w": rng.uniform(0, 1, 50)})
    fact = pd.DataFrame({"k2": rng.integers(0, 60, 4000).astype(np.int64),
                         "v": rng.uniform(0, 1, 4000)})
    conf = dict(AQE_ON, **{
        "spark.rapids.sql.shuffle.partitions": 4,
        "spark.rapids.sql.adaptive.coalesce.enabled": False,
        "spark.rapids.sql.autoBroadcastJoinThreshold": 2000})

    def q(s):
        return (s.create_dataframe(dim, 2)
                .join(s.create_dataframe(fact, 4), left_on=["k"],
                      right_on=["k2"])
                .group_by("k").agg(F.sum(F.col("v") * F.col("w"))
                                   .alias("s"), F.count("*").alias("n")))
    out, s = _tpu_and_cpu(q, conf)
    demotions = [d for d in s.last_aqe["decisions"]
                 if d["rule"] == "broadcastDemotion"]
    assert demotions and demotions[0]["side"] == "left", \
        s.last_aqe["decisions"]
    assert len(out) == 50

"""Filter and selection fusion (``exec/fusion.py``) and whole-stage fusion
(``exec/stagecompiler``) of the port's session, on the CPU, against the
JAX package.

The JAX package's ``tests/test_fusion.py`` (its seven top-level cases and
``TestWholeStageFusion`` but its compile-ledger case, which has no
counterpart: the port compiles nothing per stage; the plan-cache case
becomes a conf flip between runs, the port having no plan cache) and
``tests/test_agg_adaptive.py::test_skip_with_fused_filter_matches`` run
here against the port's session (``device="cpu"``): each query through
the port's device operators, its CPU operators and, for the fusion cases,
the JAX package's session on the same seeded frames. A fused filter
rejects rows on every branch of the aggregation (single group, dictionary,
sorted payload, sorted space, hash, row space, dense) and in the runtime
skip's pass-through; nondeterministic filters never fuse.
"""

import numpy as np
import pandas as pd
import pytest

from spark_rapids_tpu.sql import functions as RF
from spark_rapids_tpu_torch.session import TpuSparkSession
from spark_rapids_tpu_torch.sql import functions as F
from tests.querytest import assert_frames_equal, with_tpu_session


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


def _cpu(s, q):
    return _on(s, q, {"spark.rapids.sql.enabled": False,
                      "spark.rapids.sql.test.enabled": False})


def _both(q, sort_cols, frame, parts=1, **conf):
    """(device, CPU, JAX session) results of ``q(fns, df)``, sorted."""
    s = _session(**conf)
    df = s.create_dataframe(frame, parts)
    cpu = _cpu(s, lambda _s: q(F, df))
    tpu = _on(s, lambda _s: q(F, df))  # last: s.last_plan is its plan
    ref = with_tpu_session(lambda rs: q(RF, rs.create_dataframe(frame,
                                                               parts)))
    return tuple(x.sort_values(sort_cols).reset_index(drop=True)
                 for x in (tpu, cpu, ref)) + (s,)


def _fused_count(plan):
    return sum(1 for node in plan.walk()
               if getattr(node, "pre_mask", None) is not None)


def test_fused_keyless_string_minmax_first_last():
    # mask-dead rows must not compete in the keyless string select (they
    # carry validity=True, unlike padding)
    df = pd.DataFrame({"s": ["aaa", "bbb", "ccc", "ddd"],
                       "x": [1.0, 2.0, 3.0, 4.0]})
    tpu, cpu, ref, s = _both(
        lambda fns, d: d.filter(fns.col("x") > 1.5).agg(
            fns.min("s").alias("mn"), fns.max("s").alias("mx")), ["mn"], df)
    assert tpu.mn[0] == cpu.mn[0] == ref.mn[0] == "bbb"
    assert tpu.mx[0] == cpu.mx[0] == ref.mx[0] == "ddd"
    assert _fused_count(s.last_plan) == 1
    tpu2, cpu2, ref2, _s = _both(
        lambda fns, d: d.filter(fns.col("x") < 3.5).agg(
            fns.first("s").alias("f"), fns.last("s").alias("l")), ["f"], df)
    assert tpu2.f[0] == cpu2.f[0] == ref2.f[0] == "aaa"
    assert tpu2.l[0] == cpu2.l[0] == ref2.l[0] == "ccc"


def test_fused_keyed_string_reduction():
    rng = np.random.default_rng(9)
    n = 2000
    df = pd.DataFrame({
        "k": rng.choice(["a", "b"], n),
        "s": [f"s{i:05d}" for i in rng.integers(0, 10000, n)],
        "x": rng.uniform(0, 1, n),
    })
    tpu, cpu, ref, s = _both(
        lambda fns, d: d.filter(fns.col("x") > 0.5).group_by("k").agg(
            fns.min("s").alias("mn"), fns.max("s").alias("mx"),
            fns.count("s").alias("c")), ["k"], df, parts=2)
    assert _fused_count(s.last_plan) == 1
    for col in ("mn", "mx", "c"):
        assert tpu[col].tolist() == cpu[col].tolist() == ref[col].tolist()


@pytest.mark.parametrize("conf", [
    {},
    {"spark.rapids.sql.agg.hashAggEnabled": True},
], ids=["default", "hash"])
def test_fused_all_kinds_keyed_numeric(conf):
    rng = np.random.default_rng(10)
    n = 5000
    df = pd.DataFrame({
        "k": rng.choice(["p", "q", "r"], n),
        "v": rng.uniform(-10, 10, n),
        "w": rng.integers(-100, 100, n).astype(np.int64),
    })
    tpu, cpu, ref, s = _both(
        lambda fns, d: d.filter(fns.col("v") > 0).group_by("k").agg(
            fns.sum("v").alias("sv"), fns.count("*").alias("c"),
            fns.min("w").alias("mnw"), fns.max("v").alias("mxv"),
            fns.avg("w").alias("aw")), ["k"], df, parts=3, **conf)
    assert _fused_count(s.last_plan) == 1
    for other in (cpu, ref):
        assert tpu.c.tolist() == other.c.tolist()
        assert tpu.mnw.tolist() == other.mnw.tolist()
        np.testing.assert_allclose(tpu.sv.values.astype(float),
                                   other.sv.values.astype(float), rtol=1e-9)
        np.testing.assert_allclose(tpu.aw.values.astype(float),
                                   other.aw.values.astype(float), rtol=1e-9)
        np.testing.assert_allclose(tpu.mxv.values.astype(float),
                                   other.mxv.values.astype(float), rtol=0)


def test_fused_filter_on_unbounded_and_hash_keys():
    """A fused filter over integer keys past the dictionary branch: the
    sorted-payload branch, the hash branch (kernel B2's plain version,
    split by ``_bucketed_update`` at a small slot budget) and the dense
    branch of a second run each reject the masked rows."""
    from spark_rapids_tpu_torch.ops import aggregate
    rng = np.random.default_rng(13)
    n = 6000
    df = pd.DataFrame({"k": rng.integers(0, 2500, n).astype(np.int64),
                       "v": rng.uniform(0, 1, n)})

    def q(fns, d):
        return d.filter(fns.col("v") > 0.3).group_by("k").agg(
            fns.sum("v").alias("sv"), fns.count("*").alias("c"))
    want = with_tpu_session(lambda rs: q(RF, rs.create_dataframe(df, 2)))
    want = want.sort_values("k").reset_index(drop=True)
    for conf, branch in (({}, "sorted_payload"),
                         ({"spark.rapids.sql.agg.hashAggEnabled": True,
                           "spark.rapids.sql.agg.hash.maxTableSlots": 4096},
                          "hash")):
        s = _session(**conf)
        d = s.create_dataframe(df, 2)
        aggregate.reset_branches()
        for _ in range(2):
            got = _on(s, lambda _s: q(F, d))
            assert_frames_equal(got.sort_values("k").reset_index(drop=True),
                                want, approx=True)
        assert aggregate.BRANCHES[branch] > 0
        assert aggregate.BRANCHES["dense"] > 0 or branch == "hash"
        assert _fused_count(s.last_plan) == 1


def test_fusion_engages_and_conf_gate():
    df = pd.DataFrame({"k": ["a", "b"] * 20, "v": np.arange(40.0)})
    s = _session()
    d = s.create_dataframe(df, 1)

    def q(_s):
        return d.filter(F.col("v") > 5).group_by("k").agg(
            F.sum("v").alias("s"))
    out_on = _on(s, q)
    assert _fused_count(s.last_plan) >= 1, "fusion should engage"
    assert not any(type(n).__name__ == "TpuFilterExec"
                   for n in s.last_plan.walk())
    out_off = _on(s, q, {"spark.rapids.sql.agg.fuseFilter": False})
    assert _fused_count(s.last_plan) == 0, "conf gate should disable"
    pd.testing.assert_frame_equal(
        out_on.sort_values("k").reset_index(drop=True),
        out_off.sort_values("k").reset_index(drop=True))


def test_fusion_skips_nondeterministic_filter():
    df = pd.DataFrame({"k": ["a", "b"] * 20, "v": np.arange(40.0)})
    s = _session()
    d = s.create_dataframe(df, 1)
    out = _on(s, lambda _s: d.filter(F.rand(seed=1) >= 0.0)
              .group_by("k").agg(F.count("*").alias("c")))
    assert _fused_count(s.last_plan) == 0
    assert sorted(out.c.tolist()) == [20, 20]


def test_fused_project_chain():
    rng = np.random.default_rng(12)
    n = 3000
    df = pd.DataFrame({"k": rng.choice(["u", "v"], n),
                       "a": rng.uniform(1, 2, n)})
    tpu, cpu, ref, s = _both(
        lambda fns, d: d.filter(fns.col("a") < 1.7)
        .with_column("b", fns.col("a") * 3.0)
        .with_column("c", fns.col("b") + 1.0)
        .group_by("k").agg(fns.sum("c").alias("sc"),
                           fns.count("*").alias("n")), ["k"], df, parts=2)
    assert _fused_count(s.last_plan) == 1
    for other in (cpu, ref):
        assert tpu.n.tolist() == other.n.tolist()
        np.testing.assert_allclose(tpu.sc.values.astype(float),
                                   other.sc.values.astype(float), rtol=1e-9)


def test_selection_fuses_into_filter_and_exchange():
    """A pure-column project above a filter becomes the filter's output
    selection, and a collapsed exchange (here a broadcast) folds that
    filter into its one masked concat: no TpuFilterExec compacts, and the
    answer equals the unfused run's and the JAX session's."""
    rng = np.random.default_rng(14)
    n = 4000
    fact = pd.DataFrame({"k": rng.integers(0, 50, n).astype(np.int64),
                         "v": rng.uniform(0, 1, n)})
    dim = pd.DataFrame({"k": np.arange(50, dtype=np.int64),
                        "t": rng.integers(0, 4, 50).astype(np.int64),
                        "pad": ["x" * 20] * 50})

    def q(fns, f, dm):
        return (f.join(dm.filter(fns.col("t") == 1).select("k"), on="k")
                .group_by("k").agg(fns.sum("v").alias("sv")))
    s = _session()
    f, dm = s.create_dataframe(fact, 2), s.create_dataframe(dim, 1)
    got = _on(s, lambda _s: q(F, f, dm)).sort_values("k")
    filters = [n for n in s.last_plan.walk()
               if type(n).__name__ == "TpuFilterExec"]
    assert filters and all(x.out_sel is not None for x in filters)
    off = _on(s, lambda _s: q(F, f, dm), {
        "spark.rapids.sql.exchange.fuseFilter": False}).sort_values("k")
    ref = with_tpu_session(lambda rs: q(
        RF, rs.create_dataframe(fact, 2), rs.create_dataframe(dim, 1)))
    for other in (off, ref.sort_values("k")):
        assert_frames_equal(got.reset_index(drop=True),
                            other.reset_index(drop=True), approx=True)


def test_skip_with_fused_filter_matches(rng):
    """The JAX package's test_agg_adaptive case: the runtime partial skip
    over a fused filter (the pass-through compacts the masked rows),
    across the measuring and the cached-decision runs."""
    n = 40000
    pdf = pd.DataFrame({
        "k": rng.integers(0, n, n).astype(np.int64),  # ~unique keys
        "v": rng.random(n),
        "w": rng.integers(-100, 100, n),
    })
    s = _session(**{"spark.rapids.sql.batchSizeRows": 8192})
    d = s.create_dataframe(pdf, 4)

    def q(_s):
        return d.filter(F.col("w") > 0).group_by("k").agg(
            F.sum("v").alias("sv"))
    cpu = _cpu(s, q)
    s.agg_ratio_cache.clear()
    tpu1 = _on(s, q)
    assert s.agg_ratio_cache, "the skip never measured a ratio"
    assert _fused_count(s.last_plan) == 1
    tpu2 = _on(s, q)
    assert_frames_equal(tpu1, cpu, ignore_order=True, approx=True)
    assert_frames_equal(tpu2, cpu, ignore_order=True, approx=True)


# ---------------------------------------------------------------------------
# whole-stage fusion (exec/stagecompiler)
# ---------------------------------------------------------------------------

FUSION_ON = {"spark.rapids.sql.fusion.stageEnabled": True}


def _fused_nodes(plan):
    return [n for n in plan.walk()
            if type(n).__name__ == "TpuFusedStageExec"]


def _chain_frame():
    rng = np.random.default_rng(5)
    n = 4000
    return pd.DataFrame({"k": rng.choice(["a", "b", "c"], n),
                         "v": rng.uniform(0, 100, n),
                         "w": rng.integers(-50, 50, n).astype(np.int64)})


def _chain(fns, d):
    return (d.filter(fns.col("v") > 10)
            .with_column("x", fns.col("v") * 2.0)
            .with_column("y", fns.col("x") + fns.col("w"))
            .filter(fns.col("y") > 30)
            .with_column("z", fns.col("y") - 1.5))


class TestWholeStageFusion:
    def test_off_is_identity_and_on_fuses(self):
        from spark_rapids_tpu_torch.exec.stagecompiler import compile_stages
        frame = _chain_frame()
        s = _session()
        d = s.create_dataframe(frame, 2)
        off = _on(s, lambda _s: _chain(F, d))
        plan_off = s.last_plan
        assert not _fused_nodes(plan_off)
        # off, compile_stages returns the SAME plan object
        assert compile_stages(plan_off, s.conf) is plan_off
        on = _on(s, lambda _s: _chain(F, d), FUSION_ON)
        fused = _fused_nodes(s.last_plan)
        assert len(fused) == 1, s.last_plan.tree_string()
        assert len(fused[0].members) >= 4
        assert any("TpuFilterExec" in m for m in fused[0].member_ops)
        ref = with_tpu_session(lambda rs: _chain(
            RF, rs.create_dataframe(frame, 2)), conf=FUSION_ON)
        for other in (off, ref):
            pd.testing.assert_frame_equal(
                on.sort_values("v").reset_index(drop=True),
                other.sort_values("v").reset_index(drop=True))

    def test_min_operators_gate(self):
        s = _session()
        d = s.create_dataframe(_chain_frame(), 2)
        _on(s, lambda _s: _chain(F, d), dict(
            FUSION_ON, **{"spark.rapids.sql.fusion.minOperators": 99}))
        assert not _fused_nodes(s.last_plan)

    def test_nondeterministic_breaks_the_chain(self):
        s = _session()
        d = s.create_dataframe(_chain_frame(), 2)
        _on(s, lambda _s: _chain(F, d).with_column("r", F.rand(seed=7))
            .with_column("r2", F.col("r") + 1.0), FUSION_ON)
        for fused in _fused_nodes(s.last_plan):
            assert not any("rand" in m.lower() for m in fused.member_ops)

    def test_conf_flip_between_runs(self):
        """The JAX package's plan-cache case: a plan fused under the conf
        must not fuse once it flips off (the port plans every run)."""
        s = _session()
        d = s.create_dataframe(_chain_frame(), 2)
        on1 = _on(s, lambda _s: _chain(F, d), FUSION_ON)
        assert _fused_nodes(s.last_plan)
        on2 = _on(s, lambda _s: _chain(F, d), FUSION_ON)
        assert _fused_nodes(s.last_plan)
        off = _on(s, lambda _s: _chain(F, d))
        assert not _fused_nodes(s.last_plan)
        pd.testing.assert_frame_equal(on1, on2)
        pd.testing.assert_frame_equal(on1, off)

    def test_failure_names_member_pipeline(self, monkeypatch):
        from spark_rapids_tpu_torch.exec.stagecompiler.fusedexec import (
            TpuFusedStageExec,
        )
        from spark_rapids_tpu_torch.obs.events import EVENTS

        def boom(self, _batch):
            raise ValueError("injected kernel failure")
        monkeypatch.setattr(TpuFusedStageExec, "_kernel", boom)
        s = _session()
        d = s.create_dataframe(_chain_frame(), 2)
        with pytest.raises(RuntimeError) as exc:
            _on(s, lambda _s: _chain(F, d), FUSION_ON)
        msg = str(exc.value)
        assert "fused stage [" in msg and "TpuFilterExec" in msg
        assert "injected kernel failure" in msg
        dumped = [e for e in EVENTS.flight_events()
                  if e.get("kind") == "fusedStageFailure"]
        assert dumped, "fusedStageFailure must reach the recorder"
        assert any("TpuFilterExec" in m for m in dumped[-1]["members"])
        assert "injected kernel failure" in dumped[-1]["error"]


def test_tpch_q6_fusion_on():
    """TPC-H Q6 with whole-stage fusion on: equal to the CPU operators
    and the JAX session."""
    from spark_rapids_tpu.models import tpch as ref_tpch
    from spark_rapids_tpu_torch.models import tpch
    from spark_rapids_tpu_torch.models import tpch_data as G
    li = G.gen_lineitem(0.002)
    conf = dict(FUSION_ON, **{"spark.rapids.sql.shuffle.partitions": 2})
    s = _session(**conf)
    t = {"lineitem": s.create_dataframe(li, 3)}
    got = _on(s, lambda _s: tpch.q6(s, t))
    assert_frames_equal(got, _cpu(s, lambda _s: tpch.q6(s, t)), approx=True)
    ref = with_tpu_session(lambda rs: ref_tpch.q6(
        rs, {"lineitem": rs.create_dataframe(li, 3)}), conf=conf)
    assert_frames_equal(got, ref, approx=True)


def test_fusion_under_aqe_small():
    """Fusion cutting inside AQE's per-stage conversion, on a small join
    and aggregate."""
    rng = np.random.default_rng(8)
    n = 1500
    fact = pd.DataFrame({"k": rng.integers(0, 30, n).astype(np.int64),
                         "v": rng.uniform(0, 10, n)})
    dim = pd.DataFrame({"k": np.arange(40, dtype=np.int64),
                        "w": rng.integers(0, 5, 40).astype(np.int64)})
    conf = dict(FUSION_ON, **{
        "spark.rapids.sql.adaptive.enabled": True,
        "spark.rapids.sql.autoBroadcastJoinThreshold": -1,
        "spark.rapids.sql.shuffle.partitions": 2})

    def q(fns, f, d):
        f = (f.filter(fns.col("v") > 1)
             .with_column("x", fns.col("v") * 2.0)
             .with_column("y", fns.col("x") + 1.0))
        return (f.join(d, on="k", how="inner").group_by("w")
                .agg(fns.sum("y").alias("sy"), fns.count("*").alias("c")))
    s = _session(**conf)
    f, d = s.create_dataframe(fact, 2), s.create_dataframe(dim, 2)
    got = _on(s, lambda _s: q(F, f, d))
    assert s.last_aqe is not None and s.last_aqe["stages"] >= 1
    assert_frames_equal(got, _cpu(s, lambda _s: q(F, f, d)),
                        ignore_order=True, approx=True)

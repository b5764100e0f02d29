"""The port's serving layer (``spark_rapids_tpu_torch/serving/``) against
the JAX package's, on the CPU.

  * TPC-H Q1, Q3 and Q6 served by a two-worker ``QueryScheduler`` over
    the port's session (``device="cpu"``, test mode) at SF 0.005 equal
    the JAX session's answers (floats at rtol 1e-6);
  * one script of sleep jobs with tenant weights, on one worker behind a
    blocker, starts in the same order in both schedulers;
  * the plan and result caches hit and miss on the same sequence in both
    packages (a repeat, a conf change and back, a literal change, a
    Parquet table rewritten with a new mtime, a nondeterministic plan);
    an equal-length rewrite that restores the mtime misses in the port
    (its ``file_stamp`` holds the inode), held to the port alone;
  * cancel (queued and running), deadline (running and burned in the
    queue) and shed give the JAX package's statuses and events;
  * the AQE exchange reuse adopts a stage, keeps the cache's stage alive
    past the first query's release, and misses on new data, as the JAX
    package's;
  * concurrent runs of one cached plan run clones and agree; the
    semaphore takes the serving context's tenant; a cancelled query's
    transient buffers are released.
"""

import os
import threading
import time

import numpy as np
import pandas as pd
import pytest

from spark_rapids_tpu.models import tpch as ref_tpch
from spark_rapids_tpu_torch.models import tpch
from spark_rapids_tpu_torch.models import tpch_data as G
from spark_rapids_tpu_torch.serving.cancellation import (
    CancelScope, QueryCancelled, QueryTimeout, serving_context,
)
from spark_rapids_tpu_torch.session import TpuSparkSession
from tests.querytest import assert_frames_equal, with_tpu_session
from spark_rapids_tpu_torch.testing.signals import release_sigusr1  # noqa: F401

SF = 0.005


def port_session(**conf):
    b = TpuSparkSession.builder().device("cpu").config(
        "spark.rapids.sql.test.enabled", True)
    for k, v in conf.items():
        b.config(k, v)
    return b.get_or_create()


def _counters(registry, prefixes=("plancache.", "resultcache.",
                                  "exchangereuse.")) -> dict:
    out: dict = {}
    for m in registry.metrics():
        if m.name.startswith(prefixes):
            out[m.name] = out.get(m.name, 0) + m.value
    return out


def _delta(before: dict, after: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v - before.get(k, 0)}


# ---------------------------------------------------------------------------
# Served answers
# ---------------------------------------------------------------------------

def test_served_tpch_answers_equal_the_jax_session():
    fr = {"lineitem": G.gen_lineitem(SF), "orders": G.gen_orders(SF),
          "customer": G.gen_customer(SF)}
    queries = ("q1", "q3", "q6")
    want = {}
    for q in queries:
        want[q] = with_tpu_session(
            lambda rs, q=q: ref_tpch.QUERIES[q](
                rs, {n: rs.create_dataframe(f) for n, f in fr.items()}))
    from spark_rapids_tpu_torch.obs.metrics import REGISTRY
    s = port_session()
    t = {n: s.create_dataframe(f) for n, f in fr.items()}
    sched = s.serving_scheduler(workers=2)
    try:
        jobs = [(q, sched.submit(lambda ss, q=q: tpch.QUERIES[q](ss, t),
                                 tenant=f"t{i % 3}", description=q))
                for i, q in enumerate(queries * 2)]
        for q, job in jobs:
            assert job.wait(120) == "succeeded", job.error
            assert job.query_id is not None
            assert_frames_equal(job.get(), want[q], ignore_order=True,
                                approx=True)
        # the second round of each query ran a clone of the cached plan
        assert _counters(REGISTRY)["plancache.hits"] >= len(queries)
        snap = sched.snapshot()
        assert snap["workers"] == 2 and snap["shedTotal"] == 0
        assert {"t0", "t1", "t2"} <= set(snap["tenants"])
    finally:
        sched.close()
        s.stop()


# ---------------------------------------------------------------------------
# Weighted-fair start order
# ---------------------------------------------------------------------------

def _start_order(sess, tiny) -> list:
    """Start order of a script of sleep jobs: a blocker holds the one
    worker while 12 jobs of three tenants (weights 1, 1, 3) queue."""
    sess.set_conf("spark.rapids.tpu.serving.tenant.heavy.weight", 3.0)
    sess.set_conf("spark.rapids.tpu.serving.tenant.a.weight", 1.0)
    order, lock = [], threading.Lock()

    def work(name, seconds=0.0):
        def fn(s):
            with lock:
                order.append(name)
            time.sleep(seconds)
            return s.create_dataframe(tiny)
        return fn
    sched = sess.serving_scheduler(workers=1)
    try:
        blocker = sched.submit(work("blocker", 0.4), tenant="a")
        deadline = time.monotonic() + 10
        while blocker.status == "queued" and time.monotonic() < deadline:
            time.sleep(0.005)
        jobs = []
        for i in range(4):
            for tenant in ("a", "b", "heavy"):
                jobs.append(sched.submit(work(f"{tenant}{i}"),
                                         tenant=tenant))
        for j in [blocker] + jobs:
            assert j.wait(60) == "succeeded", j.error
    finally:
        sched.close()
    return order


def test_weighted_start_order_equals_the_jax_scheduler(session):
    tiny = pd.DataFrame({"a": [1, 2, 3]})
    try:
        want = _start_order(session, tiny)
    finally:
        session.reset_conf()
    s = port_session()
    try:
        got = _start_order(s, tiny)
    finally:
        s.stop()
    assert got == want
    # the weight-3 tenant leads the queued script
    assert [o[0] for o in got[1:5]].count("h") >= 2


# ---------------------------------------------------------------------------
# Plan and result caches
# ---------------------------------------------------------------------------

def _cache_sequence(sess, registry, F, tmp_dir: str) -> list:
    """(plan hits, plan misses, result hits, result misses) of each step
    of one script, with the result cache on."""
    sess.clear_serving_caches()
    sess.set_conf("spark.rapids.tpu.serving.resultCache.enabled", True)
    rng = np.random.default_rng(5)
    df = pd.DataFrame({"k": rng.integers(0, 5, 64),
                       "v": np.arange(64, dtype=np.float64),
                       "region": np.where(np.arange(64) % 2 == 0, "east",
                                          "west")})
    base = sess.create_dataframe(df, 2)
    q = base.group_by("k").agg(F.sum("v").alias("s"))
    ea = base.filter(F.col("region").startswith("ea"))
    we = base.filter(F.col("region").startswith("we"))
    nondet = base.with_column("r", F.rand(3))
    path = os.path.join(tmp_dir, "t.parquet")
    pd.DataFrame({"a": [1, 2, 3], "b": [1.0, 2.0, 3.0]}).to_parquet(
        path, index=False)
    answers = []

    def step(fn):
        before = _counters(registry)
        out = fn()
        d = _delta(before, _counters(registry))
        answers.append(out)
        return tuple(d.get(k, 0) for k in (
            "plancache.hits", "plancache.misses", "resultcache.hits",
            "resultcache.misses"))

    # one DataFrame over the file: a scan's plan identity holds its
    # source's data id, so a new read is a new plan in both packages
    pqdf = sess.read.parquet(path).group_by("a").agg(F.sum("b").alias("s"))
    pq = pqdf.collect

    seq = [step(q.collect), step(q.collect)]
    sess.set_conf("spark.rapids.sql.batchSizeRows", 1 << 19)
    seq.append(step(q.collect))
    del sess.conf._settings["spark.rapids.sql.batchSizeRows"]
    seq.append(step(q.collect))
    seq += [step(ea.collect), step(we.collect), step(we.collect)]
    seq += [step(pq), step(pq)]
    pd.DataFrame({"a": [7, 8, 9], "b": [9.0, 9.0, 9.0]}).to_parquet(
        path, index=False)
    os.utime(path, (time.time() + 5, time.time() + 5))
    seq += [step(pq), step(pq)]
    seq += [step(nondet.collect), step(nondet.collect)]
    assert set(answers[5]["region"]) == {"west"}
    assert sorted(answers[9]["a"].tolist()) == [7, 8, 9]
    sess.set_conf("spark.rapids.tpu.serving.resultCache.enabled", False)
    sess.clear_serving_caches()
    return seq


def test_cache_hits_and_misses_follow_the_jax_package(session, tmp_path):
    from spark_rapids_tpu.obs.metrics import REGISTRY as REF_REGISTRY
    from spark_rapids_tpu.sql import functions as RF
    from spark_rapids_tpu_torch.obs.metrics import REGISTRY
    from spark_rapids_tpu_torch.sql import functions as F
    os.makedirs(tmp_path / "jax")
    os.makedirs(tmp_path / "port")
    try:
        want = _cache_sequence(session, REF_REGISTRY, RF,
                               str(tmp_path / "jax"))
    finally:
        session.reset_conf()
    s = port_session()
    try:
        got = _cache_sequence(s, REGISTRY, F, str(tmp_path / "port"))
    finally:
        s.stop()
    assert got == want
    # a repeat is a result hit, the conf change a miss of both and its
    # undoing a hit again, a rand() plan a plan hit but never a result hit
    assert got[1] == (0, 0, 1, 0) and got[2] == (0, 1, 0, 1)
    assert got[3] == (0, 0, 1, 0)
    assert got[-1] == (1, 0, 0, 1)


def test_equal_length_rewrite_with_the_mtime_restored_misses(tmp_path):
    """A table replaced by a file of the same length whose mtime is set
    back (an atomic rewrite within one clock tick): the port's source
    version holds the inode, so its caches miss and the query reads the
    new rows (the JAX package's mtime-only key hits: ROADMAP C)."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from spark_rapids_tpu_torch.obs.metrics import REGISTRY
    from spark_rapids_tpu_torch.sql import functions as F
    path = str(tmp_path / "t.parquet")

    def write(vals, dest):
        pq.write_table(pa.table({"a": pa.array(vals, pa.int64())}), dest,
                       use_dictionary=False, compression="NONE",
                       write_statistics=False)
    write([1, 2, 3], path)
    st = os.stat(path)
    s = port_session(**{"spark.rapids.tpu.serving.resultCache.enabled":
                        True})
    try:
        df = s.read.parquet(path).agg(F.sum("a").alias("s"))

        def run():
            return sorted(df.collect()["s"].tolist())
        assert run() == [6]
        before = _counters(REGISTRY)
        assert run() == [6]
        assert _delta(before, _counters(REGISTRY)) == {
            "resultcache.hits": 1}
        tmp = path + ".new"
        write([7, 8, 9], tmp)
        assert os.path.getsize(tmp) == st.st_size
        os.replace(tmp, path)
        os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns))
        assert os.stat(path).st_mtime_ns == st.st_mtime_ns
        before = _counters(REGISTRY)
        assert run() == [24]
        d = _delta(before, _counters(REGISTRY))
        assert d.get("resultcache.misses") == 1 and "resultcache.hits" \
            not in d
    finally:
        s.stop()


def test_plan_cache_hit_runs_a_clone_and_skips_tag_and_convert(
        monkeypatch):
    from spark_rapids_tpu_torch.obs.events import EVENTS
    s = port_session()
    try:
        fr = {"lineitem": G.gen_lineitem(SF), "orders": G.gen_orders(SF),
              "customer": G.gen_customer(SF)}
        t = {n: s.create_dataframe(f) for n, f in fr.items()}
        q = tpch.q3(s, t)
        s.capture_plans = True
        first = q.collect()
        calls = []
        orig = s._convert_cpu
        monkeypatch.setattr(s, "_convert_cpu",
                            lambda p: calls.append(1) or orig(p))
        second = q.collect()
        assert calls == []  # no tag and convert on a hit
        p1, p2 = s.captured_plans[-2:]
        assert p1 is not p2 and p1.tree_string() == p2.tree_string()
        assert any(e["kind"] == "planCacheHit"
                   for e in EVENTS.flight_events())
        assert_frames_equal(first, second)
        # two threads running clones of the one cached plan at once
        outs, errs = [], []

        def run():
            try:
                for _ in range(3):
                    outs.append(q.collect())
            except Exception as e:  # noqa: BLE001 — surfaced below
                errs.append(e)
        threads = [threading.Thread(target=run) for _ in range(2)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(120)
        assert not errs, errs
        assert len(outs) == 6
        for out in outs:
            assert_frames_equal(out, first)
        plans = s.captured_plans[-6:]
        assert len({id(p) for p in plans}) == 6
    finally:
        s.stop()


def test_plan_cache_off_never_counts():
    from spark_rapids_tpu_torch.obs.metrics import REGISTRY
    from spark_rapids_tpu_torch.sql import functions as F
    s = port_session(**{"spark.rapids.tpu.serving.planCache.enabled":
                        False})
    try:
        q = s.create_dataframe(pd.DataFrame({"k": [1, 1, 2],
                                             "v": [1.0, 2.0, 3.0]})) \
            .group_by("k").agg(F.sum("v").alias("s"))
        before = _counters(REGISTRY)
        q.collect()
        q.collect()
        assert _delta(before, _counters(REGISTRY)) == {}
        assert s._serving() is None
    finally:
        s.stop()


# ---------------------------------------------------------------------------
# Cancel, deadline, shed
# ---------------------------------------------------------------------------

def _slow_source(cls, df, parts, delay_s):
    """An in-memory source whose every partition sleeps before its rows:
    a query of many batch pulls (its projections keep the delay)."""
    class Slow(cls):
        def cpu_partitions(self, *a, **k):
            inner = super().cpu_partitions(*a, **k)

            def wrap(p):
                def run():
                    time.sleep(delay_s)
                    return p()
                return run
            return [wrap(p) for p in inner]

        def with_columns(self, columns):
            view = super().with_columns(columns)
            view.__class__ = Slow
            return view
    return Slow(df, parts)


def _slow_df(sess, df_cls, plan_mod, src_cls, delay_s, parts):
    frame = pd.DataFrame({"k": np.arange(240) % 5,
                          "v": np.arange(240, dtype=np.float64)})
    return df_cls(sess, plan_mod.LogicalScan(
        _slow_source(src_cls, frame, parts, delay_s)))


def _raised(job) -> str:
    try:
        job.get(1)
    except Exception as e:  # noqa: BLE001 — the class is the outcome
        return type(e).__name__
    return "nothing"


def _outcomes(sess, slow, quick, events) -> dict:
    """Statuses and event kinds of the five admission and cancel
    cases."""
    out = {}
    sched = sess.serving_scheduler(workers=1)
    try:
        # a running job cancelled mid-drain
        job = sched.submit(slow(0.15, 8), tenant="a")
        while job.status == "queued":
            time.sleep(0.01)
        time.sleep(0.1)
        assert sched.cancel(job.id)
        out["cancel_running"] = job.wait(30)
        ev = [e for e in events.flight_events()
              if e["kind"] == "queryCancelled"]
        out["cancel_event"] = bool(ev) and "events" in ev[-1]
        # a queued job cancelled
        blocker = sched.submit(slow(0.2, 2), tenant="a")
        victim = sched.submit(quick(), tenant="a")
        assert sched.cancel(victim.id, "changed my mind")
        out["cancel_queued"] = victim.wait(10)
        out["cancel_queued_raises"] = _raised(victim)
        out["blocker"] = blocker.wait(30)
        # a running job past its deadline
        job = sched.submit(slow(0.15, 8), tenant="a", deadline_s=0.3)
        out["deadline_running"] = job.wait(30)
        out["deadline_running_raises"] = _raised(job)
        ev = [e for e in events.flight_events()
              if e["kind"] == "queryTimeout"]
        out["deadline_seconds"] = ev[-1].get("deadlineSeconds")
        # a deadline burned in the queue
        blocker = sched.submit(slow(0.2, 2), tenant="a")
        late = sched.submit(quick(), tenant="a", deadline_s=0.01)
        out["deadline_queued"] = late.wait(30)
        out["deadline_queued_error"] = "queued" in (late.error or "")
        blocker.wait(30)
    finally:
        sched.close()
    sched = sess.serving_scheduler(workers=1, max_queue=1)
    try:
        blocker = sched.submit(slow(0.2, 2), tenant="a")
        while blocker.status == "queued":
            time.sleep(0.01)
        queued = sched.submit(quick(), tenant="a")
        shed = sched.submit(quick(), tenant="b")
        out["shed"] = shed.status
        out["shed_event"] = any(e["kind"] == "queryShed"
                                for e in events.flight_events())
        out["after_shed"] = (blocker.wait(30), queued.wait(30))
        out["shed_total"] = sched.snapshot()["shedTotal"]
    finally:
        sched.close()
    return out


def test_cancel_deadline_and_shed_follow_the_jax_scheduler(session):
    from spark_rapids_tpu import session as ref_session
    from spark_rapids_tpu.obs.events import EVENTS as REF_EVENTS
    from spark_rapids_tpu.sql import plan as ref_plan
    from spark_rapids_tpu.sql import sources as ref_sources
    from spark_rapids_tpu_torch import session as port_session_mod
    from spark_rapids_tpu_torch.obs.events import EVENTS
    from spark_rapids_tpu_torch.sql import plan as port_plan
    from spark_rapids_tpu_torch.sql import sources as port_sources
    tiny = pd.DataFrame({"k": [1, 2], "v": [1.0, 2.0]})
    want = _outcomes(
        session,
        lambda d, p: _slow_df(session, ref_session.DataFrame, ref_plan,
                              ref_sources.InMemorySource, d, p),
        lambda: session.create_dataframe(tiny), REF_EVENTS)
    s = port_session()
    try:
        got = _outcomes(
            s,
            lambda d, p: _slow_df(s, port_session_mod.DataFrame, port_plan,
                                  port_sources.InMemorySource, d, p),
            lambda: s.create_dataframe(tiny), EVENTS)
    finally:
        s.stop()
    assert got == want
    assert got["cancel_running"] == "cancelled"
    assert got["deadline_running"] == "timeout"
    assert got["deadline_seconds"] == pytest.approx(0.3)
    assert got["cancel_queued_raises"] == "QueryCancelled"
    assert got["deadline_running_raises"] == "QueryTimeout"
    assert got["shed"] == "shed" and got["shed_total"] == 1


class _CountingScope(CancelScope):
    """A scope that cancels itself at its ``limit``-th batch pull (None:
    never), counting the pulls."""

    def __init__(self, limit=None):
        super().__init__()
        self.limit = limit
        self.pulls = 0

    def check(self) -> None:
        self.pulls += 1
        if self.limit is not None and self.pulls >= self.limit:
            self.cancel("stopped at a batch pull")
        super().check()


def test_cancelled_query_releases_its_buffers():
    """Q3 with broadcast joins (their tables in the spill catalog as the
    query's transients) cancelled a third and two thirds of the way
    through its batch pulls: the failure path frees every buffer."""
    from spark_rapids_tpu_torch.obs.events import EVENTS
    s = port_session()
    try:
        fr = {"lineitem": G.gen_lineitem(SF), "orders": G.gen_orders(SF),
              "customer": G.gen_customer(SF)}
        t = {n: s.create_dataframe(f, 4) for n, f in fr.items()}
        q = tpch.q3(s, t)
        want = q.collect()
        cat = s.buffer_catalog
        before = (cat.device_store.total_size, len(s._transient_bids))
        full = _CountingScope()
        with serving_context("tenant-x", full):
            q.collect()
        assert full.pulls > 6
        for limit in (full.pulls // 3, 2 * full.pulls // 3):
            scope = _CountingScope(limit)
            with serving_context("tenant-x", scope):
                with pytest.raises(QueryCancelled):
                    q.collect()
            assert (cat.device_store.total_size,
                    len(s._transient_bids)) == before
            ends = [e for e in EVENTS.flight_events()
                    if e["kind"] == "queryEnd"]
            assert ends[-1]["status"] == "cancelled"
            assert any(e["kind"] == "queryCancelled"
                       for e in EVENTS.flight_events())
        assert_frames_equal(q.collect(), want)
    finally:
        s.stop()


def test_semaphore_takes_the_serving_tenant():
    from spark_rapids_tpu_torch.memory.semaphore import TpuSemaphore
    sem = TpuSemaphore(4)
    sem.configure_tenants({"a": 1})
    with serving_context("a", None):
        sem.acquire_if_necessary(task_id=1)
    assert sem.tenant_usage()["a"]["held"] == 1
    scope = CancelScope(deadline_s=0.05)
    with serving_context("a", scope):
        with pytest.raises(QueryTimeout):
            sem.acquire_if_necessary(task_id=2)  # a's budget is held
    assert sem.tenant_usage()["a"]["waiting"] == 0
    sem.release(task_id=1)
    assert sem.available_permits() == 4


# ---------------------------------------------------------------------------
# AQE exchange reuse
# ---------------------------------------------------------------------------

def _reuse_cases(sess, F, registry) -> dict:
    sess.clear_serving_caches()
    sess.set_conf("spark.rapids.sql.adaptive.enabled", True)
    sess.set_conf("spark.rapids.tpu.serving.exchangeReuse.enabled", True)
    sess.set_conf("spark.rapids.sql.autoBroadcastJoinThreshold", -1)

    # one right-side DataFrame for every query: an in-memory source
    # versions by its data id, which in the port is per source object
    rdf = sess.create_dataframe(
        pd.DataFrame({"j": np.arange(20), "w": np.ones(20)}), 2)

    def join_query(left):
        ldf = sess.create_dataframe(left, 2)
        return ldf.join(rdf, left_on="k", right_on="j") \
            .group_by("k").agg(F.sum("w").alias("sw"))
    rng = np.random.default_rng(7)
    left = pd.DataFrame({"k": rng.integers(0, 20, 3000),
                         "v": rng.normal(size=3000)})
    q = join_query(left)
    out = {}
    first = q.collect()
    out["stages"] = sess.last_aqe["stages"]
    before = _counters(registry)
    second = q.collect()
    out["second"] = _delta(before, _counters(registry))
    out["decision"] = any(d["rule"] == "exchangeReuse"
                          for d in sess.last_aqe["decisions"])
    assert_frames_equal(first.sort_values("k").reset_index(drop=True),
                        second.sort_values("k").reset_index(drop=True))
    cache = sess._serving_bundle().exchange_cache
    with cache._lock:
        out["alive"] = all(st.map_outputs is not None
                           for st in cache._entries.values())
    out["entries"] = cache.stats()["entries"]
    before = _counters(registry)
    join_query(pd.DataFrame({"k": rng.integers(0, 20, 3000),
                             "v": rng.normal(size=3000)})).collect()
    out["new_data"] = _delta(before, _counters(registry))
    sess.clear_serving_caches()
    return out


def test_exchange_reuse_follows_the_jax_package(session):
    from spark_rapids_tpu.obs.metrics import REGISTRY as REF_REGISTRY
    from spark_rapids_tpu.sql import functions as RF
    from spark_rapids_tpu_torch.obs.metrics import REGISTRY
    from spark_rapids_tpu_torch.sql import functions as F
    try:
        want = _reuse_cases(session, RF, REF_REGISTRY)
    finally:
        session.reset_conf()
    s = port_session()
    try:
        got = _reuse_cases(s, F, REGISTRY)
    finally:
        s.stop()
    assert got == want
    assert got["second"].get("exchangereuse.hits", 0) >= 1
    assert got["decision"] and got["alive"]
    # new left rows: its stage misses (the unchanged right side's hits)
    assert got["new_data"].get("exchangereuse.misses", 0) >= 1


def test_counters_stay_exact_under_many_threads():
    """The module-level counters the smoke and the tests gate on
    (``ops/kernels.LAUNCHES``, ``obs/metrics.bump`` of the route and
    branch counters, ``obs/syncledger.SYNCS``) lose no update when 16
    threads bump them at a shortened switch interval."""
    import sys

    from spark_rapids_tpu_torch.obs.metrics import bump
    from spark_rapids_tpu_torch.obs.syncledger import SyncCounter
    from spark_rapids_tpu_torch.ops import kernels as K
    counts: dict = {}
    syncs = SyncCounter()
    K.reset_launches()
    n, per = 16, 2000
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(per):
                K._launched("compact_permutation", "compact_permutation",
                            "compact", None)
                bump(counts, "dense")
                syncs.add("site", 4)
        threads = [threading.Thread(target=work) for _ in range(n)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(prev)
    try:
        assert K.LAUNCHES["compact_permutation"] == n * per
        assert counts["dense"] == n * per
        assert syncs.syncs["site"] == n * per
        assert syncs.bytes["site"] == 4 * n * per
    finally:
        K.reset_launches()

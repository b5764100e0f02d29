"""The port's event journal and flight recorder
(``spark_rapids_tpu_torch/obs/events.py``) against the JAX package's.

The journal's unit cases are the JAX package's (``tests/test_events.py``
``TestEventLog``) run against the port's module: JSONL lines, rotation at
the size bound, truncation in place, gzip rotations and a mixed chain,
holes in the rotation chain, concurrent writers, the bounded ring, a dump
that excludes itself, a write failure counted as dropped, a failed
rotation that keeps appending. ``conf_fingerprint`` equals the JAX
package's on the same settings.

Session parity on the CPU, a few thousand rows from a numpy seed, both
sessions in test mode with the JAX package's filter fusion and broadcast
off (so both plans name the same operators): a filter + group-by, a join +
group-by and a general ``regexp_replace`` (left on the CPU by both) give
the same journal lifecycle (queryStart, queryPlan, cpuFallback for the
same operator with the same reasons, queryEnd) and the same
``tpuOps``/``cpuOps``/``coveragePct``; a failing query dumps the flight
recorder before its failed queryEnd in both. The kinds compared leave out
``hostSync`` (the packages sync at different sites by design),
``scanStall`` (the JAX package plans in-memory splits on its pool, the
port on the consuming thread) and the JAX package's compile events.
The subsystem events the port emits (spill, memoryPressure, outOfCore,
broadcastMaterialized, scanStall, scanBudgetStall, scanDeviceFallback,
aggSkipDecision, hostSync) are checked where they fire.
"""

import json
import os
import threading
import time

import numpy as np
import pandas as pd
import pytest

from spark_rapids_tpu.obs import events as ref_events
from spark_rapids_tpu.session import TpuSparkSession as RefSession
from spark_rapids_tpu.sql import functions as RF
from spark_rapids_tpu_torch.obs.events import (
    EVENTS, EventLog, conf_fingerprint, read_events,
)
from spark_rapids_tpu_torch.session import TpuSparkSession
from spark_rapids_tpu_torch.sql import functions as F
from spark_rapids_tpu_torch.testing.signals import release_sigusr1  # noqa: F401


@pytest.fixture(autouse=True)
def _events_reset_after():
    yield
    EVENTS.reset_for_tests()


# ---------------------------------------------------------------------------
# EventLog unit behavior (own instances)
# ---------------------------------------------------------------------------

class TestEventLog:
    def test_disabled_writes_nothing_but_rings(self, tmp_path):
        log = EventLog(ring_size=16)
        log.emit("spill", bytes=10)
        assert log.flight_events()[-1]["kind"] == "spill"
        assert list(tmp_path.iterdir()) == []

    def test_jsonl_lines_parse(self, tmp_path):
        path = str(tmp_path / "ev.jsonl")
        log = EventLog()
        log.configure(True, path)
        log.emit("a", x=1)
        log.emit("b", y="s")
        log.close()
        lines = [json.loads(ln) for ln in open(path)]
        assert [ev["kind"] for ev in lines] == ["a", "b"]
        assert lines[0]["seq"] < lines[1]["seq"]
        assert all("ts" in ev for ev in lines)

    def test_rotation_at_size_bound(self, tmp_path):
        path = str(tmp_path / "rot.jsonl")
        log = EventLog()
        log.configure(True, path, max_bytes=2000, rotations=2)
        for i in range(100):
            log.emit("tick", i=i, pad="x" * 40)
        log.close()
        assert log.rotations >= 3 and log.dropped == 0
        assert os.path.exists(path + ".1") and os.path.exists(path + ".2")
        assert not os.path.exists(path + ".3")
        for f in (path, path + ".1", path + ".2"):
            assert os.path.getsize(f) <= 2000
        events = read_events(path)
        seqs = [ev["seq"] for ev in events]
        assert seqs == sorted(seqs)
        assert events[-1]["i"] == 99

    def test_truncate_in_place_with_zero_rotations(self, tmp_path):
        path = str(tmp_path / "trunc.jsonl")
        log = EventLog()
        log.configure(True, path, max_bytes=500, rotations=0)
        for i in range(50):
            log.emit("tick", i=i)
        log.close()
        assert not os.path.exists(path + ".1")
        assert os.path.getsize(path) <= 500

    def test_concurrent_writers(self, tmp_path):
        path = str(tmp_path / "conc.jsonl")
        log = EventLog(ring_size=64)
        log.configure(True, path, max_bytes=1 << 20)
        n_threads, per_thread = 8, 50

        def work(t):
            for i in range(per_thread):
                log.emit("tick", thread=t, i=i)

        threads = [threading.Thread(target=work, args=(t,))
                   for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        log.close()
        events = [json.loads(ln) for ln in open(path)]
        assert len(events) == n_threads * per_thread
        assert log.dropped == 0
        seqs = [ev["seq"] for ev in events]
        assert len(set(seqs)) == len(seqs)
        for t in range(n_threads):
            mine = [ev["i"] for ev in events if ev["thread"] == t]
            assert mine == sorted(mine)
        assert len(log.flight_events()) == 64  # the ring stays bounded

    def test_ring_is_bounded(self):
        log = EventLog(ring_size=8)
        for i in range(20):
            log.emit("tick", i=i)
        ring = log.flight_events()
        assert [ev["i"] for ev in ring] == list(range(12, 20))

    def test_dump_flight_excludes_itself(self, tmp_path):
        path = str(tmp_path / "fd.jsonl")
        log = EventLog(ring_size=8)
        log.configure(True, path)
        log.emit("a")
        log.emit("b")
        dump = log.dump_flight(reason="test")
        assert dump["kind"] == "flightRecorder"
        assert [ev["kind"] for ev in dump["events"]] == ["a", "b"]
        assert isinstance(dump["syncs"], list)
        log.close()
        written = [json.loads(ln) for ln in open(path)]
        assert written[-1]["kind"] == "flightRecorder"
        assert written[-1]["count"] == 2
        dump2 = log.dump_flight(reason="again")
        assert [ev["kind"] for ev in dump2["events"]] == ["a", "b"]

    def test_write_failure_counts_dropped(self, tmp_path):
        log = EventLog()
        log.configure(True, str(tmp_path))  # a directory: open() fails
        log.emit("a")
        assert log.dropped == 1

    def test_gzip_rotation(self, tmp_path):
        import gzip
        path = str(tmp_path / "gz.jsonl")
        log = EventLog()
        log.configure(True, path, max_bytes=2000, rotations=2,
                      compress=True)
        for i in range(100):
            log.emit("tick", i=i, pad="x" * 40)
        log.close()
        assert log.rotations >= 3 and log.rotate_failures == 0
        assert os.path.exists(path + ".1.gz")
        assert os.path.exists(path + ".2.gz")
        assert not os.path.exists(path + ".1")
        assert not os.path.exists(path + ".3.gz")
        with gzip.open(path + ".1.gz", "rt") as f:
            assert all(json.loads(ln)["kind"] == "tick" for ln in f)
        events = read_events(path)
        assert [ev["seq"] for ev in events] == sorted(
            ev["seq"] for ev in events)
        assert events[-1]["i"] == 99

    def test_gzip_toggle_leaves_readable_mixed_chain(self, tmp_path):
        path = str(tmp_path / "mix.jsonl")
        log = EventLog()
        log.configure(True, path, max_bytes=1500, rotations=3)
        for i in range(40):
            log.emit("tick", i=i, pad="x" * 40)
        log.configure(True, path, max_bytes=1500, rotations=3,
                      compress=True)
        for i in range(40, 60):
            log.emit("tick", i=i, pad="x" * 40)
        log.close()
        exts = [e for n in (1, 2, 3) for e in ("", ".gz")
                if os.path.exists(f"{path}.{n}{e}")]
        assert ".gz" in exts and "" in exts
        events = read_events(path)
        assert [ev["seq"] for ev in events] == sorted(
            ev["seq"] for ev in events)
        assert events[-1]["i"] == 59

    def test_read_events_tolerates_rotation_holes(self, tmp_path):
        import gzip
        path = str(tmp_path / "holes.jsonl")

        def write(p, seqs, gz=False):
            opener = gzip.open if gz else open
            with opener(p, "wt") as f:
                for s in seqs:
                    f.write(json.dumps({"kind": "tick", "ts": float(s),
                                        "seq": s}) + "\n")
        write(path + ".3.gz", [1, 2], gz=True)
        write(path + ".1", [5, 6])
        write(path, [7, 8])
        assert [ev["seq"] for ev in read_events(path)] == [1, 2, 5, 6, 7, 8]
        # and the JAX package's reader sees the same events
        assert read_events(path) == ref_events.read_events(path)

    def test_rotation_failure_keeps_appending_honestly(self, tmp_path):
        path = str(tmp_path / "rf.jsonl")
        log = EventLog()
        log.configure(True, path, max_bytes=300, rotations=2)
        os.mkdir(path + ".2")  # unlink(dir) fails: rotation impossible
        for i in range(20):
            log.emit("tick", i=i)
        log.close()
        assert log.rotate_failures >= 1
        assert log.rotations == 0 and log.dropped == 0
        assert len([json.loads(ln) for ln in open(path)]) == 20

    def test_query_windows_tag_events_per_thread(self):
        log = EventLog()
        qid = log.query_start(tenant="t1", confFingerprint="x")
        ev = log.emit("spill", bytes=1)
        assert ev["query"] == qid and ev["tenant"] == "t1"
        log.query_end("success")
        assert "query" not in log.emit("spill", bytes=2)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_conf_fingerprint_as_the_jax_package(seed):
    rng = np.random.default_rng(seed)
    keys = ["spark.rapids.sql.enabled", "spark.rapids.sql.batchSizeRows",
            "spark.rapids.tpu.trace.path", "spark.rapids.sql.test.enabled",
            "spark.rapids.tpu.eventLog.maxFileBytes"]
    settings = {}
    for k in keys:
        if rng.random() < 0.7:
            settings[k] = [True, False, int(rng.integers(1, 1 << 20)),
                           "x%d" % rng.integers(0, 99), float(rng.random())
                           ][int(rng.integers(0, 5))]
    assert conf_fingerprint(settings) == ref_events.conf_fingerprint(
        settings)


# ---------------------------------------------------------------------------
# Session parity against the JAX package
# ---------------------------------------------------------------------------

PARITY_CONF = {"spark.rapids.sql.agg.fuseFilter": False,
               "spark.rapids.sql.exchange.fuseFilter": False,
               "spark.rapids.sql.autoBroadcastJoinThreshold": -1}
# the kinds both packages emit where they apply (module docstring)
LIFECYCLE = {"queryStart", "queryPlan", "cpuFallback", "queryEnd",
             "flightRecorder", "broadcastMaterialized", "outOfCore",
             "aggSkipDecision", "spill", "memoryPressure"}


def _frames(seed=7, n=4000):
    rng = np.random.default_rng(seed)
    left = pd.DataFrame({"k": rng.integers(0, 50, n).astype(np.int64),
                         "v": rng.random(n),
                         "g": rng.integers(0, 5, n).astype(np.int64)})
    right = pd.DataFrame({"k": np.arange(50, dtype=np.int64),
                          "w": rng.random(50)})
    strings = pd.DataFrame({"s": ["ab1", "cd22", "e333", "f"] * 25})
    return left, right, strings


def q_filter(s, fn, frames):
    left = frames[0][["g", "v"]]
    return (s.create_dataframe(left).filter(fn.col("v") > 0.25)
            .group_by("g").agg(fn.sum("v").alias("sv")))


def q_join(s, fn, frames):
    left, right, _ = frames
    return (s.create_dataframe(left).join(s.create_dataframe(right),
                                          on="k")
            .group_by("g").agg(fn.sum("w").alias("sw")))


def q_regex(s, fn, frames):
    return s.create_dataframe(frames[2]).select(
        fn.regexp_replace(fn.col("s"), "[0-9]+", "#").alias("r"))


QUERIES = {"filter_groupby": q_filter, "join_groupby": q_join,
           "regexp_replace": q_regex}


def run_both(qname, tmp_path, test_mode=True, conf=None):
    """The query through the port's session and the JAX package's, each
    with its journal at a file of its own: ((port events, port session),
    (JAX events, JAX session))."""
    frames = _frames()
    out = []
    ps = TpuSparkSession.builder().device("cpu").get_or_create()
    rs = RefSession.active()
    saved = dict(rs.conf._settings)
    try:
        for tag, s, fn, log in (("port", ps, F, EVENTS),
                                ("ref", rs, RF, ref_events.EVENTS)):
            path = str(tmp_path / f"{tag}_{qname}.jsonl")
            for k, v in dict(PARITY_CONF, **(conf or {})).items():
                s.set_conf(k, v)
            s.set_conf("spark.rapids.sql.enabled", True)
            s.set_conf("spark.rapids.sql.test.enabled", test_mode)
            s.set_conf("spark.rapids.tpu.eventLog.path", path)
            try:
                QUERIES[qname](s, fn, frames).collect()
            finally:
                s.set_conf("spark.rapids.tpu.eventLog.path", "")
                log.configure(False)
            out.append((read_events(path), s))
    finally:
        rs.conf._settings = saved
        ref_events.EVENTS.reset_for_tests()
    return out


def _kinds(events):
    return [ev["kind"] for ev in events if ev["kind"] in LIFECYCLE]


def _short_ops(plan):
    return [ln.strip().split("(")[0]
            for ln in plan.tree_string().splitlines()]


@pytest.mark.parametrize("qname", sorted(QUERIES))
def test_session_journal_as_the_jax_package(qname, tmp_path):
    (port, ps), (ref, rs) = run_both(qname, tmp_path,
                                     test_mode=qname != "regexp_replace")
    assert _kinds(port) == _kinds(ref)
    assert _kinds(port)[0] == "queryStart" and _kinds(port)[-1] == "queryEnd"
    qid = port[0]["query"]
    assert all(ev.get("query") == qid for ev in port)
    p_end, r_end = port[-1], ref[-1]
    assert p_end["status"] == r_end["status"] == "success"
    assert p_end["rowsReturned"] == r_end["rowsReturned"] > 0
    assert port[0]["confFingerprint"] and ref[0]["confFingerprint"]
    p_plan = next(ev for ev in port if ev["kind"] == "queryPlan")
    r_plan = next(ev for ev in ref if ev["kind"] == "queryPlan")
    assert p_plan["planTree"] == ps.last_plan.tree_string()
    assert _short_ops(ps.last_plan) == _short_ops(rs.last_plan)
    for key in ("tpuOps", "cpuOps", "coveragePct"):
        assert p_plan[key] == r_plan[key] == p_end[key] == r_end[key], key
    p_fb = [(ev["op"], ev["reasons"]) for ev in port
            if ev["kind"] == "cpuFallback"]
    r_fb = [(ev["op"], ev["reasons"]) for ev in ref
            if ev["kind"] == "cpuFallback"]
    assert p_fb == r_fb
    if qname == "regexp_replace":
        assert p_fb and p_fb[0][0] == "CpuProjectExec"
        assert any("CpuProjectExec" in k for k in p_end["cpuOpTime"])
        assert p_end["coveragePct"] < 100.0


def test_failing_query_dumps_the_flight_recorder_in_both(tmp_path,
                                                         monkeypatch):
    def boom(self, *args, **kwargs):
        raise RuntimeError("synthetic drain failure")
    monkeypatch.setattr(TpuSparkSession, "_drain", boom)
    monkeypatch.setattr(RefSession, "_drain", boom)
    frames = _frames()
    for s, fn, log, reader in (
            (TpuSparkSession.builder().device("cpu").get_or_create(), F,
             EVENTS, read_events),
            (RefSession.active(), RF, ref_events.EVENTS,
             ref_events.read_events)):
        path = str(tmp_path / f"{id(s)}.jsonl")
        s.set_conf("spark.rapids.tpu.eventLog.path", path)
        try:
            with pytest.raises(RuntimeError, match="synthetic"):
                q_filter(s, fn, frames).collect()
        finally:
            s.set_conf("spark.rapids.tpu.eventLog.path", "")
            log.reset_for_tests()
        events = reader(path)
        end = next(ev for ev in events if ev["kind"] == "queryEnd")
        assert end["status"] == "failed"
        assert "synthetic drain failure" in end["error"]
        dump = next(ev for ev in events if ev["kind"] == "flightRecorder")
        assert dump["count"] > 0
        assert any(ev["kind"] == "queryStart" for ev in dump["events"])
        assert events.index(dump) < events.index(end)
        assert [ev["kind"] for ev in events if ev["kind"] in LIFECYCLE] \
            == ["queryStart", "queryPlan", "flightRecorder", "queryEnd"]


# ---------------------------------------------------------------------------
# The port's session journal
# ---------------------------------------------------------------------------

def _port_session(**conf):
    b = TpuSparkSession.builder().device("cpu").config(
        "spark.rapids.sql.test.enabled", True)
    for k, v in conf.items():
        b.config(k, v)
    return b.get_or_create()


def _df(s, n=64):
    pdf = pd.DataFrame({"k": np.arange(n, dtype=np.int64) % 4,
                        "v": np.linspace(0.0, 1.0, n)})
    return s.create_dataframe(pdf, 2)


def test_dump_flight_recorder_api(tmp_path):
    path = str(tmp_path / "j.jsonl")
    s = _port_session(**{"spark.rapids.tpu.eventLog.path": path})
    _df(s).filter(F.col("v") > 0.5).collect()
    snap = s.dump_flight_recorder()
    assert any(ev["kind"] == "queryEnd" for ev in snap)
    events = read_events(path)
    assert events[-1]["kind"] == "flightRecorder"
    assert events[-1]["reason"] == "manual"
    assert events[-1]["syncs"]  # the sync ledger's tail rides along


def test_journal_off_the_ring_still_runs():
    s = _port_session()
    assert not EVENTS.enabled
    _df(s).filter(F.col("v") > 0.5).collect()
    kinds = [ev["kind"] for ev in EVENTS.flight_events()]
    assert "queryStart" in kinds and "queryEnd" in kinds


def test_spans_mirror_into_the_ring_while_tracing():
    from spark_rapids_tpu_torch.obs.trace import TRACER
    s = _port_session(**{"spark.rapids.tpu.trace.enabled": True})
    try:
        _df(s).filter(F.col("v") > 0.5).collect()
    finally:
        TRACER.configure(False)
        TRACER.clear()
    spans = [ev for ev in EVENTS.flight_events() if ev["kind"] == "span"]
    assert any(ev["name"] == "Query" for ev in spans)
    assert any(ev["name"] == "TpuFilterExec" for ev in spans)


def test_job_group_tags_events_and_tenant_counters(tmp_path):
    from spark_rapids_tpu_torch.obs.metrics import REGISTRY
    path = str(tmp_path / "j.jsonl")
    s = _port_session(**{"spark.rapids.tpu.eventLog.path": path})
    before = REGISTRY.value("tenant.queries", tenant="acme",
                            status="success")
    s.set_job_group("acme", "nightly")
    _df(s).collect()
    s.set_job_group(None)
    _df(s).collect()
    events = read_events(path)
    starts = [ev for ev in events if ev["kind"] == "queryStart"]
    assert starts[0]["tenant"] == "acme" and "tenant" not in starts[1]
    assert all(ev.get("tenant") == "acme" for ev in events
               if ev.get("query") == starts[0]["query"])
    assert REGISTRY.value("tenant.queries", tenant="acme",
                          status="success") == before + 1


def test_host_sync_events_carry_site_and_operator(tmp_path):
    path = str(tmp_path / "j.jsonl")
    s = _port_session(**{"spark.rapids.tpu.eventLog.path": path})
    _df(s).group_by("k").agg(F.sum("v").alias("sv")).collect()
    syncs = [ev for ev in read_events(path) if ev["kind"] == "hostSync"]
    sites = {ev["site"] for ev in syncs}
    assert {"scan.upload", "batch.fetch", "batch.rowCount"} <= sites
    assert any(ev["op"] == "Collect" for ev in syncs)
    assert any((ev["op"] or "").startswith("TpuScanExec") for ev in syncs)
    s.set_conf("spark.rapids.tpu.sync.ledger.eventMinSeconds", 3600.0)
    n = len(read_events(path))
    _df(s).collect()
    assert not [ev for ev in read_events(path)[n:]
                if ev["kind"] == "hostSync"]


def test_spill_and_pressure_events(tmp_path):
    rng = np.random.default_rng(5)
    pdf = pd.DataFrame({"k": rng.integers(0, 50, 20000).astype(np.int64),
                        "w": rng.integers(0, 1000, 20000).astype(np.int64),
                        "v": rng.random(20000)})
    path = str(tmp_path / "j.jsonl")
    s = _port_session(**{"spark.rapids.sql.cacheDeviceScans": True,
                         "spark.rapids.sql.batchSizeRows": 2048,
                         "spark.rapids.memory.spill.diskDir": str(tmp_path),
                         "spark.rapids.tpu.eventLog.path": path})
    s.device_manager.hbm_budget = 64 << 10
    s.buffer_catalog.host_store.limit_bytes = 128 << 10
    scan = s.create_dataframe(pdf)
    scan.filter(F.col("w") > 100).group_by("k").agg(
        F.sum("v").alias("sv")).collect()
    events = read_events(path)
    spills = [ev for ev in events if ev["kind"] == "spill"]
    assert {ev["direction"] for ev in spills} == {"device_to_host",
                                                  "host_to_disk"}
    assert all(ev["bytes"] > 0 and "buffer" in ev for ev in spills)
    mm = s.last_query_metrics["memory"]
    assert len([ev for ev in spills if ev["direction"] == "device_to_host"]
               ) == mm["spillEvents.device_to_host"]
    pressure = [ev for ev in events if ev["kind"] == "memoryPressure"]
    assert pressure and all(ev["freedBytes"] > 0 for ev in pressure)
    assert all(ev.get("query") == events[0]["query"] for ev in spills)
    s.stop()


def test_out_of_core_events(tmp_path):
    from spark_rapids_tpu_torch.exec import outofcore as ooc
    rng = np.random.default_rng(3)
    left = pd.DataFrame({"k": rng.integers(0, 300, 2500).astype(np.int64),
                         "v": rng.random(2500)})
    right = pd.DataFrame({"k": np.arange(0, 300, 2, dtype=np.int64)})
    path = str(tmp_path / "j.jsonl")
    s = _port_session(**{"spark.rapids.tpu.outOfCore.enabled": True,
                         "spark.rapids.tpu.outOfCore.partitionBytes": 32768,
                         "spark.rapids.sql.autoBroadcastJoinThreshold": -1,
                         "spark.rapids.tpu.eventLog.path": path})
    r0 = len(ooc.RECORDS)
    (s.create_dataframe(left, 3).join(s.create_dataframe(right, 2), on="k")
     .group_by("k").agg(F.count("*").alias("n")).collect())
    got = [ev for ev in read_events(path) if ev["kind"] == "outOfCore"]
    want = list(ooc.RECORDS)[r0:]
    assert got and len(got) == len(want)
    for ev, rec in zip(got, want):
        assert (ev["op"], ev["fanout"], ev["bytes"], ev["budgetBytes"],
                ev["level"]) == (rec["op"], rec["fanout"], rec["bytes"],
                                 rec["budget"], rec["level"])
    s.stop()


def test_broadcast_materialized_event(tmp_path):
    left, right, _ = _frames()
    path = str(tmp_path / "j.jsonl")
    s = _port_session(**{"spark.rapids.tpu.eventLog.path": path})
    s.create_dataframe(left).join(s.create_dataframe(right), on="k").collect()
    (ev,) = [ev for ev in read_events(path)
             if ev["kind"] == "broadcastMaterialized"]
    assert ev["batches"] == 1 and ev["bytes"] > 0


def test_agg_skip_decision_events(tmp_path):
    """A partial aggregate whose groups barely reduce its input measures
    the ratio, decides "skip" and journals it; the next execution decides
    from the session's ratio cache and journals that too."""
    rng = np.random.default_rng(9)
    n = 6000
    pdf = pd.DataFrame({"k": rng.permutation(n).astype(np.int64),
                        "v": rng.random(n)})
    path = str(tmp_path / "j.jsonl")
    s = _port_session(**{"spark.rapids.sql.batchSizeRows": 1024,
                         "spark.rapids.tpu.eventLog.path": path})
    df = s.create_dataframe(pdf, 1).group_by("k").agg(F.sum("v").alias("s"))
    df.collect()
    df.collect()
    got = [(ev["decision"], ev["source"]) for ev in read_events(path)
           if ev["kind"] == "aggSkipDecision"]
    assert got == [("skip", "measured"), ("skip", "cache")]


def test_scan_pipeline_stall_and_budget_events(tmp_path):
    from spark_rapids_tpu_torch.obs.metrics import REGISTRY
    from spark_rapids_tpu_torch.sql import scan_pipeline as sp
    EVENTS.configure(True, str(tmp_path / "j.jsonl"))

    def task(i):
        def run():
            time.sleep(0.02)
            return pd.DataFrame({"x": np.arange(1000) + i})
        return run
    pf = sp.ScanPrefetcher([task(i) for i in range(6)], 2,
                           sp.decode_pool(2), max_bytes=1)
    stalls0 = REGISTRY.value("scan.prefetch.budgetStalls")
    for i in range(6):
        assert int(pf.get(i).x[0]) == i
    kinds = [ev["kind"] for ev in read_events(str(tmp_path / "j.jsonl"))]
    assert "scanStall" in kinds and "scanBudgetStall" in kinds
    assert REGISTRY.value("scan.prefetch.budgetStalls") > stalls0
    assert REGISTRY.value("scan.prefetch.queueDepth") == 0
    assert REGISTRY.value("scan.prefetch.queueDepthPeak") >= 1


def test_scan_device_fallback_event(tmp_path):
    """A column written in v2 data pages falls back to the host decode: one
    scanDeviceFallback event per file, column and reason, not per row
    group."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    path = str(tmp_path / "v2.parquet")
    pq.write_table(pa.table({"a": np.arange(4000, dtype=np.int64)}), path,
                   data_page_version="2.0", row_group_size=1000)
    jpath = str(tmp_path / "j.jsonl")
    s = _port_session(**{"spark.rapids.tpu.eventLog.path": jpath})
    got = s.read.parquet(path).collect()
    assert list(got.a) == list(range(4000))
    fbs = [ev for ev in read_events(jpath)
           if ev["kind"] == "scanDeviceFallback"]
    assert len(fbs) == 1
    assert fbs[0]["column"] == "a" and fbs[0]["path"] == path
    assert fbs[0]["reason"] == "pageV2"

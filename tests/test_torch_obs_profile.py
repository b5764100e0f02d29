"""The port's per-query profile and live progress
(``spark_rapids_tpu_torch/obs/profile.py``, ``obs/progress.py``, the
operator wrapper of ``exec/base.py``) against the JAX package's.

On the same CPU queries from a numpy seed (a filter + group-by and a join +
group-by, a few thousand rows, both sessions with the JAX package's filter
fusion and broadcast off so both plans name the same operators), the
profile trees have the same operators and batches per node, and the same
rows wherever the JAX profile has them. The port's own contracts: under
``spark.rapids.sql.profile.syncEachOp`` every node's ``device_s +
transfer_s + dispatch_s`` equals its exclusive time within 1 ms, every
node's rows are known, and the root's inclusive time is at most the wall;
with metrics off there is no profile and the wrapper adds nothing; the
summary carries the query's scan, spill, memory and sync sections and the
truncation counters as the query's delta; the progress record follows
the plan.
"""

import json

import numpy as np
import pandas as pd
import pytest

from spark_rapids_tpu.session import TpuSparkSession as RefSession
from spark_rapids_tpu.sql import functions as RF
from spark_rapids_tpu_torch.obs.events import EVENTS
from spark_rapids_tpu_torch.obs.progress import PROGRESS
from spark_rapids_tpu_torch.obs.trace import TRACER
from spark_rapids_tpu_torch.session import TpuSparkSession
from spark_rapids_tpu_torch.sql import functions as F
from spark_rapids_tpu_torch.testing.signals import release_sigusr1  # noqa: F401

PARITY_CONF = {"spark.rapids.sql.agg.fuseFilter": False,
               "spark.rapids.sql.exchange.fuseFilter": False,
               "spark.rapids.sql.autoBroadcastJoinThreshold": -1}


@pytest.fixture(autouse=True)
def _reset_after():
    yield
    EVENTS.reset_for_tests()
    PROGRESS.reset_for_tests()
    TRACER.configure(False)
    TRACER.clear()


def _frames(seed=11, n=3000):
    rng = np.random.default_rng(seed)
    left = pd.DataFrame({"k": rng.integers(0, 40, n).astype(np.int64),
                         "v": rng.random(n),
                         "g": rng.integers(0, 6, n).astype(np.int64)})
    right = pd.DataFrame({"k": np.arange(40, dtype=np.int64),
                          "w": rng.random(40)})
    return left, right


def q_filter(s, fn):
    left = _frames()[0][["g", "v"]]
    return (s.create_dataframe(left).filter(fn.col("v") > 0.4)
            .group_by("g").agg(fn.sum("v").alias("sv")))


def q_join(s, fn):
    left, right = _frames()
    return (s.create_dataframe(left).join(s.create_dataframe(right), on="k")
            .group_by("g").agg(fn.sum("w").alias("sw")))


QUERIES = {"filter_groupby": q_filter, "join_groupby": q_join}


def _session(**conf):
    b = TpuSparkSession.builder().device("cpu").config(
        "spark.rapids.sql.test.enabled", True)
    for k, v in conf.items():
        b.config(k, v)
    return b.get_or_create()


def _ref_profile(q):
    rs = RefSession.active()
    saved = dict(rs.conf._settings)
    try:
        for k, v in dict(PARITY_CONF, **{"spark.rapids.sql.enabled": True,
                         "spark.rapids.sql.test.enabled": True}).items():
            rs.set_conf(k, v)
        out = q(rs, RF).collect()
        return out, rs.profile_json()
    finally:
        rs.conf._settings = saved


def _nodes(tree):
    out = [tree]
    for c in tree["children"]:
        out.extend(_nodes(c))
    return out


def _short(op):
    return op.split("(")[0]


@pytest.mark.parametrize("qname", sorted(QUERIES))
def test_profile_tree_as_the_jax_package(qname):
    q = QUERIES[qname]
    want_out, ref = _ref_profile(q)
    s = _session(**PARITY_CONF)
    got_out = q(s, F).collect()
    port = s.profile_json()
    assert len(got_out) == len(want_out)
    p_nodes, r_nodes = _nodes(port["plan"]), _nodes(ref["plan"])
    assert [_short(n["op"]) for n in p_nodes] == \
        [_short(n["op"]) for n in r_nodes]
    assert [len(n["children"]) for n in p_nodes] == \
        [len(n["children"]) for n in r_nodes]
    assert [n["batches"] for n in p_nodes] == [n["batches"] for n in r_nodes]
    known = [(p["rows"], r["rows"]) for p, r in zip(p_nodes, r_nodes)
             if r["rows"]]
    assert known and all(p == r for p, r in known)
    for n in p_nodes:
        assert n["inclusive_s"] >= n["exclusive_s"] >= 0.0
    assert port["version"] == ref["version"] == 1
    assert set(port) == set(ref)


@pytest.mark.parametrize("qname", sorted(QUERIES))
def test_sync_each_op_breakdown_sums_to_exclusive(qname):
    s = _session(**dict(PARITY_CONF, **{
        "spark.rapids.sql.profile.syncEachOp": True}))
    out = QUERIES[qname](s, F).collect()
    doc = s.profile_json()
    nodes = _nodes(doc["plan"])
    for n in nodes:
        bd = n["breakdown"]
        total = bd["device_s"] + bd["transfer_s"] + bd["dispatch_s"]
        assert abs(total - n["exclusive_s"]) <= 1e-3, n["op"]
        assert n["batches"] >= 1
    # the syncEachOp wait reads every batch's row count
    assert nodes[0]["rows"] == len(out)
    assert all(n["rows"] > 0 for n in nodes)
    assert nodes[0]["inclusive_s"] <= doc["wall_s"]
    sites = {g["site"] for g in doc["summary"]["syncs"]["bySite"]}
    assert "profile.syncEachOp" in sites
    assert set(s.last_node_times) == {id(n) for n in s.last_plan.walk()}
    assert "device_s is the device's only under" in s.profile_report()


def test_scan_nodes_report_transfer_seconds(tmp_path):
    path = str(tmp_path / "t.parquet")
    _frames()[0].to_parquet(path, row_group_size=1000)
    s = _session(**{"spark.rapids.sql.profile.syncEachOp": True})
    s.read.parquet(path).filter(F.col("v") > 0.5).collect()
    doc = s.profile_json()
    scan = next(n for n in _nodes(doc["plan"])
                if n["op"].startswith("TpuScanExec"))
    assert scan["breakdown"]["transfer_s"] > 0.0
    assert scan["rows"] == 3000 and scan["batches"] >= 1
    summary = doc["summary"]
    assert summary["scan"]["scan.device.splits"] == 3
    assert summary["scan"]["scan.decode.mode"] == "device"
    assert "scan.prefetch.queueDepthPeak" in summary["scan"]
    assert summary["memory"]["spillCount"] == 0


def test_metrics_off_no_profile_and_no_wrapper():
    s = _session(**{"spark.rapids.sql.metrics.enabled": False})
    df = q_filter(s, F)
    df.collect()
    assert s.profile_report() == "" and s.profile_json() is None
    assert "memory" in s.last_query_metrics
    from spark_rapids_tpu_torch.exec.base import ExecContext
    plan = s.physical_plan(df._plan)
    for metrics in (False, True):
        s.set_conf("spark.rapids.sql.metrics.enabled", metrics)
        part = plan.executed_partitions(ExecContext(s.conf, s, "cpu"))[0]
        # off, the operator's own partitions pass through unwrapped
        assert ("executed_partitions" in part.__qualname__) == metrics


def test_operator_metrics_in_last_query_metrics():
    s = _session()
    out = q_filter(s, F).collect()
    m = s.last_query_metrics
    scan = next(v for k, v in m.items() if k.startswith("TpuScanExec"))
    assert scan["numOutputRows"] == 3000 and scan["numOutputBatches"] == 1
    assert scan["totalTime"] > 0
    assert m["Collect"]["fetchTime"] > 0
    root = s.last_plan.describe()
    assert m[root]["numOutputBatches"] >= 1
    assert len(out) == 6
    rendered = s.profile_report()
    assert rendered.splitlines()[0].startswith("query wall:")
    assert "-- syncs" in rendered and "-- memory" in rendered


def test_profile_save_round_trips(tmp_path):
    s = _session()
    q_join(s, F).collect()
    path = tmp_path / "p" / "q.profile.json"
    s.last_profile.save(str(path))
    assert json.loads(path.read_text()) == json.loads(
        json.dumps(s.profile_json()))


def test_truncation_counters_are_the_query_delta(monkeypatch):
    orig = TpuSparkSession._drain

    def bumping(self, *args, **kwargs):
        EVENTS.dropped += 3
        EVENTS.rotations += 2
        TRACER._dropped += 5
        return orig(self, *args, **kwargs)
    s = _session()
    TRACER.clear()
    monkeypatch.setattr(TpuSparkSession, "_drain", bumping)
    q_filter(s, F).collect()
    assert s.profile_json()["summary"]["observability"] == {
        "trace.droppedEvents": 5, "eventLog.droppedEvents": 3,
        "eventLog.rotations": 2}
    assert "eventLog.rotations: 2" in s.profile_report()
    monkeypatch.setattr(TpuSparkSession, "_drain", orig)
    q_filter(s, F).collect()  # the earlier query's damage is not this one's
    assert "observability" not in s.profile_json()["summary"]


def test_progress_follows_the_plan():
    PROGRESS.configure(True)
    s = _session()
    s.set_job_group("team-a", "daily report")
    q_join(s, F).collect()
    (snap,) = PROGRESS.queries(full=True)
    assert snap["status"] == "success" and snap["tenant"] == "team-a"
    assert snap["description"] == "daily report"
    assert snap["scan"]["batchesUploaded"] == 2
    assert snap["scan"]["rowsUploaded"] == 3040
    assert snap["heartbeats"] > 0
    ops = {row["op"] for row in snap["plan"] if "batches" in row}
    assert ops == {n.describe() for n in s.last_plan.walk()}
    assert snap["plan"][0]["depth"] == 0
    PROGRESS.configure(False)
    q_join(s, F).collect()
    assert len(PROGRESS.queries()) == 1  # off: nothing recorded


def test_progress_records_a_failure(monkeypatch):
    PROGRESS.configure(True)
    s = _session()

    def boom(self, *args, **kwargs):
        raise RuntimeError("synthetic")
    monkeypatch.setattr(TpuSparkSession, "_drain", boom)
    with pytest.raises(RuntimeError):
        q_filter(s, F).collect()
    (snap,) = PROGRESS.queries()
    assert snap["status"] == "failed" and "synthetic" in snap["error"]
    assert not snap["scan"]["stalled"]

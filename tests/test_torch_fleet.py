"""The port's fleet tier (``spark_rapids_tpu_torch/serving/fleet/``)
against the JAX package's, on the CPU.

  * ``HashRing`` and ``PlacementPolicy`` place 200 tenants (and their
    spill-over and drained cases) exactly as the JAX package's do;
  * the router over ``LocalWorker`` replicas (a ``QueryScheduler`` each
    over one port session, no process boot) covers the JAX package's
    ``tests/test_fleet.py`` cases: sticky placement and result round
    trip, overrides, spill-over, a worker-side shed with its replica,
    deadlines burned in the router's queue, crash -> ``worker lost`` ->
    re-placement, quiesce/drain/restore, a rolling restart with no shed,
    the ``/api/fleet`` snapshot and a closed router;
  * a session and scheduler at the default confs never import the fleet
    package (a subprocess);
  * one ``launch_process_fleet(2, ...)`` of ``device="cpu"`` workers at
    SF 0.002: two tenants' Q1 and Q6 equal each worker's oracle, and a
    rolling restart of r1, pre-warmed from the fleet's manifest, sheds
    no job.
"""

import os
import subprocess
import sys
import time

import pytest

from spark_rapids_tpu_torch.obs.events import EVENTS
from spark_rapids_tpu_torch.serving.fleet.placement import (
    HashRing, PlacementPolicy, parse_overrides,
)
from spark_rapids_tpu_torch.serving.fleet.router import (
    FleetRouter, LocalWorker, snapshot_all,
)
from spark_rapids_tpu_torch.session import TpuSparkSession
from spark_rapids_tpu_torch.testing.signals import release_sigusr1  # noqa: F401

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def psession():
    s = TpuSparkSession.builder().device("cpu").get_or_create()
    yield s
    s.stop()


def _local_fleet(session, n=2, workers=1, max_queue=None,
                 spillover_depth=4, overrides=None):
    handles = {f"r{i}": LocalWorker(f"r{i}", session, workers=workers,
                                    max_queue=max_queue)
               for i in range(n)}
    return FleetRouter(handles, spillover_depth=spillover_depth,
                       overrides=overrides), handles


# ---------------------------------------------------------------------------
# Placement against the JAX package's
# ---------------------------------------------------------------------------

def test_placement_of_200_tenants_equals_the_jax_package():
    from spark_rapids_tpu.serving.fleet import placement as ref
    replicas = ["r0", "r1", "r2", "r3"]
    tenants = [f"tenant-{i}" for i in range(200)]
    ring, ref_ring = HashRing(replicas), ref.HashRing(replicas)
    assert [ring.lookup(t) for t in tenants] == \
        [ref_ring.lookup(t) for t in tenants]
    assert [ring.lookup(t, {"r1", "r3"}) for t in tenants] == \
        [ref_ring.lookup(t, {"r1", "r3"}) for t in tenants]
    pins = "tenant-3=r2,tenant-7=r0"
    pol = PlacementPolicy(replicas, overrides=parse_overrides(pins),
                          spillover_depth=2)
    ref_pol = ref.PlacementPolicy(replicas,
                                  overrides=ref.parse_overrides(pins),
                                  spillover_depth=2)
    for depths in ({r: 0 for r in replicas},
                   {"r0": 2, "r1": 0, "r2": 5, "r3": 1},
                   {"r1": 0, "r3": 3}, {}):
        assert [pol.place(t, depths) for t in tenants] == \
            [ref_pol.place(t, depths) for t in tenants]
    pol.remove_replica("r2")
    ref_pol.remove_replica("r2")
    depths = {"r0": 0, "r1": 0, "r3": 0}
    assert [pol.place(t, depths) for t in tenants] == \
        [ref_pol.place(t, depths) for t in tenants]


def test_placement_policy_units():
    p = PlacementPolicy(["r0", "r1", "r2"])
    depths = {"r0": 0, "r1": 0, "r2": 0}
    first = p.place("alice", depths)
    assert all(p.place("alice", depths) == first for _ in range(5))
    assert first[1] == "sticky"
    ring = HashRing(["r0", "r1", "r2"])
    assert {ring.lookup(f"tenant-{i}", {"r0", "r1", "r2"})
            for i in range(50)} == {"r0", "r1", "r2"}
    assert PlacementPolicy(["r0", "r1"], overrides={"alice": "r1"}).place(
        "alice", {"r0": 0, "r1": 0}) == ("r1", "override")
    assert parse_overrides("alice=r1,bob=r0, bad,=x") == {
        "alice": "r1", "bob": "r0"}
    p = PlacementPolicy(["r0", "r1", "r2"], spillover_depth=2)
    sticky = p.place("alice", {"r0": 0, "r1": 0, "r2": 0})[0]
    depths = {r: 0 for r in ("r0", "r1", "r2")}
    depths[sticky] = 2
    rid, reason = p.place("alice", depths)
    assert rid != sticky and reason == "spillover"
    assert p.place("alice", {}) is None


# ---------------------------------------------------------------------------
# The router over LocalWorker replicas
# ---------------------------------------------------------------------------

def test_sticky_and_result_roundtrip(psession):
    router, _ = _local_fleet(psession, n=3)
    try:
        jobs = []
        for _ in range(3):  # one at a time: depths stay 0, no spill
            j = router.submit({"kind": "noop"}, tenant="alice",
                              want_result=True)
            assert j.wait(30.0) == "succeeded", j.error
            jobs.append(j)
        assert len({j.replica for j in jobs}) == 1
        assert jobs[0].reason == "sticky"
        df = jobs[0].result()
        assert list(df.columns) == ["a", "b"] and len(df) == 8
    finally:
        router.shutdown()


def test_override_routes_tenant(psession):
    router, _ = _local_fleet(psession, n=2, overrides="alice=r1,bob=r0")
    try:
        ja = router.submit({"kind": "noop"}, tenant="alice")
        jb = router.submit({"kind": "noop"}, tenant="bob")
        assert ja.wait(30.0) == "succeeded"
        assert jb.wait(30.0) == "succeeded"
        assert (ja.replica, ja.reason) == ("r1", "override")
        assert (jb.replica, jb.reason) == ("r0", "override")
    finally:
        router.shutdown()


def test_spillover_moves_excess_load(psession):
    router, _ = _local_fleet(psession, n=2, spillover_depth=1)
    try:
        jobs = [router.submit({"kind": "sleep", "seconds": 0.4},
                              tenant="alice") for _ in range(3)]
        assert router.drain(timeout=30.0)
        assert all(j.status == "succeeded" for j in jobs)
        assert {j.replica for j in jobs} == {"r0", "r1"}
        assert "spillover" in {j.reason for j in jobs}
    finally:
        router.shutdown()


def test_worker_shed_surfaces_with_replica_attribution(psession):
    EVENTS.reset_for_tests()
    router, _ = _local_fleet(psession, n=1, max_queue=1)
    try:
        jobs = [router.submit({"kind": "sleep", "seconds": 0.5},
                              tenant="alice") for _ in range(4)]
        assert router.drain(timeout=30.0)
        statuses = [j.status for j in jobs]
        assert "shed" in statuses and "succeeded" in statuses
        shed = [j for j in jobs if j.status == "shed"]
        assert all(j.replica == "r0" for j in shed)
        assert router.snapshot()["shedTotal"] == len(shed)
        evs = [e for e in EVENTS.flight_events()
               if e["kind"] == "queryShed" and e.get("replica")]
        assert evs and evs[0]["replica"] == "r0"
        assert evs[0]["tenant"] == "alice"
    finally:
        router.shutdown()


def test_deadline_burned_in_router_queue_times_out_on_arrival(psession):
    router, _ = _local_fleet(psession, n=1)
    try:
        router.quiesce("r0")  # no eligible replica: the queue holds
        j = router.submit({"kind": "noop"}, tenant="alice",
                          deadline_s=0.15)
        time.sleep(0.4)  # the whole budget spent upstream
        router.restore("r0")
        assert j.wait(30.0) == "timeout"
        assert "expired before admission" in (j.error or "")
        ok = router.submit({"kind": "noop"}, tenant="alice",
                           deadline_s=30.0)
        assert ok.wait(30.0) == "succeeded", ok.error
    finally:
        router.shutdown()


def test_crash_loses_inflight_and_replaces_tenant(psession):
    EVENTS.reset_for_tests()
    router, handles = _local_fleet(psession, n=2)
    try:
        hang = router.submit({"kind": "sleep", "seconds": 2.0},
                             tenant="alice")
        deadline = time.monotonic() + 10.0
        while hang.replica is None and time.monotonic() < deadline:
            time.sleep(0.01)
        assert hang.replica is not None
        handles[hang.replica].crash()
        assert hang.wait(10.0) == "lost"
        assert "lost" in (hang.error or "")
        evs = [e for e in EVENTS.flight_events()
               if e["kind"] == "workerLost"]
        assert evs and evs[0]["replica"] == hang.replica
        assert evs[0]["inflightFailed"] == 1
        j2 = router.submit({"kind": "noop"}, tenant="alice")
        assert j2.wait(30.0) == "succeeded", j2.error
        assert j2.replica != hang.replica
        snap = router.snapshot(include_workers=False)
        assert snap["workersLost"] == 1
        states = {w["replica"]: w["state"] for w in snap["workers"]}
        assert states[hang.replica] == "lost"
    finally:
        router.shutdown()


def test_quiesce_drain_restore(psession):
    router, _ = _local_fleet(psession, n=1)
    try:
        j = router.submit({"kind": "sleep", "seconds": 0.3},
                          tenant="alice")
        deadline = time.monotonic() + 10.0
        while j.replica is None and time.monotonic() < deadline:
            time.sleep(0.01)
        assert router.quiesce("r0") == 1
        assert router.wait_drained("r0", timeout=10.0)
        assert j.status == "succeeded"
        j2 = router.submit({"kind": "noop"}, tenant="alice")
        time.sleep(0.3)
        assert j2.status == "queued"
        assert router.queue_depth() == 1
        router.restore("r0")
        assert j2.wait(30.0) == "succeeded", j2.error
    finally:
        router.shutdown()


def test_rolling_restart_swaps_handle_zero_shed(psession):
    EVENTS.reset_for_tests()
    router, _ = _local_fleet(psession, n=1)
    try:
        pre = [router.submit({"kind": "sleep", "seconds": 0.2},
                             tenant="alice") for _ in range(2)]
        replacement = LocalWorker("r0", psession)
        out = router.rolling_restart("r0", lambda: replacement,
                                     drain_timeout=30.0, ready_timeout=10.0)
        assert out["drained"] and out["ready"]
        assert router.worker("r0") is replacement
        post = router.submit({"kind": "noop"}, tenant="alice")
        assert post.wait(30.0) == "succeeded", post.error
        assert all(j.status == "succeeded" for j in pre)
        assert router.snapshot()["shedTotal"] == 0
        kinds = [e["kind"] for e in EVENTS.flight_events()]
        assert "workerDrain" in kinds and "workerReady" in kinds
    finally:
        router.shutdown()


def test_snapshot_shape_and_monitor_route(psession):
    router, _ = _local_fleet(psession, n=2)
    try:
        j = router.submit({"kind": "noop"}, tenant="alice")
        assert j.wait(30.0) == "succeeded"
        snap = router.snapshot(include_workers=True)
        for key in ("workers", "placement", "placementChurn", "shedTotal",
                    "workersLost", "routerQueueDepth", "jobs", "closed"):
            assert key in snap
        assert snap["placement"]["alice"] == j.replica
        live = {w["replica"]: w for w in snap["workers"]}
        assert live[j.replica]["completed"]["succeeded"] == 1
        assert "scheduler" in live[j.replica]
        assert any(f["jobs"] == 1 for f in snapshot_all()["fleets"])
    finally:
        router.shutdown()
    assert snapshot_all()["fleets"] == []  # shutdown deregisters


def test_closed_router_rejects_submissions(psession):
    router, _ = _local_fleet(psession, n=1)
    router.shutdown()
    with pytest.raises(RuntimeError):
        router.submit({"kind": "noop"})


def test_default_conf_serving_never_imports_the_fleet():
    prog = (
        "import sys\n"
        "sys.path.insert(0, %r)\n"
        "import pandas as pd\n"
        "from spark_rapids_tpu_torch.session import TpuSparkSession\n"
        "from spark_rapids_tpu_torch.serving.scheduler import "
        "QueryScheduler\n"
        "s = TpuSparkSession.builder().device('cpu').get_or_create()\n"
        "sched = QueryScheduler(s, workers=1)\n"
        "job = sched.submit(lambda sess: sess.create_dataframe(\n"
        "    pd.DataFrame({'a': [1, 2]}), 1))\n"
        "job.wait(); sched.close()\n"
        "assert job.status == 'succeeded', job.error\n"
        "bad = [m for m in sys.modules\n"
        "       if m.startswith('spark_rapids_tpu_torch.serving.fleet')]\n"
        "assert not bad, bad\n"
        "print('FLEET_FREE')\n" % _REPO)
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "FLEET_FREE" in out.stdout


# ---------------------------------------------------------------------------
# Two worker processes on the CPU
# ---------------------------------------------------------------------------

def test_process_fleet_answers_equal_the_oracle_and_restart_sheds_nothing(
        tmp_path):
    from spark_rapids_tpu_torch.serving.fleet.router import (
        launch_process_fleet,
    )
    from spark_rapids_tpu_torch.serving.fleet.worker import (
        deserialize_frame,
    )
    from tests.querytest import assert_frames_equal
    router = launch_process_fleet(
        2, str(tmp_path / "fleet"),
        base_conf={"spark.rapids.sql.test.enabled": True},
        spec_extras={"device": "cpu", "schedulerWorkers": 2},
        start_timeout=60.0)
    try:
        queries = [{"kind": "suite", "suite": "tpch", "query": q,
                    "sf": 0.002} for q in ("q1", "q6")]
        jobs = [router.submit(q, tenant=t, want_result=True)
                for t in ("alice", "bob") for q in queries]
        assert router.drain(timeout=60.0)
        for j in jobs:
            assert j.status == "succeeded", j.error
            oracle = router.worker(j.replica).oracle(j.query)
            assert_frames_equal(j.result(),
                                deserialize_frame(oracle["result"]),
                                ignore_order=True, approx=True)
        st = router.worker("r0").status()
        assert st["compiles"]["backend"] == 0  # no nvcc on the CPU
        out = router.restart_process_worker("r1", drain_timeout=30.0,
                                            ready_timeout=60.0)
        assert out["ready"] and out["drained"], out
        assert out["aot"] is not None and "prime" in out["aot"]
        post = [router.submit(q, tenant="bob") for q in queries]
        assert router.drain(timeout=60.0)
        assert all(j.status == "succeeded" for j in post), \
            [j.error for j in post]
        assert router.snapshot(include_workers=False)["shedTotal"] == 0
    finally:
        router.shutdown()

"""The port's live monitor (``spark_rapids_tpu_torch/obs/monitor.py``)
against the JAX package's, on the CPU: the cases of the JAX package's
``tests/test_monitor.py`` (its history server left out).

  * ``render_prometheus`` renders one registry content, filled alike in
    both packages' registries, to identical text;
  * the endpoints of a port session with ``spark.rapids.tpu.ui.enabled``
    on port 0: ``/healthz``, ``/api/status`` (the device and the memory
    runtime), ``/api/queries`` and ``/api/query/<id>``, the 404, the HTML
    view, a failed query's terminal state and a query seen mid-drain,
    ``/metrics`` in valid Prometheus text, tenants everywhere,
    ``/api/scheduler`` of a live scheduler and ``/api/fleet``;
  * off by default (no thread, no progress), off again when the conf
    turns off, a port change rebinds, a busy port warns once;
  * SIGUSR1 dumps the diagnostics into the journal off the signal's
    thread, and an application's own handler is never replaced.
"""

import json
import os
import re
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pandas as pd
import pytest

from spark_rapids_tpu_torch.obs import monitor
from spark_rapids_tpu_torch.obs.events import EVENTS, read_events
from spark_rapids_tpu_torch.obs.progress import PROGRESS
from spark_rapids_tpu_torch.session import TpuSparkSession
from spark_rapids_tpu_torch.sql import functions as F
from spark_rapids_tpu_torch.testing.signals import release_sigusr1  # noqa: F401


@pytest.fixture(autouse=True)
def _monitor_reset_after():
    yield
    monitor.stop()
    PROGRESS.reset_for_tests()
    EVENTS.reset_for_tests()


@pytest.fixture
def psession():
    s = TpuSparkSession.builder().device("cpu").get_or_create()
    yield s
    s.stop()


@pytest.fixture
def ui_session(psession):
    psession.set_conf("spark.rapids.tpu.ui.enabled", True)
    psession.set_conf("spark.rapids.tpu.ui.port", 0)  # ephemeral
    yield psession
    psession.clear_job_group()


def _get(path, code=200):
    srv = monitor.server()
    assert srv is not None, "monitor server not running"
    try:
        with urllib.request.urlopen(srv.url + path, timeout=10) as r:
            assert r.status == code
            return r.read().decode()
    except urllib.error.HTTPError as e:
        assert e.code == code, (e.code, path)
        return e.read().decode()


def _df(session, n=200):
    pdf = pd.DataFrame({"k": np.arange(n, dtype=np.int64) % 8,
                        "v": np.linspace(0.0, 1.0, n)})
    return session.create_dataframe(pdf, 2)


# ---------------------------------------------------------------------------
# Prometheus text against the JAX package's
# ---------------------------------------------------------------------------

def _fill(registry) -> None:
    registry.counter("tenant.queries", tenant="a", status="success").add(3)
    registry.counter("tenant.queries", tenant="b", status="failed").add(1)
    registry.counter("plancache.hits", tenant='q"uo\\te').add(2)
    registry.gauge("semaphore.holders").set(2)
    registry.gauge("scan.prefetch.queueDepthPeak").set(7)
    t = registry.timer("compileCache.backendCompileTime")
    for s in (0.5, 1.25, 4.0):
        t.record(s)
    h = registry.histogram("shuffle.transport.rttSeconds", peer="p1")
    for v in (0.001, 0.002, 0.004, 0.008, 0.5):
        h.observe(v)


def test_prometheus_text_equals_the_jax_package():
    from spark_rapids_tpu.obs import metrics as ref_metrics
    from spark_rapids_tpu.obs import monitor as ref_monitor
    from spark_rapids_tpu_torch.obs import metrics
    ref_reg, reg = ref_metrics.MetricsRegistry(), metrics.MetricsRegistry()
    _fill(ref_reg)
    _fill(reg)
    want = ref_monitor.render_prometheus(ref_reg)
    got = monitor.render_prometheus(reg)
    assert got == want
    assert "srt_tenant_queries_total" in got


_LABEL = r'[a-zA-Z_][a-zA-Z0-9_]*="(?:\\.|[^"\\])*"'
_SAMPLE_RE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*"
    rf"(\{{{_LABEL}(,{_LABEL})*\}})?"
    r" -?[0-9]+(\.[0-9]+)?([eE][+-]?[0-9]+)?$")


def test_metrics_endpoint_is_valid_prometheus_text(ui_session):
    from spark_rapids_tpu_torch.obs.metrics import REGISTRY
    REGISTRY.counter("test.escape", why='quote"back\\slash').add(1)
    _df(ui_session).group_by("k").count().collect()
    body = _get("/metrics")
    assert body.endswith("\n")
    seen, family, samples = {}, None, set()
    for line in body.splitlines():
        if line.startswith("#"):
            m = re.match(r"^# TYPE ([a-zA-Z_:][a-zA-Z0-9_:]*) "
                         r"(counter|gauge|summary|histogram)$", line)
            assert m, line
            assert m.group(1) not in seen
            seen[m.group(1)] = m.group(2)
            family = m.group(1)
            continue
        assert _SAMPLE_RE.match(line), line
        name = line.split("{")[0].split(" ")[0]
        assert name in (family, family + "_sum", family + "_count"), line
        key = line.rsplit(" ", 1)[0]
        assert key not in samples
        samples.add(key)
    assert all(f.endswith("_total") for f, t in seen.items()
               if t == "counter")
    assert re.search(r'^srt_tenant_queries_total\{.*status="success".*\} '
                     r'[0-9]+', body, re.M)
    assert 'why="quote\\"back\\\\slash"' in body


# ---------------------------------------------------------------------------
# Live endpoints
# ---------------------------------------------------------------------------

def test_healthz_and_status(ui_session):
    _df(ui_session).group_by("k").count().collect()
    health = json.loads(_get("/healthz"))
    assert health["status"] == "ok" and health["uptime_s"] >= 0
    status = json.loads(_get("/api/status"))
    assert status["status"] == "ok" and "eventLog" in status
    assert status["device"] == {"platform": "cpu", "name": "cpu"}
    mem = status["memory"]
    assert 0 < mem["budgetBytes"] <= mem["deviceTotalBytes"]
    for key in ("meteredBytes", "deviceStoreBytes", "hostStoreBytes",
                "diskStoreBytes"):
        assert key in mem
    assert status["semaphore"]["permits"] >= 1
    assert "tpu" not in json.dumps(status).lower().replace(
        "spark.rapids.tpu", "")


def test_query_progress_and_404(ui_session):
    _df(ui_session).group_by("k").agg(F.sum("v").alias("sv")).collect()
    queries = json.loads(_get("/api/queries"))["queries"]
    assert queries
    q = queries[0]
    assert q["status"] == "success" and q["heartbeats"] > 0
    assert q["end_ts"] is not None and q["wall_s"] > 0
    full = json.loads(_get("/api/query/" + q["id"]))
    assert full["plan"] and full["operators"]
    assert any(r.get("batches", 0) >= 1 for r in full["plan"])
    assert "error" in json.loads(_get("/api/query/q-does-not-exist",
                                      code=404))
    page = _get("/")
    assert "<html" in page and "/api/queries" in page


def test_failed_query_terminal_state(ui_session, monkeypatch):
    def boom(self, plan, ctx, collect=True):
        raise RuntimeError("synthetic monitor failure")
    monkeypatch.setattr(TpuSparkSession, "_drain", boom)
    with pytest.raises(RuntimeError, match="synthetic"):
        _df(ui_session).collect()
    queries = json.loads(_get("/api/queries"))["queries"]
    failed = [q for q in queries if q["status"] == "failed"]
    assert failed and "synthetic monitor failure" in failed[0]["error"]
    assert json.loads(_get("/api/status"))["inflightQueries"] == 0


def test_live_view_mid_query(ui_session, monkeypatch):
    orig = TpuSparkSession._drain
    seen = {}

    def snooping(self, plan, ctx, collect=True):
        out = orig(self, plan, ctx, collect)
        mid = json.loads(_get("/api/queries"))["queries"]
        seen["mid"] = [q for q in mid if q["status"] == "running"]
        seen["status"] = json.loads(_get("/api/status"))
        return out
    monkeypatch.setattr(TpuSparkSession, "_drain", snooping)
    _df(ui_session).group_by("k").count().collect()
    assert seen["mid"] and seen["status"]["inflightQueries"] == 1


def test_tenant_flows_everywhere(ui_session, tmp_path):
    log = str(tmp_path / "tenants.jsonl")
    ui_session.set_conf("spark.rapids.tpu.eventLog.path", log)
    ui_session.set_job_group("team-red", "red dashboards")
    try:
        _df(ui_session).group_by("k").count().collect()
        ui_session.set_job_group("team-blue", "blue etl")
        _df(ui_session).filter(F.col("v") > 0.25).collect()
    finally:
        ui_session.set_conf("spark.rapids.tpu.eventLog.path", "")
        ui_session.clear_job_group()
    events = read_events(log)
    assert {ev["tenant"] for ev in events if "tenant" in ev} == {
        "team-red", "team-blue"}
    for kind in ("queryStart", "queryPlan", "queryEnd"):
        assert all("tenant" in ev for ev in events if ev["kind"] == kind)
    body = _get("/metrics")
    assert 'tenant="team-red"' in body and 'tenant="team-blue"' in body
    queries = json.loads(_get("/api/queries"))["queries"]
    assert {q["tenant"] for q in queries} >= {"team-red", "team-blue"}
    tenants = json.loads(_get("/api/tenants"))["tenants"]
    assert tenants["team-red"]["queries"] >= 1
    assert tenants["team-blue"]["queries"] >= 1
    assert tenants["team-red"]["wall_s"] > 0


def test_scheduler_and_fleet_routes(ui_session):
    ui_session.set_conf("spark.rapids.tpu.serving.tenant.defaultPermits", 1)
    sched = ui_session.serving_scheduler(workers=2)
    try:
        job = sched.submit(lambda s: _df(s).group_by("k").count(),
                           tenant="snap")
        assert job.wait(60) == "succeeded", job.error
        snaps = json.loads(_get("/api/scheduler"))["schedulers"]
        mine = [s for s in snaps if s["workers"] == 2]
        assert mine and mine[0]["tenants"]["snap"]["succeeded"] == 1
        assert mine[0]["tenants"]["snap"]["quota"]["budget"] == 1
    finally:
        sched.close()
    import sys
    doc = json.loads(_get("/api/fleet"))
    if "spark_rapids_tpu_torch.serving.fleet.router" not in sys.modules:
        assert doc == {"fleets": []}
    else:
        assert "fleets" in doc


# ---------------------------------------------------------------------------
# Off by default
# ---------------------------------------------------------------------------

def test_no_thread_no_progress_by_default(psession):
    assert not psession.conf.get("spark.rapids.tpu.ui.enabled")
    _df(psession).group_by("k").count().collect()
    assert monitor.server() is None
    assert not PROGRESS.enabled and PROGRESS.queries() == []
    assert not any(t.name == "tpu-ui" for t in threading.enumerate())


def test_toggle_off_stops_and_port_change_rebinds(ui_session):
    import socket
    _df(ui_session).filter(F.col("v") > 0.5).collect()
    first = monitor.server()
    assert first is not None
    _df(ui_session).filter(F.col("v") > 0.5).collect()
    assert monitor.server() is first
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    new_port = probe.getsockname()[1]
    probe.close()
    ui_session.set_conf("spark.rapids.tpu.ui.port", new_port)
    _df(ui_session).filter(F.col("v") > 0.5).collect()
    assert monitor.server() is not first
    assert monitor.server().port == new_port
    ui_session.set_conf("spark.rapids.tpu.ui.enabled", False)
    _df(ui_session).filter(F.col("v") > 0.5).collect()
    assert monitor.server() is None and not PROGRESS.enabled


def test_bind_failure_warns_once_and_stays_off(psession, caplog):
    import logging
    import socket
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    sock.listen(1)
    psession.set_conf("spark.rapids.tpu.ui.enabled", True)
    psession.set_conf("spark.rapids.tpu.ui.port", sock.getsockname()[1])
    try:
        with caplog.at_level(logging.WARNING,
                             logger="spark_rapids_tpu_torch.obs.monitor"):
            _df(psession).filter(F.col("v") > 0.5).collect()
            _df(psession).filter(F.col("v") > 0.5).collect()
        warns = [r for r in caplog.records
                 if "could not bind" in r.getMessage()]
        assert len(warns) == 1
        assert monitor.server() is None and not PROGRESS.enabled
        psession.set_conf("spark.rapids.tpu.ui.enabled", False)
        _df(psession).filter(F.col("v") > 0.5).collect()
        psession.set_conf("spark.rapids.tpu.ui.enabled", True)
        psession.set_conf("spark.rapids.tpu.ui.port", 0)
        _df(psession).filter(F.col("v") > 0.5).collect()
        assert monitor.server() is not None
    finally:
        sock.close()


# ---------------------------------------------------------------------------
# SIGUSR1 diagnostics
# ---------------------------------------------------------------------------

@pytest.fixture
def own_sigusr1(monkeypatch):
    """SIGUSR1 at its default (another package's session may hold it in
    this process), put back afterwards."""
    import signal
    old = signal.signal(signal.SIGUSR1, signal.SIG_DFL)
    monkeypatch.setattr(monitor, "_SIGNAL_INSTALLED", False)
    yield
    signal.signal(signal.SIGUSR1, old)


def _wait_for_diagnostics(timeout=5.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        got = [e for e in EVENTS.flight_events()
               if e["kind"] == "diagnostics"]
        if got:
            return got[-1]
        time.sleep(0.05)
    return None


def test_dump_diagnostics_contents(psession):
    ev = monitor.dump_diagnostics(reason="unit")
    assert ev["kind"] == "diagnostics" and ev["reason"] == "unit"
    assert any("MainThread" in k for k in ev["threads"])
    assert all(isinstance(v, list) for v in ev["threads"].values())
    assert "syncs" in ev
    assert "diagnostics" in [e["kind"] for e in EVENTS.flight_events()]


def test_sigusr1_dumps_off_thread_even_with_the_journal_locked(
        psession, own_sigusr1):
    import signal
    assert monitor.install_signal_diagnostics()
    os.kill(os.getpid(), signal.SIGUSR1)
    ev = _wait_for_diagnostics()
    assert ev is not None and ev["reason"] == "SIGUSR1"
    EVENTS.reset_for_tests()
    EVENTS._lock.acquire()
    try:
        os.kill(os.getpid(), signal.SIGUSR1)
        time.sleep(0.3)  # the dump thread waits for the lock
        assert "diagnostics" not in [e["kind"] for e in list(EVENTS._ring)]
    finally:
        EVENTS._lock.release()
    assert _wait_for_diagnostics() is not None


def test_never_replaces_an_application_handler(own_sigusr1):
    import signal
    app_handler = lambda s, f: None  # noqa: E731
    signal.signal(signal.SIGUSR1, app_handler)
    assert monitor.install_signal_diagnostics() is False
    assert signal.getsignal(signal.SIGUSR1) is app_handler


# ---------------------------------------------------------------------------
# C.7: a port session hands SIGUSR1 back
# ---------------------------------------------------------------------------

def _jax_install_returns_true() -> None:
    """The JAX package's install takes SIGUSR1 (it never replaces a
    foreign handler); its handler and flag are put back afterwards."""
    import signal

    from spark_rapids_tpu.obs import monitor as ref_monitor
    before = signal.getsignal(signal.SIGUSR1)
    flag = ref_monitor._SIGNAL_INSTALLED
    ref_monitor._SIGNAL_INSTALLED = False
    try:
        assert ref_monitor.install_signal_diagnostics() is True
        assert signal.getsignal(signal.SIGUSR1) is not before
    finally:
        signal.signal(signal.SIGUSR1, before)
        ref_monitor._SIGNAL_INSTALLED = flag


def _port_session_holding_sigusr1():
    import signal
    s = (TpuSparkSession.builder().device("cpu")
         .config("spark.rapids.tpu.ui.signalDiagnostics", True)
         .get_or_create())
    _df(s).filter(F.col("v") > 0.5).collect()
    assert monitor._SIGNAL_INSTALLED
    assert getattr(signal.getsignal(signal.SIGUSR1), "__module__", "") \
        == monitor.__name__
    return s


def test_stop_hands_sigusr1_back(own_sigusr1):
    import signal
    s = _port_session_holding_sigusr1()
    s.stop()
    assert not monitor._SIGNAL_INSTALLED
    assert signal.getsignal(signal.SIGUSR1) is signal.SIG_DFL
    _jax_install_returns_true()


def test_fixture_teardown_hands_sigusr1_back(own_sigusr1):
    """The module-scoped fixture every port test module imports
    (``testing/signals.release_sigusr1``) hands the signal back at the
    module's end for sessions that are never stopped."""
    import signal

    from spark_rapids_tpu_torch.testing import signals
    _port_session_holding_sigusr1()
    fixture = getattr(signals.release_sigusr1, "__pytest_wrapped__", None)
    fn = fixture.obj if fixture is not None else \
        signals.release_sigusr1.__wrapped__
    teardown = fn()
    next(teardown)
    with pytest.raises(StopIteration):
        next(teardown)
    assert not monitor._SIGNAL_INSTALLED
    assert signal.getsignal(signal.SIGUSR1) is signal.SIG_DFL
    _jax_install_returns_true()


def test_jax_monitor_tests_install_after_a_port_module(tmp_path):
    """In a fresh process, as a pytest-xdist worker under ``--dist
    loadfile`` runs files one after another: a port test module makes a session and never stops it; the
    next module, as the JAX package's SIGUSR1 tests do, installs the JAX
    package's handler."""
    import subprocess
    import sys
    (tmp_path / "test_a_port.py").write_text(
        "from spark_rapids_tpu_torch.session import TpuSparkSession\n"
        "from spark_rapids_tpu_torch.testing.signals import "
        "release_sigusr1  # noqa: F401\n"
        "def test_port_session():\n"
        "    TpuSparkSession.builder().device('cpu').get_or_create()\n"
        "    from spark_rapids_tpu_torch.obs import monitor\n"
        "    assert monitor._SIGNAL_INSTALLED\n")
    (tmp_path / "test_b_jax.py").write_text(
        "def test_jax_install():\n"
        "    from spark_rapids_tpu.obs import monitor\n"
        "    assert monitor.install_signal_diagnostics() is True\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-p", "no:randomly", "-p", "no:xdist", "--rootdir",
         str(tmp_path), str(tmp_path / "test_a_port.py"),
         str(tmp_path / "test_b_jax.py")],
        capture_output=True, text=True, timeout=300, cwd=str(tmp_path),
        env=env)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert "2 passed" in out.stdout

"""The port's span tracer, metrics registry and trace summary tool
(``spark_rapids_tpu_torch/obs/trace.py``, ``obs/metrics.py``,
``tools/trace_summary.py``) against the JAX package's.

The tracer's unit cases are the JAX package's (``tests/test_tracing.py``
``TestTracer``) run against the port's module: nesting, a disabled tracer
costs one shared null context, an error span, a well-formed Chrome export
and the event cap; plus spans from concurrent threads (the scan's
planning pool) and the NVTX passthrough, which raises without a card.
Exact parity on the same inputs from a numpy seed: ``Histogram``
percentiles (the reservoir's decimation included), ``registry_delta`` of
the same observations, and the two ``trace_summary`` tools' output on the
same trace, profile and event files.
"""

import json
import threading

import numpy as np
import pandas as pd
import pytest

from spark_rapids_tpu.obs import metrics as ref_metrics
from spark_rapids_tpu_torch.obs import metrics as port_metrics
from spark_rapids_tpu_torch.obs.trace import TRACER, Tracer
from spark_rapids_tpu_torch.session import TpuSparkSession
from spark_rapids_tpu_torch.sql import functions as F


@pytest.fixture(autouse=True)
def _tracer_off_after():
    yield
    TRACER.configure(False)
    TRACER.clear()


class TestTracer:
    def test_span_nesting(self):
        tr = Tracer()
        tr.configure(True)
        with tr.span("outer", kind="test"):
            with tr.span("inner") as sp:
                sp.set(rows=5)
            tr.instant("marker", n=1)
        events = tr.events()
        assert [e["name"] for e in events] == ["inner", "marker", "outer"]
        inner, marker, outer = events
        assert inner["args"]["depth"] == 1
        assert inner["args"]["parent"] == "outer"
        assert inner["args"]["rows"] == 5
        assert marker["ph"] == "i" and marker["args"]["parent"] == "outer"
        assert outer["args"]["depth"] == 0 and outer["ph"] == "X"
        assert outer["ts"] <= inner["ts"]
        assert outer["ts"] + outer["dur"] >= inner["ts"] + inner["dur"]

    def test_disabled_is_free(self):
        tr = Tracer()
        assert not tr.enabled
        cm1 = tr.span("a", x=1)
        cm2 = tr.span("b")
        assert cm1 is cm2  # one shared null context, nothing allocated
        with cm1 as sp:
            assert sp is None
        tr.instant("nothing")
        assert tr.events() == []

    def test_error_span_recorded(self):
        tr = Tracer()
        tr.configure(True)
        with pytest.raises(ValueError):
            with tr.span("boom"):
                raise ValueError("x")
        (ev,) = tr.events()
        assert ev["args"]["error"] == "ValueError"
        assert tr._stack() == []  # the stack unwound

    def test_chrome_export_wellformed(self, tmp_path):
        tr = Tracer()
        tr.configure(True)
        with tr.span("parent"):
            with tr.span("child", bytes=10):
                pass
        path = str(tmp_path / "t.trace.json")
        doc = tr.export_chrome(path)
        with open(path) as f:
            loaded = json.load(f)
        assert loaded == json.loads(json.dumps(doc))
        assert loaded["displayTimeUnit"] == "ms"
        for ev in loaded["traceEvents"]:
            assert ev["ph"] in ("X", "i")
            assert isinstance(ev["ts"], (int, float))
            assert isinstance(ev["pid"], int)
            assert isinstance(ev["tid"], int)
            if ev["ph"] == "X":
                assert ev["dur"] >= 0

    def test_event_cap(self):
        tr = Tracer()
        tr.configure(True)
        tr.max_events = 10
        for i in range(20):
            tr.instant("e", i=i)
        assert len(tr.events()) == 10
        assert tr.dropped == 10
        assert tr.export_chrome()["otherData"]["droppedEvents"] == 10

    def test_threads_nest_on_their_own_stacks(self):
        tr = Tracer()
        tr.configure(True)
        barrier = threading.Barrier(4)

        def work(t):
            barrier.wait()
            for i in range(50):
                with tr.span(f"outer{t}"):
                    with tr.span(f"inner{t}", i=i):
                        pass

        threads = [threading.Thread(target=work, args=(t,))
                   for t in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        events = tr.events()
        assert len(events) == 4 * 50 * 2
        for ev in events:
            t = ev["name"][-1]
            if ev["name"].startswith("inner"):
                assert ev["args"]["parent"] == f"outer{t}"
                assert ev["args"]["depth"] == 1
            else:
                assert ev["args"]["depth"] == 0
        assert len({ev["tid"] for ev in events}) == 4

    def test_nvtx_without_a_card_raises(self, monkeypatch):
        import torch
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        tr = Tracer()
        with pytest.raises(RuntimeError, match="nvtx"):
            tr.configure(True, nvtx=True)
        assert not tr.enabled and not tr.nvtx
        tr.configure(False, nvtx=True)  # off: nothing to mirror
        assert not tr.nvtx

    def test_session_with_nvtx_on_the_cpu_raises(self):
        s = TpuSparkSession.builder().device("cpu").config(
            "spark.rapids.tpu.trace.enabled", True).config(
            "spark.rapids.tpu.trace.nvtx", True).get_or_create()
        df = s.create_dataframe(pd.DataFrame({"a": [1, 2, 3]}))
        with pytest.raises(RuntimeError, match="nvtx"):
            df.collect()


def _observations(seed, n):
    rng = np.random.default_rng(seed)
    return rng.lognormal(0.0, 1.5, n).tolist()


@pytest.mark.parametrize("n", [1, 7, 1000, 20000])
def test_histogram_percentiles_as_the_jax_package(n):
    obs = _observations(n, n)
    ref = ref_metrics.MetricsRegistry().histogram("span.s", op="x")
    port = port_metrics.MetricsRegistry().histogram("span.s", op="x")
    for v in obs:
        ref.observe(v)
        port.observe(v)
    for p in (0, 1, 25, 50, 90, 95, 99, 99.9, 100):
        assert port.percentile(p) == ref.percentile(p)
    assert port.count == ref.count == n
    assert port.snapshot() == ref.snapshot()


def test_empty_histogram_as_the_jax_package():
    ref = ref_metrics.MetricsRegistry().histogram("h")
    port = port_metrics.MetricsRegistry().histogram("h")
    assert port.percentile(50) == ref.percentile(50) == 0.0
    assert port.snapshot() == ref.snapshot()


def _drive(reg, rng_seed):
    """The same observations into a registry of either package: counters,
    a timer, a histogram and a gauge, some labelled."""
    rng = np.random.default_rng(rng_seed)
    for _ in range(40):
        site = ["scan.upload", "batch.fetch", "join.expandTotals"][
            int(rng.integers(0, 3))]
        reg.counter("host_syncs", site=site).add(1)
        reg.counter("host_sync.bytes", site=site).add(
            int(rng.integers(0, 1 << 20)))
        reg.timer("host_sync", site=site).record(float(rng.random()))
        reg.histogram("lat").observe(float(rng.random()))
        reg.gauge("depth").set(int(rng.integers(0, 5)))
    reg.counter("plain").add(3)


def test_registry_delta_as_the_jax_package():
    ref, port = ref_metrics.MetricsRegistry(), port_metrics.MetricsRegistry()
    _drive(ref, 1)
    _drive(port, 1)
    rb, pb = ref.values(), port.flow_values()
    _drive(ref, 2)
    _drive(port, 2)
    got = port_metrics.registry_delta(pb, port.flow_values())
    want = ref_metrics.registry_delta(rb, ref.values())
    assert got == want
    assert "depth" not in got  # a gauge is state, not flow
    assert port.values()["depth"] == ref.value("depth")


def test_registry_snapshot_as_the_jax_package():
    ref, port = ref_metrics.MetricsRegistry(), port_metrics.MetricsRegistry()
    _drive(ref, 3)
    _drive(port, 3)

    def key(d):
        return (d["kind"], d["name"], tuple(sorted(d["labels"].items())))
    assert sorted(port.snapshot(), key=key) == sorted(ref.snapshot(),
                                                      key=key)
    port.clear()
    assert port.values() == {} and port.value("plain") == 0


# ---------------------------------------------------------------------------
# tools/trace_summary.py: the root tool and the port's copy
# ---------------------------------------------------------------------------

def _summaries(path, capsys, top=10):
    import importlib.util
    import os
    root = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "trace_summary.py")
    spec = importlib.util.spec_from_file_location("root_trace_summary", root)
    ref_tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref_tool)
    from spark_rapids_tpu_torch.tools import trace_summary as port_tool
    outs = []
    for tool in (ref_tool, port_tool):
        assert tool.main([str(path), "-n", str(top)]) == 0
        outs.append(capsys.readouterr().out)
    return outs


def _session(tmp_path, **conf):
    b = TpuSparkSession.builder().device("cpu").config(
        "spark.rapids.sql.test.enabled", True)
    for k, v in conf.items():
        b.config(k, v)
    return b.get_or_create()


def _frame(seed=0, n=3000):
    rng = np.random.default_rng(seed)
    return pd.DataFrame({"g": rng.integers(0, 7, n).astype(np.int64),
                         "v": rng.random(n)})


def _query(s, seed=0):
    return (s.create_dataframe(_frame(seed), 2)
            .filter(F.col("v") > 0.2).group_by("g")
            .agg(F.sum("v").alias("sv")))


def test_trace_summary_same_output_on_a_trace(tmp_path, capsys):
    path = tmp_path / "q.trace.json"
    s = _session(tmp_path, **{"spark.rapids.tpu.trace.path": str(path)})
    _query(s).collect()
    ref_out, port_out = _summaries(path, capsys)
    assert port_out == ref_out
    assert "TpuScanExec" in port_out and "idle gaps" in port_out


def test_trace_summary_same_output_on_a_synthetic_trace(tmp_path, capsys):
    """Nested spans on two threads, sync gaps with bytes, instants and a
    dropped count, from a seed."""
    rng = np.random.default_rng(11)
    events = []
    for tid in (1, 2):
        ts = 0.0
        for i in range(30):
            dur = float(rng.integers(10, 1000))
            events.append({"name": f"op{i % 4}", "ph": "X", "pid": 1,
                           "tid": tid, "ts": ts, "dur": dur, "args": {}})
            child = float(rng.integers(1, int(dur)))
            events.append({"name": "sync.batch.fetch" if i % 2 else
                           "scan.upload", "ph": "X", "pid": 1, "tid": tid,
                           "ts": ts, "dur": child,
                           "args": {"bytes": int(rng.integers(0, 4096))}})
            if i % 5 == 0:
                events.append({"name": "scan.stall", "ph": "i", "pid": 1,
                               "tid": tid, "ts": ts, "s": "t", "args": {}})
            ts += dur + 1
    path = tmp_path / "synthetic.json"
    path.write_text(json.dumps({"traceEvents": events,
                                "otherData": {"droppedEvents": 3}}))
    ref_out, port_out = _summaries(path, capsys, top=6)
    assert port_out == ref_out


def test_trace_summary_same_output_on_a_profile(tmp_path, capsys):
    s = _session(tmp_path)
    _query(s, 1).collect()
    path = tmp_path / "q.profile.json"
    s.last_profile.save(str(path))
    ref_out, port_out = _summaries(path, capsys)
    assert port_out == ref_out
    assert "occupancy" in port_out


def test_trace_summary_same_output_on_an_event_log(tmp_path, capsys):
    import gzip
    from spark_rapids_tpu_torch.obs.events import EVENTS
    path = tmp_path / "e.jsonl"
    s = _session(tmp_path, **{"spark.rapids.tpu.eventLog.path": str(path),
                              "spark.rapids.tpu.eventLog.maxFileBytes": 2000,
                              "spark.rapids.tpu.eventLog.compress": True})
    try:
        for seed in range(3):
            _query(s, seed).collect()
        with pytest.raises(Exception):
            s.create_dataframe(_frame()).select(F.col("nope")).collect()
    finally:
        EVENTS.reset_for_tests()
    assert (tmp_path / "e.jsonl.1.gz").exists()
    with gzip.open(tmp_path / "e.jsonl.1.gz", "rt") as f:
        assert f.readline().startswith("{")
    ref_out, port_out = _summaries(path, capsys)
    assert port_out == ref_out
    assert "queryEnd" in port_out

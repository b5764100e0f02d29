"""The port's host-sync ledger (``spark_rapids_tpu_torch/obs/
syncledger.py``) against the JAX package's.

The scope's and the ledger's unit cases are the JAX package's
(``tests/test_syncledger.py`` ``TestSyncScope``, ``TestLedger``) run
against the port's module: a scope records site, seconds, bytes and
detail; the outermost scope records and inner ones fold their bytes into
it; a scope whose body raised records nothing; a disabled ledger records
nothing; an entry carries the operator executing on the thread; the
deque is bounded and resizable, with a watermark. ``SYNCS`` still counts
every scope, the inner ones too, as the chip smoke and the tests gate on.
``rollup`` and ``occupancy_pct`` equal the JAX package's on the same
entries from a numpy seed.

Through the session on the CPU: the counted syncs by site of a filter +
group-by, a join + group-by and a Parquet scan are the same with
observability off, at the default (metrics on) and with tracing, the
journal and progress on; a traced query's ``sync.<site>`` spans are its
ledger entries, which match ``SYNCS`` by site; the transfer guard has no
effect on a CPU device and its conf is validated.
"""

import json

import numpy as np
import pandas as pd
import pytest

from spark_rapids_tpu.obs import syncledger as ref_sl
from spark_rapids_tpu_torch.obs import compileledger as cl
from spark_rapids_tpu_torch.obs import syncledger as sl
from spark_rapids_tpu_torch.obs.syncledger import (
    SYNC_LEDGER, SYNCS, SyncCounter, guard_context, occupancy_pct, rollup,
    sync_scope,
)
from spark_rapids_tpu_torch.session import TpuSparkSession
from spark_rapids_tpu_torch.sql import functions as F


@pytest.fixture(autouse=True)
def _reset_after():
    yield
    SYNC_LEDGER.configure(True)
    from spark_rapids_tpu_torch.obs.events import EVENTS
    from spark_rapids_tpu_torch.obs.progress import PROGRESS
    from spark_rapids_tpu_torch.obs.trace import TRACER
    EVENTS.reset_for_tests()
    PROGRESS.reset_for_tests()
    TRACER.configure(False)
    TRACER.clear()


class TestSyncScope:
    def test_scope_records_site_seconds_bytes_detail(self):
        seq0 = SYNC_LEDGER.seq
        with sync_scope("test.site", detail="unit", nbytes=8):
            pass
        (e,) = SYNC_LEDGER.entries(since_seq=seq0)
        assert e["site"] == "test.site" and e["bytes"] == 8
        assert e["detail"] == "unit" and e["seconds"] >= 0.0
        assert e["seq"] > seq0 and e["op"] is None

    def test_outermost_scope_wins_inner_folds_bytes(self):
        seq0 = SYNC_LEDGER.seq
        counter = SyncCounter()
        with sync_scope("outer.site", nbytes=4, counter=counter) as sc:
            with sync_scope("inner.site", nbytes=16, counter=counter):
                pass
            sc.add_bytes(2)
        (e,) = SYNC_LEDGER.entries(since_seq=seq0)
        assert e["site"] == "outer.site"
        assert e["bytes"] == 4 + 16 + 2
        # the counter counts every scope, the inner one too, with the
        # bytes declared on entry
        assert counter.syncs == {"outer.site": 1, "inner.site": 1}
        assert counter.bytes == {"outer.site": 4, "inner.site": 16}

    def test_exception_records_nothing(self):
        seq0 = SYNC_LEDGER.seq
        with pytest.raises(RuntimeError):
            with sync_scope("test.broken"):
                raise RuntimeError("fetch failed")
        assert SYNC_LEDGER.entries(since_seq=seq0) == []
        with sync_scope("test.after"):
            pass
        assert [e["site"] for e in SYNC_LEDGER.entries(since_seq=seq0)] \
            == ["test.after"]

    def test_disabled_ledger_records_nothing(self):
        seq0 = SYNC_LEDGER.seq
        before = SYNCS.syncs.get("test.disabled", 0)
        SYNC_LEDGER.configure(enabled=False)
        with sync_scope("test.disabled"):
            pass
        assert SYNC_LEDGER.entries(since_seq=seq0) == []
        assert SYNCS.syncs["test.disabled"] == before + 1

    def test_entry_carries_current_op(self):
        seq0 = SYNC_LEDGER.seq
        tok = cl.push_op("TpuSyncTestExec", None, None)
        try:
            with sync_scope("test.op"):
                pass
        finally:
            cl.pop_op(tok)
        assert SYNC_LEDGER.entries(since_seq=seq0)[0]["op"] == \
            "TpuSyncTestExec"
        assert cl.current_op() is None

    def test_traced_scope_is_a_sync_span(self):
        from spark_rapids_tpu_torch.obs.trace import TRACER
        TRACER.configure(True)
        TRACER.clear()
        with sync_scope("outer.site", nbytes=8):
            with sync_scope("inner.site", nbytes=8):
                pass
        (ev,) = TRACER.events()
        assert ev["name"] == "sync.outer.site"
        assert ev["args"]["site"] == "outer.site"
        assert ev["args"]["bytes"] == 16


class TestLedger:
    def test_bounded_deque_and_tail(self):
        led = sl.SyncLedger(max_entries=4)
        for i in range(10):
            led.record(f"site.{i}", 0.001)
        assert led.total_recorded == 10
        assert [e["site"] for e in led.entries()] == [
            "site.6", "site.7", "site.8", "site.9"]
        assert [e["site"] for e in led.tail(2)] == ["site.8", "site.9"]

    def test_configure_shrinks_and_grows(self):
        led = sl.SyncLedger(max_entries=8)
        for i in range(8):
            led.record(f"s{i}", 0.0)
        led.configure(True, max_entries=2)
        assert len(led.entries()) == 2
        led.configure(True, max_entries=16)
        led.record("s8", 0.0)
        assert len(led.entries()) == 3

    def test_totals_and_watermark(self):
        led = sl.SyncLedger()
        led.record("a", 0.5, nbytes=100)
        seq = led.seq
        led.record("b", 0.25, nbytes=50)
        assert led.total_recorded == 2
        assert led.total_seconds == pytest.approx(0.75)
        assert led.total_bytes == 150
        assert [e["site"] for e in led.entries(since_seq=seq)] == ["b"]
        led.reset_for_tests()
        assert led.entries() == [] and led.seq == 0

    def test_query_stats(self):
        from spark_rapids_tpu_torch.obs.events import EVENTS
        qid = EVENTS.query_start()
        SYNC_LEDGER.record("x.site", 0.5, nbytes=3)
        EVENTS.query_end("success")
        st = SYNC_LEDGER.query_stats(qid)
        assert st["syncs"] == 1 and st["bytes"] == 3
        assert st["sites"][0]["site"] == "x.site"


def _entries(seed, n=60):
    rng = np.random.default_rng(seed)
    sites = ["scan.upload", "batch.fetch", "join.expandTotals",
             "batch.rowCount", None]
    ops = ["TpuScanExec(Parquet[a])", "Collect",
           "TpuShuffledHashJoinExec(inner)", None]
    out = []
    for _ in range(n):
        e = {"seconds": float(rng.random() * 0.01),
             "bytes": int(rng.integers(0, 1 << 16)),
             "op": ops[int(rng.integers(0, len(ops)))]}
        site = sites[int(rng.integers(0, len(sites)))]
        if site is not None:
            e["site"] = site
        out.append(e)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rollup_as_the_jax_package(seed):
    entries = _entries(seed)
    assert rollup(entries) == ref_sl.rollup(entries)
    assert rollup([]) == ref_sl.rollup([])


@pytest.mark.parametrize("sync_s,wall_s", [
    (0.5, 2.0), (0.0, 1.0), (5.0, 2.0), (0.5, None), (0.5, 0.0),
    (0.123456, 0.987654), (-1.0, 3.0)])
def test_occupancy_pct_as_the_jax_package(sync_s, wall_s):
    assert occupancy_pct(sync_s, wall_s) == ref_sl.occupancy_pct(sync_s,
                                                                 wall_s)


def test_occupancy_pct_on_seeded_walls():
    rng = np.random.default_rng(4)
    for _ in range(200):
        s, w = float(rng.random() * 3), float(rng.random() * 3)
        assert occupancy_pct(s, w) == ref_sl.occupancy_pct(s, w)


class TestTransferGuard:
    def test_cpu_device_is_no_op(self):
        mode = None
        import torch
        if torch.cuda.is_available():
            mode = torch.cuda.get_sync_debug_mode()
        for m in ("off", "log", "disallow", None):
            with guard_context(m, "cpu"):
                pass
        if mode is not None:
            assert torch.cuda.get_sync_debug_mode() == mode

    def test_session_query_under_disallow_on_the_cpu(self):
        s = _session(**{"spark.rapids.tpu.debug.transferGuard": "disallow"})
        got = _q_filter(s).collect()
        assert len(got) == 5

    def test_session_rejects_an_unknown_guard(self):
        s = _session(**{"spark.rapids.tpu.debug.transferGuard": "sideways"})
        with pytest.raises(ValueError, match="transferGuard"):
            _q_filter(s).collect()


# ---------------------------------------------------------------------------
# Through the session
# ---------------------------------------------------------------------------

def _session(**conf):
    b = TpuSparkSession.builder().device("cpu").config(
        "spark.rapids.sql.test.enabled", True)
    for k, v in conf.items():
        b.config(k, v)
    return b.get_or_create()


def _frames(seed=3, n=5000):
    rng = np.random.default_rng(seed)
    left = pd.DataFrame({"k": rng.integers(0, 60, n).astype(np.int64),
                         "v": rng.random(n),
                         "g": rng.integers(0, 5, n).astype(np.int64)})
    right = pd.DataFrame({"k": np.arange(60, dtype=np.int64),
                          "w": rng.random(60)})
    return left, right


def _q_filter(s):
    left, _ = _frames()
    return (s.create_dataframe(left, 2).filter(F.col("v") > 0.3)
            .group_by("g").agg(F.sum("v").alias("sv")))


def _q_join(s):
    left, right = _frames()
    return (s.create_dataframe(left, 2).join(s.create_dataframe(right),
                                             on="k")
            .group_by("g").agg(F.sum("w").alias("sw"), F.count("*")
                               .alias("n")))


def _parquet(tmp_path):
    left, _ = _frames()
    path = str(tmp_path / "left.parquet")
    left.to_parquet(path, row_group_size=1500)
    return path


MODES = {
    "off": {"spark.rapids.sql.metrics.enabled": False,
            "spark.rapids.sql.scan.pageCache.enabled": False},
    "default": {"spark.rapids.sql.scan.pageCache.enabled": False},
    "all_on": {"spark.rapids.tpu.trace.enabled": True,
               "spark.rapids.tpu.eventLog.enabled": True,
               "spark.rapids.sql.scan.pageCache.enabled": False},
}


def _syncs_by_site(fn):
    before = dict(SYNCS.syncs)
    out = fn()
    return out, {k: v - before.get(k, 0) for k, v in SYNCS.syncs.items()
                 if v - before.get(k, 0)}


@pytest.mark.parametrize("qname", ["filter", "join", "parquet"])
def test_syncs_by_site_unchanged_by_observability(qname, tmp_path,
                                                  monkeypatch):
    from spark_rapids_tpu_torch.obs.progress import PROGRESS
    monkeypatch.chdir(tmp_path)  # eventLog.enabled without a path
    path = _parquet(tmp_path) if qname == "parquet" else None
    got = {}
    for mode, conf in MODES.items():
        PROGRESS.configure(mode == "all_on")
        s = _session(**conf)
        if qname == "filter":
            df = _q_filter(s)
        elif qname == "join":
            df = _q_join(s)
        else:
            df = (s.read.parquet(path).filter(F.col("v") > 0.3)
                  .group_by("g").agg(F.sum("v").alias("sv")))
        out, syncs = _syncs_by_site(df.collect)
        got[mode] = (out.sort_values(out.columns[0]).reset_index(drop=True),
                     syncs)
        assert (s.last_profile is None) == (mode == "off")
    assert got["off"][1] == got["default"][1] == got["all_on"][1]
    assert got["off"][1]
    for mode in ("default", "all_on"):
        pd.testing.assert_frame_equal(got[mode][0], got["off"][0])
    assert PROGRESS.queries()[0]["status"] == "success"
    assert (tmp_path / "tpu-eventlog.jsonl").exists()


def test_sync_spans_are_the_ledger_entries(tmp_path):
    path = str(tmp_path / "q.trace.json")
    s = _session(**{"spark.rapids.tpu.trace.path": path,
                    "spark.rapids.tpu.eventLog.enabled": True,
                    "spark.rapids.tpu.eventLog.path":
                        str(tmp_path / "e.jsonl")})
    from spark_rapids_tpu_torch.obs.events import EVENTS
    seq0 = SYNC_LEDGER.seq
    _, syncs = _syncs_by_site(_q_join(s).collect)
    ents = SYNC_LEDGER.entries(since_seq=seq0)
    qids = {e["query"] for e in ents}
    assert len(qids) == 1 and None not in qids
    spans = [ev for ev in json.load(open(path))["traceEvents"]
             if ev["name"].startswith("sync.")]
    by_span, by_entry = {}, {}
    for ev in spans:
        by_span[ev["args"]["site"]] = by_span.get(ev["args"]["site"], 0) + 1
    for e in ents:
        by_entry[e["site"]] = by_entry.get(e["site"], 0) + 1
    assert by_span == by_entry == syncs
    assert "join.expandTotals" in syncs
    prof = s.profile_json()["summary"]["syncs"]
    assert prof["count"] == len(ents)
    assert 0.0 <= prof["occupancyPct"] <= 100.0
    EVENTS.reset_for_tests()

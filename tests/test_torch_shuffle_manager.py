"""The port's accelerated shuffle manager (``shuffle/``), its transports,
``obs/shuffleobs.py`` and the sync-scope repair, on the CPU.

The JAX package's unit cases, ported against the port's modules: its
``tests/test_shuffle.py`` (the wire round trip, bounce buffers, local and
remote fetches through the in-process transport, a spilled buffer served,
received batches spillable, cleanup, the in-flight byte throttle),
``test_shuffle_manager_integration.py`` (the manager under the session's
exchanges against the CPU operators, blocks registered, cleaned and
spilled), ``test_fetch_retry.py`` (retries then success, retries
exhausted), the mesh-free cases of ``test_transport_select.py`` and
``test_socket_shuffle.py``'s request/response, error response and
dropped-connection retry. Across packages and processes: the JAX
package's child process of ``tests/test_socket_xproc.py`` serves a frame
that the port's ``SocketTransport`` client fetches over TCP and
deserializes equal, then a child of the port serves one to the JAX
package's client. The repair of ``obs/syncledger.sync_scope``: two threads
open and close scopes in the interleavings that lost the sync debug mode,
against a stand-in for ``torch.cuda``'s getter and setter. The skew
record equals the JAX package's and is journaled. Every socket wait has a
timeout.
"""

import json
import os
import subprocess
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pandas as pd
import pytest
import torch

from spark_rapids_tpu_torch.columnar.batch import DeviceBatch
from spark_rapids_tpu_torch.config.conf import TpuConf
from spark_rapids_tpu_torch.memory.spill import StorageTier
from spark_rapids_tpu_torch.session import TpuSparkSession
from spark_rapids_tpu_torch.shuffle import manager as shuffle_manager
from spark_rapids_tpu_torch.shuffle import wire
from spark_rapids_tpu_torch.shuffle.client import (
    ShuffleClient, ShuffleFetchFailedError,
)
from spark_rapids_tpu_torch.shuffle.manager import (
    CachingShuffleReader, CachingShuffleWriter, ShuffleEnv,
    ShuffleTransportKind, select_transport_kind,
)
from spark_rapids_tpu_torch.shuffle.socket_transport import SocketTransport
from spark_rapids_tpu_torch.shuffle.transport import (
    BounceBufferManager, InProcessTransport, RequestType, TransactionStatus,
)
from spark_rapids_tpu_torch.sql import functions as F
from tests.querytest import assert_frames_equal
from spark_rapids_tpu_torch.testing.signals import release_sigusr1  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT = 10  # seconds, every socket wait


def _batch(n=50, seed=0, strings=True):
    rng = np.random.default_rng(seed)
    d = {"a": rng.integers(-100, 100, n),
         "b": rng.uniform(-5, 5, n).astype(np.float32),
         "c": pd.Series(rng.integers(0, 10, n)).astype("Int64")
              .mask(pd.Series(rng.random(n) < 0.2))}
    if strings:
        d["s"] = pd.Series([None if i % 7 == 0 else f"row_{i}ü"
                            for i in range(n)])
    return DeviceBatch.from_pandas(pd.DataFrame(d), device="cpu")


# --- tests/test_shuffle.py ------------------------------------------------

class TestWireFormat:
    def test_roundtrip(self):
        b = _batch()
        out = wire.deserialize_batch(wire.serialize_batch(b), "cpu")
        pd.testing.assert_frame_equal(out.to_pandas(), b.to_pandas())

    def test_roundtrip_empty(self):
        b = _batch(0)
        out = wire.deserialize_batch(wire.serialize_batch(b), "cpu")
        assert out.num_rows_host() == 0
        assert out.schema == b.schema

    def test_header_validation(self):
        with pytest.raises(AssertionError):
            wire.deserialize_table(b"\x00" * 64)


class TestBounceBuffers:
    def test_acquire_free(self):
        m = BounceBufferManager(1024, 2)
        b1 = m.acquire_buffer()
        b2 = m.acquire_buffer()
        assert m.num_free == 0
        with pytest.raises(TimeoutError):
            m.acquire_buffer(timeout=0.05)
        b1.free()
        b3 = m.acquire_buffer()
        assert b3 is b1
        b2.free()
        b3.free()
        assert m.num_free == 2


@pytest.fixture
def two_execs(tmp_path):
    InProcessTransport.clear_registry()
    envs = []
    for name in ("exec-0", "exec-1"):
        (tmp_path / name).mkdir(exist_ok=True)
        envs.append(ShuffleEnv(name, InProcessTransport(name),
                               bounce_buffer_size=256,
                               bounce_buffer_count=2,
                               disk_dir=str(tmp_path / name), device="cpu"))
    yield envs
    for e in envs:
        e.close()
    InProcessTransport.clear_registry()


class TestShuffleFetch:
    def test_local_read(self, two_execs):
        env0, _ = two_execs
        b = _batch(seed=3)
        ms = CachingShuffleWriter(env0, shuffle_id=1, map_id=0).write(
            [[b], []])
        reader = CachingShuffleReader(env0)
        got = list(reader.read(1, 0, [ms]))
        assert len(got) == 1
        pd.testing.assert_frame_equal(got[0].to_pandas(), b.to_pandas())
        assert list(reader.read(1, 1, [ms])) == []

    def test_remote_fetch(self, two_execs):
        """Metadata -> chunked tagged receives (a bounce size of 256 forces
        many chunks) -> reassembly -> the received catalog."""
        env0, env1 = two_execs
        b0, b1 = _batch(seed=4), _batch(seed=5)
        ms = CachingShuffleWriter(env0, 7, 0).write([[b0, b1]])
        got = list(CachingShuffleReader(env1).read(7, 0, [ms]))
        assert len(got) == 2
        pd.testing.assert_frame_equal(got[0].to_pandas(), b0.to_pandas())
        pd.testing.assert_frame_equal(got[1].to_pandas(), b1.to_pandas())

    def test_fetch_spilled_buffer(self, two_execs):
        env0, env1 = two_execs
        b = _batch(seed=6)
        ms = CachingShuffleWriter(env0, 9, 0).write([[b]])
        env0.buffer_catalog.device_store.synchronous_spill(0)
        bids = env0.shuffle_catalog.buffer_ids(9, 0, 0)
        assert env0.buffer_catalog.buffer_tier(bids[0]) == StorageTier.HOST
        got = list(CachingShuffleReader(env1).read(9, 0, [ms]))
        pd.testing.assert_frame_equal(got[0].to_pandas(), b.to_pandas())

    def test_multi_mapper_gather(self, two_execs):
        env0, env1 = two_execs
        b0, b1 = _batch(seed=7), _batch(seed=8)
        ms0 = CachingShuffleWriter(env0, 11, 0).write([[b0]])
        ms1 = CachingShuffleWriter(env1, 11, 1).write([[b1]])
        got = list(CachingShuffleReader(env1).read(11, 0, [ms0, ms1]))
        assert len(got) == 2
        frames = sorted((g.to_pandas() for g in got),
                        key=lambda d: tuple(d["a"].head(3)))
        want = sorted((b0.to_pandas(), b1.to_pandas()),
                      key=lambda d: tuple(d["a"].head(3)))
        for g, w in zip(frames, want):
            pd.testing.assert_frame_equal(g, w)

    def test_received_batches_spillable(self, two_execs):
        env0, env1 = two_execs
        b = _batch(seed=9)
        CachingShuffleWriter(env0, 13, 0).write([[b]])
        bids = env1.client_for("exec-0").fetch_blocks([(13, 0, 0)])
        env1.buffer_catalog.device_store.synchronous_spill(0)
        got = env1.received_catalog.acquire_batch(bids[0])
        pd.testing.assert_frame_equal(got.to_pandas(), b.to_pandas())

    def test_shuffle_cleanup(self, two_execs):
        env0, _ = two_execs
        CachingShuffleWriter(env0, 17, 0).write([[_batch(seed=10)]])
        assert env0.shuffle_catalog.buffer_ids(17, 0, 0)
        env0.shuffle_catalog.remove_shuffle(17)
        assert not env0.shuffle_catalog.buffer_ids(17, 0, 0)


def test_inflight_bytes_throttle():
    c = ShuffleClient.__new__(ShuffleClient)
    c.max_bytes_in_flight = 100
    c._inflight = 0
    c._inflight_cv = threading.Condition()
    c._acquire_inflight(150)   # an oversized fetch admitted when idle
    admitted = threading.Event()

    def second():
        c._acquire_inflight(10)
        admitted.set()
    t = threading.Thread(target=second, daemon=True)
    t.start()
    time.sleep(0.1)
    assert not admitted.is_set()
    c._release_inflight(150)
    assert admitted.wait(5)
    c._release_inflight(10)
    t.join(5)
    assert c._inflight == 0


# --- tests/test_shuffle_manager_integration.py -----------------------------

MANAGER_CONF = {"spark.rapids.shuffle.transport.enabled": True,
                "spark.rapids.sql.autoBroadcastJoinThreshold": -1}


def _session(**conf):
    b = (TpuSparkSession.builder().device("cpu")
         .config("spark.rapids.sql.test.enabled", True))
    for k, v in conf.items():
        b.config(k, v)
    return b.get_or_create()


def _device_and_cpu_equal(query, conf, ignore_order=True):
    s = _session(**conf)
    try:
        got = query(s).collect()
    finally:
        s.stop()
    c = _session(**dict(conf, **{"spark.rapids.sql.enabled": False}))
    try:
        want = query(c).collect()
    finally:
        c.stop()
    assert_frames_equal(got, want, ignore_order=ignore_order, approx=True)


def _frame(rng, n=5000):
    return pd.DataFrame({
        "k": rng.integers(0, 40, n),
        "name": np.array(["grp%d" % g for g in rng.integers(0, 12, n)]),
        "v": rng.random(n) * 100.0,
    })


def test_manager_groupby(rng):
    pdf = _frame(rng)
    _device_and_cpu_equal(
        lambda s: (s.create_dataframe(pdf, 4).group_by("name")
                   .agg(F.sum("v").alias("sv"), F.count("*").alias("n"))),
        MANAGER_CONF)


def test_manager_join(rng):
    left = _frame(rng)
    right = pd.DataFrame({"k": np.arange(40),
                          "tag": ["t%d" % i for i in range(40)]})
    _device_and_cpu_equal(
        lambda s: (s.create_dataframe(left, 3)
                   .join(s.create_dataframe(right, 2), on="k", how="inner")
                   .group_by("tag").agg(F.sum("v").alias("sv"))),
        MANAGER_CONF)


def test_manager_global_sort(rng):
    pdf = _frame(rng, 2000)
    _device_and_cpu_equal(
        lambda s: s.create_dataframe(pdf, 3).order_by("v", "k"),
        MANAGER_CONF, ignore_order=False)


def test_manager_blocks_registered_and_cleaned(rng):
    pdf = _frame(rng, 3000)
    s = _session(**MANAGER_CONF)
    try:
        (s.create_dataframe(pdf, 3).group_by("name")
         .agg(F.sum("v").alias("sv")).collect())
        assert s._shuffle_id_counter > 0
        assert not s._active_shuffles
        assert not s.shuffle_env.shuffle_catalog._blocks
    finally:
        s.stop()


def test_manager_blocks_spill(rng):
    """A raw-row join shuffle under a 64 KiB budget: its blocks hit the
    spill tiers and the answer holds."""
    n = 20000
    left = pd.DataFrame({"k": np.arange(n), "v": rng.random(n)})
    right = pd.DataFrame({"k": np.arange(0, n, 2), "w": rng.random(n // 2)})
    s = _session(**MANAGER_CONF)
    try:
        s.device_manager.hbm_budget = 64 << 10
        before = s.memory_event_handler.spill_count
        out = (s.create_dataframe(left, 3)
               .join(s.create_dataframe(right, 2), on="k", how="inner")
               .group_by().agg(F.count("*").alias("n"))).collect()
        assert int(out["n"][0]) == n // 2
        assert s.memory_event_handler.spill_count > before
    finally:
        s.stop()


# --- tests/test_fetch_retry.py ----------------------------------------------

def _retry_df():
    rng = np.random.default_rng(21)
    n = 3000
    return pd.DataFrame({"k": rng.integers(0, 40, n).astype(np.int64),
                         "v": rng.uniform(0, 1, n)})


def _retry_query(s, df):
    return (s.create_dataframe(df, 3).group_by("k")
            .agg(F.sum("v").alias("s"), F.count("*").alias("c")))


def test_fetch_failure_retries_then_succeeds(monkeypatch):
    from spark_rapids_tpu_torch.obs.events import EVENTS
    from spark_rapids_tpu_torch.obs.metrics import REGISTRY
    df = _retry_df()
    real_read = shuffle_manager.CachingShuffleReader.read_group
    fails = {"n": 2}
    calls = {"n": 0}

    def flaky_read(self, shuffle_id, partition_id, peer, group):
        calls["n"] += 1
        if fails["n"] > 0:
            fails["n"] -= 1
            raise ShuffleFetchFailedError(
                f"injected fetch failure #{calls['n']}")
        return real_read(self, shuffle_id, partition_id, peer, group)
    monkeypatch.setattr(shuffle_manager.CachingShuffleReader,
                        "read_group", flaky_read)
    retries = REGISTRY.value("shuffle.fetch.retries") or 0
    seq = max((e["seq"] for e in EVENTS.flight_events()), default=0)
    s = _session(**MANAGER_CONF)
    try:
        out = _retry_query(s, df).collect().sort_values("k") \
            .reset_index(drop=True)
    finally:
        s.stop()
    assert calls["n"] >= 3
    assert (REGISTRY.value("shuffle.fetch.retries") or 0) - retries == 2
    assert [e["attempt"] for e in EVENTS.flight_events()
            if e["seq"] > seq and e["kind"] == "fetchRetry"] == [1, 2]
    exp = (df.groupby("k").agg(s=("v", "sum"), c=("v", "count"))
           .reset_index())
    assert out.c.tolist() == exp.c.tolist()
    np.testing.assert_allclose(out.s.values.astype(float), exp.s.values,
                               rtol=1e-9)


def test_fetch_failure_exhausts_retries(monkeypatch):
    def always_fail(self, *a):
        raise ShuffleFetchFailedError("always failing")
    monkeypatch.setattr(shuffle_manager.CachingShuffleReader, "read_group",
                        always_fail)
    s = _session(**dict(MANAGER_CONF, **{
        "spark.rapids.shuffle.maxFetchRetries": 1}))
    try:
        with pytest.raises(ShuffleFetchFailedError):
            _retry_query(s, _retry_df()).collect()
        # a failed query releases its shuffles too
        assert not s._active_shuffles
        assert not s.shuffle_env.shuffle_catalog._blocks
    finally:
        s.stop()


# --- tests/test_transport_select.py (the mesh-free cases) -------------------

class _FakeMesh:
    def __init__(self, n):
        self.devices = SimpleNamespace(size=n)


def _sess(mesh=None):
    return SimpleNamespace(mesh=mesh)


def test_legacy_default_matches_historical_selection():
    conf = TpuConf({})
    for kind in ("hash", "range", "roundrobin", "single"):
        assert select_transport_kind(conf, _sess(), kind, 8) \
            is ShuffleTransportKind.LOCAL
    conf = TpuConf({"spark.rapids.shuffle.transport.enabled": True})
    assert select_transport_kind(conf, _sess(), "hash", 8) \
        is ShuffleTransportKind.MANAGER
    assert select_transport_kind(conf, _sess(), "single", 1) \
        is ShuffleTransportKind.LOCAL
    assert select_transport_kind(TpuConf({}), None, "hash", 8) \
        is ShuffleTransportKind.LOCAL


def test_mode_overrides():
    mesh = _FakeMesh(8)
    local = TpuConf({"spark.rapids.tpu.shuffle.transport.mode": "local"})
    assert select_transport_kind(local, _sess(mesh), "hash", 8) \
        is ShuffleTransportKind.LOCAL
    ici = TpuConf({"spark.rapids.tpu.shuffle.transport.mode": "ici"})
    assert select_transport_kind(ici, _sess(), "hash", 8) \
        is ShuffleTransportKind.LOCAL   # no mesh: local
    mgr = TpuConf({"spark.rapids.tpu.shuffle.transport.mode": "manager"})
    assert select_transport_kind(mgr, _sess(), "hash", 8) \
        is ShuffleTransportKind.MANAGER
    assert select_transport_kind(mgr, None, "hash", 8) \
        is ShuffleTransportKind.LOCAL


def test_mode_auto_picks_the_wire_for_an_executor_pool():
    auto = TpuConf({"spark.rapids.tpu.shuffle.transport.mode": "auto"})
    auto2 = TpuConf({"spark.rapids.tpu.shuffle.transport.mode": "auto",
                     "spark.rapids.shuffle.executors": 2})
    assert select_transport_kind(auto2, _sess(), "hash", 8) \
        is ShuffleTransportKind.MANAGER
    assert select_transport_kind(auto, _sess(), "hash", 8) \
        is ShuffleTransportKind.LOCAL


def test_invalid_mode_rejected():
    with pytest.raises(ValueError):
        TpuConf({"spark.rapids.tpu.shuffle.transport.mode": "ucx"})
    with pytest.raises(ValueError):
        TpuConf({"spark.rapids.shuffle.executors": 0})


def test_shuffle_confs_are_the_jax_packages():
    from spark_rapids_tpu.config.conf import conf_entries
    from spark_rapids_tpu_torch.config.conf import _REGISTRY
    ref = conf_entries()
    for key in ("spark.rapids.sql.shuffle.localCollapse",
                "spark.rapids.shuffle.transport.enabled",
                "spark.rapids.shuffle.transport.class",
                "spark.rapids.shuffle.executors",
                "spark.rapids.shuffle.maxFetchRetries",
                "spark.rapids.shuffle.maxMetadataFetchesInFlight",
                "spark.rapids.shuffle.bounceBuffers.size",
                "spark.rapids.shuffle.bounceBuffers.count",
                "spark.rapids.tpu.shuffle.transport.mode",
                "spark.rapids.sql.dict.wire"):
        assert _REGISTRY[key].default == ref[key].default, key
        assert _REGISTRY[key].doc == ref[key].doc, key


def test_socket_transport_per_peer_counters():
    from spark_rapids_tpu_torch.obs.metrics import REGISTRY
    a = SocketTransport("mx-a")
    b = SocketTransport("mx-b")
    try:
        b.get_server().register_request_handler(
            RequestType.METADATA, lambda payload: b"ok:" + payload)
        client = a.make_client("mx-b")
        r0 = REGISTRY.value("shuffle.transport.requests", transport="socket",
                            peer="mx-b", kind="metadata") or 0
        got = {}
        done = threading.Event()

        def cb(txn, resp):
            got["resp"] = bytes(resp)
            done.set()
        client.request(RequestType.METADATA, b"hello", cb).wait(WAIT)
        assert done.wait(WAIT) and got["resp"] == b"ok:hello"
        assert REGISTRY.value("shuffle.transport.requests",
                              transport="socket", peer="mx-b",
                              kind="metadata") == r0 + 1
        assert REGISTRY.value("shuffle.transport.bytes",
                              transport="socket", peer="mx-b",
                              direction="received") > 0
        h = REGISTRY.histogram("shuffle.transport.rttSeconds",
                               transport="socket", peer="mx-b")
        assert h.count >= 1 and h.percentile(50) >= 0.0
        recv_done = threading.Event()
        target = bytearray(16)
        client.receive(7, target, lambda txn: recv_done.set())
        b.get_server().send("mx-a", 7, b"0123456789abcdef",
                            lambda txn: None)
        assert recv_done.wait(WAIT)
        assert bytes(target) == b"0123456789abcdef"
        assert REGISTRY.value("shuffle.transport.bytes",
                              transport="socket", peer="mx-a",
                              direction="sent") >= 16
        assert REGISTRY.value("shuffle.transport.frames",
                              transport="socket", peer="mx-b",
                              direction="received") >= 1
    finally:
        a.shutdown()
        b.shutdown()


# --- tests/test_socket_shuffle.py -----------------------------------------

def test_socket_request_response_and_tagged():
    a = SocketTransport("sock-exec-a")
    b = SocketTransport("sock-exec-b")
    try:
        b.get_server().register_request_handler(
            RequestType.METADATA, lambda p: b"meta:" + p)
        client = a.make_client("sock-exec-b")
        got = {}
        ev = threading.Event()
        client.request(RequestType.METADATA, b"abc",
                       lambda t, r: (got.update(t=t, r=bytes(r)), ev.set()))
        assert ev.wait(WAIT)
        assert got["t"].status == TransactionStatus.SUCCESS
        assert got["r"] == b"meta:abc"
        # receive posted first, then the server's send
        target = bytearray(5)
        rev, sev = threading.Event(), threading.Event()
        client.receive(77, target, lambda t: rev.set())
        b.get_server().send("sock-exec-a", 77, b"hello", lambda t: sev.set())
        assert rev.wait(WAIT) and sev.wait(WAIT)
        assert bytes(target) == b"hello"
        # a send before the receive is posted: parked
        sev2 = threading.Event()
        b.get_server().send("sock-exec-a", 78, b"early",
                            lambda t: sev2.set())
        assert sev2.wait(WAIT)
        time.sleep(0.1)
        target2 = bytearray(5)
        rev2 = threading.Event()
        client.receive(78, target2, lambda t: rev2.set())
        assert rev2.wait(WAIT)
        assert bytes(target2) == b"early"
    finally:
        a.shutdown()
        b.shutdown()
    # shutdown joined every thread the two transports started
    assert not [t for t in threading.enumerate()
                if t.name.startswith("shuffle-") and "sock-exec" in t.name]


def test_socket_error_response_propagates():
    a = SocketTransport("sock-err-a")
    b = SocketTransport("sock-err-b")
    try:
        def boom(payload):
            raise RuntimeError("kaput")
        b.get_server().register_request_handler(RequestType.TRANSFER, boom)
        client = a.make_client("sock-err-b")
        got = {}
        ev = threading.Event()
        client.request(RequestType.TRANSFER, b"x",
                       lambda t, r: (got.update(t=t), ev.set()))
        assert ev.wait(WAIT)
        assert got["t"].status == TransactionStatus.ERROR
        assert "kaput" in got["t"].error_message
    finally:
        a.shutdown()
        b.shutdown()


SOCKET_CONF = {"spark.rapids.shuffle.transport.enabled": True,
               "spark.rapids.shuffle.transport.class": "socket",
               "spark.rapids.shuffle.executors": 2,
               "spark.rapids.sql.autoBroadcastJoinThreshold": -1,
               "spark.rapids.shuffle.bounceBuffers.size": 16384}


def test_socket_drop_mid_transfer_retries(rng):
    """A connection dropped mid-transfer fails the fetch at once (no 30 s
    chunk timeouts); the per-peer retry fetches again over a fresh
    connection, and the answer equals the CPU operators'."""
    left = _frame(rng, 4000)
    right = pd.DataFrame({"k": np.arange(50), "w": rng.random(50)})

    def q(s):
        return (s.create_dataframe(left, 4)
                .join(s.create_dataframe(right, 2), on="k", how="inner")
                .group_by("k").agg(F.sum("v").alias("sv")))
    s = _session(**SOCKET_CONF)
    try:
        envs = s.shuffle_envs
        envs[1].transport.fault_drop_tagged_after(1)
        t0 = time.monotonic()
        got = q(s).collect()
        elapsed = time.monotonic() - t0
        stats = dict(envs[1].transport.stats)
    finally:
        s.stop()
    c = _session(**dict(SOCKET_CONF, **{"spark.rapids.sql.enabled": False}))
    try:
        want = q(c).collect()
    finally:
        c.stop()
    assert_frames_equal(got, want, ignore_order=True, approx=True)
    assert stats["faults_fired"] == 1, stats
    assert stats["tagged_frames"] > 0, stats
    assert elapsed < 25, elapsed


# --- across packages and processes ------------------------------------------

_PORT_CHILD = r"""
import json, sys, threading, time
sys.path.insert(0, %(repo)r)
import numpy as np, pandas as pd
from spark_rapids_tpu_torch.columnar.batch import DeviceBatch
from spark_rapids_tpu_torch.shuffle.socket_transport import SocketTransport
from spark_rapids_tpu_torch.shuffle.transport import RequestType
from spark_rapids_tpu_torch.shuffle import wire

df = pd.DataFrame({
    "k": np.arange(1000, dtype=np.int64) %% 7,
    "name": np.array(["grp%%d" %% (i %% 13) for i in range(1000)]),
    "v": np.linspace(0.0, 99.0, 1000),
})
payload = wire.serialize_batch(DeviceBatch.from_pandas(df, device="cpu"))
t = SocketTransport("xp-b")
CHUNK = 4096

def meta(_p):
    return json.dumps({"n": len(payload), "chunk": CHUNK}).encode()

def transfer(p):
    req = json.loads(bytes(p).decode())
    def pump():
        off, tag = 0, req["tag"]
        while off < len(payload):
            t.get_server().send(req["peer"], tag, payload[off:off + CHUNK],
                                lambda _t: None)
            off += CHUNK
            tag += 1
    threading.Thread(target=pump, daemon=True).start()
    return b"ok"

t.get_server().register_request_handler(RequestType.METADATA, meta)
t.get_server().register_request_handler(RequestType.TRANSFER, transfer)
print("READY", flush=True)
time.sleep(60)
"""


def _fetch_from_child(client_mod, wire_mod, ttl_env, child_code):
    """Start ``child_code`` serving executor "xp-b", fetch its frame with
    ``client_mod``'s SocketTransport as "xp-a" through the file registry,
    and return the frame."""
    import tempfile
    reg = os.path.join(tempfile.mkdtemp(), "registry")
    env = dict(os.environ, SRT_SHUFFLE_REGISTRY_FILE=reg,
               JAX_PLATFORMS="cpu", XP_CHILD_TTL="60", **ttl_env)
    child = subprocess.Popen([sys.executable, "-c", child_code], env=env,
                             stdout=subprocess.PIPE, text=True)
    saved = os.environ.get("SRT_SHUFFLE_REGISTRY_FILE")
    try:
        assert child.stdout.readline().strip() == "READY"
        os.environ["SRT_SHUFFLE_REGISTRY_FILE"] = reg
        a = client_mod.SocketTransport("xp-a")
        try:
            client = a.make_client("xp-b")
            rt = (sys.modules[client_mod.__name__
                              .replace("socket_transport", "transport")])

            def ask(kind, payload):
                got = {}
                ev = threading.Event()
                client.request(kind, payload,
                               lambda t, r: (got.update(t=t, r=bytes(r)),
                                             ev.set()))
                assert ev.wait(15)
                assert got["t"].status == rt.TransactionStatus.SUCCESS
                return got["r"]
            meta = json.loads(ask(rt.RequestType.METADATA, b"?").decode())
            n, chunk = meta["n"], meta["chunk"]
            nchunks = -(-n // chunk)
            bufs = [bytearray(min(chunk, n - i * chunk))
                    for i in range(nchunks)]
            evs = [threading.Event() for _ in range(nchunks)]
            for i in range(nchunks):
                client.receive(1000 + i, bufs[i],
                               lambda t, i=i: evs[i].set())
            ask(rt.RequestType.TRANSFER, json.dumps(
                {"tag": 1000, "peer": "xp-a", "drop_after": None}).encode())
            assert all(e.wait(WAIT) for e in evs)
            return b"".join(bytes(b) for b in bufs)
        finally:
            a.shutdown()
    finally:
        if saved is None:
            os.environ.pop("SRT_SHUFFLE_REGISTRY_FILE", None)
        else:
            os.environ["SRT_SHUFFLE_REGISTRY_FILE"] = saved
        child.kill()
        child.wait()


def _check_frame(df: pd.DataFrame) -> None:
    assert len(df) == 1000
    assert df["k"].tolist() == [i % 7 for i in range(1000)]
    assert df["name"].tolist() == ["grp%d" % (i % 13) for i in range(1000)]
    np.testing.assert_allclose(df["v"].to_numpy(),
                               np.linspace(0.0, 99.0, 1000))


def test_port_fetches_from_a_jax_package_process():
    from tests.test_socket_xproc import _CHILD
    from spark_rapids_tpu_torch.shuffle import socket_transport
    blob = _fetch_from_child(socket_transport, wire, {},
                             _CHILD % {"repo": REPO})
    _check_frame(wire.deserialize_batch(blob, "cpu").to_pandas())


def test_jax_package_fetches_from_a_port_process():
    from spark_rapids_tpu.shuffle import socket_transport as jsock
    from spark_rapids_tpu.shuffle import wire as jwire
    import spark_rapids_tpu.shuffle.transport  # noqa: F401
    blob = _fetch_from_child(jsock, jwire, {}, _PORT_CHILD % {"repo": REPO})
    _check_frame(jwire.deserialize_batch(blob).to_pandas())


# --- obs/syncledger.sync_scope across threads --------------------------------

class _FakeCuda:
    """Stands in for the CUDA context's process-wide sync debug mode."""

    def __init__(self, mode):
        self.mode = mode
        self.log = []

    def get(self):
        return self.mode

    def set(self, m):
        self.mode = {"default": 0, "warn": 1, "error": 2}.get(m, m)
        self.log.append(self.mode)


@pytest.fixture
def fake_cuda(monkeypatch):
    fake = _FakeCuda(2)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", fake.get)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", fake.set)
    return fake


def _run_interleaved(order, fake):
    """Threads "A" and "B" each open a scope and close it, the four steps
    in ``order`` (e.g. "AB ab": A opens, B opens, A closes, B closes);
    returns the mode each thread saw inside its scope just before it
    closed, its counted copy's moment."""
    from spark_rapids_tpu_torch.obs.syncledger import sync_scope
    steps = [c for c in order if c != " "]
    go = {c: threading.Event() for c in steps}
    done = {c: threading.Event() for c in steps}
    seen = {}

    def worker(name):
        go[name].wait(WAIT)
        with sync_scope(f"test.{name}"):
            done[name].set()
            go[name.lower()].wait(WAIT)
            seen[name] = fake.mode
        done[name.lower()].set()
    threads = [threading.Thread(target=worker, args=(n,), daemon=True)
               for n in "AB"]
    for t in threads:
        t.start()
    for c in steps:
        go[c].set()
        assert done[c].wait(WAIT)
    for t in threads:
        t.join(WAIT)
        assert not t.is_alive()
    return seen


@pytest.mark.parametrize("order", ["AB ab", "BA ba", "AB ba", "A a B b"])
def test_sync_scopes_on_two_threads_keep_the_debug_mode(order, fake_cuda):
    """A thread's counted wait never runs under the mode another thread
    restored, and the mode seen outside every scope is the one set before
    them (a scope that saved and restored the mode itself failed "AB ab"
    and "BA ba" both ways: the second thread's copy ran under "error",
    and its exit left the mode off)."""
    seen = _run_interleaved(order, fake_cuda)
    assert seen == {"A": 0, "B": 0}
    assert fake_cuda.mode == 2


def test_sync_scopes_under_thread_contention_keep_the_debug_mode(
        fake_cuda):
    """16 threads (more than this machine's cores), a short switch
    interval, each opening 300 scopes, some nested: inside every scope
    the mode is lifted, and after all of them the count of open scopes is
    0 and the mode is the one set before them."""
    from spark_rapids_tpu_torch.obs import syncledger
    bad = []

    def worker(i):
        for j in range(300):
            with syncledger.sync_scope("test.stress"):
                if fake_cuda.mode != 0:
                    bad.append((i, j))
                if j % 7 == 0:
                    with syncledger.sync_scope("test.stress.inner"):
                        if fake_cuda.mode != 0:
                            bad.append((i, j))
    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,), daemon=True)
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(saved)
    assert not bad, bad[:5]
    assert syncledger._MODE["open"] == 0
    assert fake_cuda.mode == 2


def test_guard_set_while_a_scope_is_open(fake_cuda):
    """The transfer guard armed while another thread's scope is open takes
    effect when the last scope closes, and is restored after."""
    from spark_rapids_tpu_torch.obs.syncledger import (
        guard_context, sync_scope,
    )
    fake_cuda.mode = 0
    inside, release = threading.Event(), threading.Event()

    def other():
        with sync_scope("test.other"):
            inside.set()
            release.wait(WAIT)
    t = threading.Thread(target=other, daemon=True)
    t.start()
    assert inside.wait(WAIT)
    with guard_context("disallow", "cuda"):
        assert fake_cuda.mode == 0  # lifted while the scope is open
        release.set()
        t.join(WAIT)
        assert not t.is_alive()
        assert fake_cuda.mode == 2  # in force once it closed
        with sync_scope("test.mine"):
            assert fake_cuda.mode == 0
        assert fake_cuda.mode == 2
    assert fake_cuda.mode == 0


# --- obs/shuffleobs.py ----------------------------------------------------

@pytest.mark.parametrize("sizes", [[], [5], [0, 0, 9], [3, 1, 2, 8],
                                   [10, 10, 10, 10, 1000]])
def test_skew_summary_is_the_jax_packages(sizes):
    from spark_rapids_tpu.obs.shuffleobs import skew_summary as ref
    from spark_rapids_tpu_torch.obs.shuffleobs import skew_summary
    assert skew_summary(sizes) == ref(sizes)


def test_skew_is_journaled_by_the_manager_route(rng):
    from spark_rapids_tpu_torch.obs.events import EVENTS
    from spark_rapids_tpu_torch.obs.progress import PROGRESS
    seq = max((e["seq"] for e in EVENTS.flight_events()), default=0)
    PROGRESS.configure(True)
    s = _session(**dict(MANAGER_CONF, **{
        "spark.rapids.shuffle.executors": 2}))
    try:
        (s.create_dataframe(_frame(rng, 2000), 3).group_by("name")
         .agg(F.sum("v").alias("sv")).collect())
        summary = s.profile_json()["summary"]
        progress = PROGRESS.queries(full=True)[0]["shuffle"]
    finally:
        s.stop()
        PROGRESS.configure(False)
    events = [e for e in EVENTS.flight_events()
              if e["seq"] > seq and e["kind"] == "shuffleSkew"]
    assert events and events[0]["source"].startswith("tpu:manager-")
    assert events[0]["partitions"] == 8
    assert summary["shuffleSkew"]["shuffle.skew.shuffles"] == 1
    assert progress["fetches"] > 0 and progress["bytes"] > 0

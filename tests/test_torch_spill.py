"""The port's three-tier spill store (``memory/spill.py``) and its use by
the session, on the CPU, against the contracts of the JAX package's
``tests/test_spill.py``, ``test_spill_faults.py``,
``test_spill_integration.py`` and ``test_leak_tracker.py``.

The catalog's tier walk (device -> host -> disk and back, re-metered on
the way back), the priority order, the host bound cascading to disk; a
disk-write failure (the buffer stays in the host tier, a memoryPressure
record and the failure counter, a cool-down, then recovery); concurrent
acquires racing synchronous spills; leak records through the life of a
buffer; a spilled and faulted batch bit-equal to the original for every
column form (numeric, dictionary, char slab, nulls) through the host
arena, plain host memory and disk. Then queries through the port's
session under a budget far below their data (the JAX package's tight
budgets): cached scan batches spill to host and disk and fault back on
the next run, a broadcast table spills at its band, transient metering
does not grow across runs, and every answer equals the JAX package's
session and pandas (float sums at rtol 1e-9).
"""

import threading

import numpy as np
import pandas as pd
import pytest

from spark_rapids_tpu.sql import functions as RF
from spark_rapids_tpu_torch.columnar.batch import (
    DeviceBatch, flatten_batch,
)
from spark_rapids_tpu_torch.memory import spill as spill_mod
from spark_rapids_tpu_torch.memory.leak import TRACKER, assert_no_leaks
from spark_rapids_tpu_torch.memory.spill import (
    PRESSURE, BufferCatalog, MemoryEventHandler, SpillPriorities,
    StorageTier,
)
from spark_rapids_tpu_torch.obs.metrics import REGISTRY
from spark_rapids_tpu_torch.session import TpuSparkSession
from spark_rapids_tpu_torch.sql import functions as F
from tests.querytest import with_tpu_session
from spark_rapids_tpu_torch.testing.signals import release_sigusr1  # noqa: F401

F64_RTOL = 1e-9


def _batch(n=64, seed=0):
    rng = np.random.default_rng(seed)
    return DeviceBatch.from_pandas(pd.DataFrame({
        "a": rng.integers(0, 1000, n),
        "b": rng.uniform(0, 1, n),
        "s": [f"str_{i}" for i in range(n)],
    }), device="cpu", slab_stride=64)


@pytest.fixture
def catalog(tmp_path):
    c = BufferCatalog(host_limit_bytes=1 << 20, disk_dir=str(tmp_path))
    yield c
    c.close()


def _same(b1: DeviceBatch, b2: DeviceBatch):
    pd.testing.assert_frame_equal(b1.to_pandas(), b2.to_pandas())


# --- the catalog (the JAX package's tests/test_spill.py) --------------------

def test_add_acquire_and_unknown_id(catalog):
    b = _batch()
    bid = catalog.add_batch(b)
    assert catalog.buffer_tier(bid) == StorageTier.DEVICE
    _same(catalog.acquire_batch(bid), b)
    with pytest.raises(AssertionError):
        catalog.acquire_batch(999)


def test_remove_frees(catalog):
    bid = catalog.add_batch(_batch())
    catalog.remove(bid)
    assert catalog.buffer_tier(bid) is None
    with pytest.raises(AssertionError):
        catalog.acquire_batch(bid)


def test_acquire_walks_the_tiers_back_to_the_device(catalog):
    """Fault-back re-tiers the buffer and moves its bytes back to the
    device store (otherwise the budget undercounts resident memory)."""
    b = _batch()
    bid = catalog.add_batch(b)
    catalog.device_store.synchronous_spill(0)
    assert catalog.buffer_tier(bid) == StorageTier.HOST
    assert catalog.device_store.total_size == 0
    _same(catalog.acquire_batch(bid), b)
    assert catalog.buffer_tier(bid) == StorageTier.DEVICE
    assert catalog.device_store.total_size > 0
    assert catalog.host_store.total_size == 0
    catalog.device_store.synchronous_spill(0)
    catalog.host_store.synchronous_spill(0)
    assert catalog.buffer_tier(bid) == StorageTier.DISK
    assert catalog.disk_store.total_size > 0
    _same(catalog.acquire_batch(bid), b)
    assert catalog.buffer_tier(bid) == StorageTier.DEVICE
    assert catalog.disk_store.total_size == 0


def test_faulted_back_buffer_keeps_its_clean_disk_copy(catalog,
                                                      monkeypatch):
    """A batch never changes: one faulted back from disk keeps its file,
    and its next spill drops the device references without writing."""
    b = _batch()
    bid = catalog.add_batch(b)
    catalog.device_store.synchronous_spill(0)
    catalog.host_store.synchronous_spill(0)
    catalog.acquire_batch(bid)
    assert catalog.buffer_tier(bid) == StorageTier.DEVICE

    def no_write(*a, **kw):
        raise AssertionError("a clean copy was written again")
    monkeypatch.setattr(np, "savez", no_write)
    drops = REGISTRY.value("spill.cleanDrops")
    d2h = REGISTRY.value("spill.events", direction="device_to_host")
    assert catalog.device_store.synchronous_spill(0) > 0
    assert catalog.buffer_tier(bid) == StorageTier.DISK
    assert catalog.host_store.total_size == 0
    assert REGISTRY.value("spill.cleanDrops") == drops + 1
    assert REGISTRY.value("spill.events", direction="device_to_host") == d2h
    _same(catalog.acquire_batch(bid), b)


def test_priority_order(catalog):
    low = catalog.add_batch(_batch(seed=1),
                            priority=SpillPriorities.OUTPUT_FOR_READ)
    high = catalog.add_batch(_batch(seed=2), priority=SpillPriorities.INPUT)
    total = catalog.device_store.total_size
    catalog.device_store.synchronous_spill(total // 2)
    assert catalog.buffer_tier(low) == StorageTier.HOST
    assert catalog.buffer_tier(high) == StorageTier.DEVICE


def test_spill_to_target(catalog):
    for i in range(6):
        catalog.add_batch(_batch(seed=i))
    catalog.device_store.synchronous_spill(0)
    assert catalog.device_store.total_size == 0


def test_host_limit_cascades_to_disk(tmp_path):
    c = BufferCatalog(host_limit_bytes=1, disk_dir=str(tmp_path))
    try:
        b = _batch()
        bid = c.add_batch(b)
        before = REGISTRY.value("spill.events", direction="host_to_disk")
        c.device_store.synchronous_spill(0)
        # the host store's bound is 1 byte: the buffer cascades to disk
        assert c.buffer_tier(bid) == StorageTier.DISK
        assert REGISTRY.value("spill.events",
                              direction="host_to_disk") == before + 1
        assert list(tmp_path.iterdir())
        _same(c.acquire_batch(bid), b)
    finally:
        c.close()
    assert not list(tmp_path.iterdir())


def test_over_budget_triggers_spill(tmp_path):
    """The RMM alloc-failure -> synchronousSpill contract
    (DeviceMemoryEventHandler.scala:65-89)."""

    class FakeManager:
        def __init__(self):
            self.allocated = 0

        def track_alloc(self, n):
            self.allocated += n

        def track_free(self, n):
            self.allocated -= n

    mgr = FakeManager()
    c = BufferCatalog(host_limit_bytes=1 << 20, disk_dir=str(tmp_path),
                      device_manager=mgr)
    try:
        handler = MemoryEventHandler(c.device_store)
        bid1 = c.add_batch(_batch(seed=1))
        size1 = c.device_store.total_size
        freed = handler(size1)  # demand the full store back
        assert freed >= size1
        assert c.buffer_tier(bid1) == StorageTier.HOST
        assert handler.spill_count == 1
        assert mgr.allocated == 0
        assert PRESSURE[-1]["freedBytes"] == freed
    finally:
        c.close()


# --- faults (the JAX package's tests/test_spill_faults.py) ------------------

def _const(i, rows=64):
    return DeviceBatch.from_pandas(pd.DataFrame({
        "a": np.full(rows, i, dtype=np.int64),
        "b": np.full(rows, float(i))}), device="cpu")


def test_concurrent_acquire_races_synchronous_spill():
    catalog = BufferCatalog(host_limit_bytes=1 << 16)
    try:
        rows = 64
        bids = [catalog.add_batch(_const(i, rows)) for i in range(8)]
        errors = []
        stop = threading.Event()

        def reader(bid, want):
            try:
                for _ in range(30):
                    if stop.is_set():
                        return
                    got = catalog.acquire_batch(bid)
                    assert (got.columns[0].data[:rows].numpy()
                            == want).all(), (bid, want)
            except BaseException as e:  # noqa: BLE001
                errors.append(e)
                stop.set()

        def spiller():
            try:
                for _ in range(60):
                    if stop.is_set():
                        return
                    catalog.device_store.synchronous_spill(0)
                    catalog.host_store.synchronous_spill(0)
            except BaseException as e:  # noqa: BLE001
                errors.append(e)
                stop.set()

        threads = [threading.Thread(target=reader, args=(bid, i))
                   for i, bid in enumerate(bids)]
        threads += [threading.Thread(target=spiller) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not errors, errors[0]
        for i, bid in enumerate(bids):
            got = catalog.acquire_batch(bid)
            assert (got.columns[0].data[:rows].numpy() == i).all()
            assert catalog.buffer_tier(bid) == StorageTier.DEVICE
        # every store holds exactly its tier's buffers
        for store in (catalog.device_store, catalog.host_store,
                      catalog.disk_store):
            assert all(b.tier == store.tier
                       for b in store._buffers.values())
            assert store.total_size == sum(
                b.size for b in store._buffers.values())
    finally:
        catalog.close()


def _pressure_with_error():
    return [e for e in PRESSURE if e.get("diskWriteError")]


def test_disk_write_failure_surfaces_memory_pressure(monkeypatch):
    catalog = BufferCatalog(host_limit_bytes=1 << 16)
    try:
        rows = 64
        bid = catalog.add_batch(_const(7, rows))
        assert catalog.device_store.synchronous_spill(0) > 0
        assert catalog.buffer_tier(bid) == StorageTier.HOST

        def boom(*a, **kw):
            raise OSError("disk full (injected)")
        monkeypatch.setattr(np, "savez", boom)
        f0 = REGISTRY.value("spill.diskWriteFailures")
        e0 = len(_pressure_with_error())
        # nothing freed, the buffer intact in the host tier
        assert catalog.host_store.synchronous_spill(0) == 0
        assert REGISTRY.value("spill.diskWriteFailures") == f0 + 1
        assert len(_pressure_with_error()) == e0 + 1
        assert catalog.buffer_tier(bid) == StorageTier.HOST
        monkeypatch.undo()
        got = catalog.acquire_batch(bid)
        assert (got.columns[0].data[:rows].numpy() == 7).all()
    finally:
        catalog.close()


def test_disk_failure_then_recovery_round_trip(monkeypatch):
    catalog = BufferCatalog(host_limit_bytes=1 << 16)
    try:
        rows = 32
        bid = catalog.add_batch(_const(3, rows))
        catalog.device_store.synchronous_spill(0)
        real_savez = np.savez
        calls = {"n": 0}

        def flaky(*a, **kw):
            calls["n"] += 1
            if calls["n"] == 1:
                raise OSError("transient (injected)")
            return real_savez(*a, **kw)
        monkeypatch.setattr(np, "savez", flaky)
        assert catalog.host_store.synchronous_spill(0) == 0
        # the cool-down: an immediate second pass does not re-serialize
        assert catalog.host_store.synchronous_spill(0) == 0
        assert calls["n"] == 1
        catalog.host_store._disk_retry_at = 0.0  # cool-down elapsed
        assert catalog.host_store.synchronous_spill(0) > 0
        assert catalog.buffer_tier(bid) == StorageTier.DISK
        got = catalog.acquire_batch(bid)
        assert (got.columns[0].data[:rows].numpy() == 3).all()
        assert catalog.buffer_tier(bid) == StorageTier.DEVICE
    finally:
        catalog.close()


# --- leaks and every column form ----------------------------------------

def test_spillable_buffers_tracked():
    catalog = BufferCatalog(host_limit_bytes=1 << 20)
    before = TRACKER.live_count
    batch = DeviceBatch.from_pandas(
        pd.DataFrame({"x": np.arange(100, dtype=np.float64)}), device="cpu")
    bid = catalog.add_batch(batch)
    assert TRACKER.live_count == before + 1
    catalog.device_store.synchronous_spill(0)
    assert TRACKER.live_count == before + 1  # spilled, not closed
    assert catalog.acquire_batch(bid).num_rows_host() == 100
    catalog.close()
    assert TRACKER.live_count == before


def _forms_batch():
    n = 300
    rng = np.random.default_rng(11)
    df = pd.DataFrame({
        "i": rng.integers(-9, 9, n).astype(np.int64),
        "n": pd.array(np.where(rng.random(n) < 0.3, None,
                               rng.integers(0, 1 << 40, n)), dtype="Int64"),
        "f": rng.normal(size=n),
        "d": np.array(["aa", "b", None, "cccc"], dtype=object)[
            rng.integers(0, 4, n)],
        "s": np.array([f"row-{i}-" + "z" * (i % 70) if i % 7 else None
                       for i in range(n)], dtype=object),
        "t": np.arange(n) % 2 == 0,
    })
    return DeviceBatch.from_pandas(df, {}, device="cpu",
                                   slab_stride=1 << 10)


@pytest.mark.parametrize("route", ["arena", "plain_host", "disk"])
def test_spilled_batch_bit_equal_for_every_column_form(tmp_path, route):
    batch = _forms_batch()
    forms = {("dict" if c.dict_values is not None else
              "slab" if c.has_slab else "fixed") for c in batch.columns}
    assert forms == {"dict", "slab", "fixed"}
    want, layout = flatten_batch(batch)
    want = [t.clone() for t in want]
    c = BufferCatalog(host_limit_bytes=1 << 22, disk_dir=str(tmp_path))
    arena = c.host_store.arena
    # the plain-host route: the arena is full
    hog = arena.alloc(arena.capacity) if route == "plain_host" else None
    try:
        with assert_no_leaks():
            bid = c.add_batch(batch)
            del batch
            c.device_store.synchronous_spill(0)
            assert c.buffer_tier(bid) == StorageTier.HOST
            host = c._buffers[bid]._host
            assert (host["extents"] is None) == (route == "plain_host")
            if route == "disk":
                c.host_store.synchronous_spill(0)
                assert c.buffer_tier(bid) == StorageTier.DISK
            got, got_layout = flatten_batch(c.acquire_batch(bid))
            assert got_layout == layout
            assert len(got) == len(want)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype and g.shape == w.shape
                assert np.array_equal(g.reshape(-1).numpy().view(np.uint8),
                                      w.reshape(-1).numpy().view(np.uint8))
            c.remove(bid)
        if hog is not None:
            arena.free(hog)
        assert arena.allocated == 0
    finally:
        c.close()


# --- through the session (the JAX package's test_spill_integration.py) -----

def _table(n=20000, seed=42):
    rng = np.random.default_rng(seed)
    return pd.DataFrame({
        "k": np.array(["g%02d" % g for g in rng.integers(0, 25, n)]),
        "v": rng.random(n) * 10.0,
        "w": rng.integers(0, 1000, n).astype(np.int64),
    })


def _session(tmp_path, **conf):
    b = (TpuSparkSession.builder().device("cpu")
         .config("spark.rapids.sql.test.enabled", True)
         .config("spark.rapids.memory.spill.diskDir", str(tmp_path)))
    for k, v in conf.items():
        b.config(k, v)
    return b.get_or_create()


def _same_by_key(got, want, key):
    got = got.sort_values(key).reset_index(drop=True)
    want = want.sort_values(key).reset_index(drop=True)
    assert list(got[key]) == list(want[key])
    for c in want.columns:
        if c == key:
            continue
        if pd.api.types.is_float_dtype(want[c]):
            np.testing.assert_allclose(got[c].to_numpy(np.float64),
                                       want[c].to_numpy(np.float64),
                                       rtol=F64_RTOL)
        else:
            assert list(got[c]) == list(want[c]), c


def test_query_spills_cached_scans_and_faults_them_back(tmp_path):
    pdf = _table()
    s = _session(tmp_path, **{"spark.rapids.sql.cacheDeviceScans": True,
                              "spark.rapids.sql.batchSizeRows": 2048})

    def q(sess, scan):
        return (scan.filter(F.col("w") > 100).group_by("k")
                .agg(F.sum("v").alias("sv"), F.count("*").alias("n")))

    def ref(sess):
        return (sess.create_dataframe(pdf, 1).filter(RF.col("w") > 100)
                .group_by("k").agg(RF.sum("v").alias("sv"),
                                   RF.count("*").alias("n")))
    f = pdf[pdf.w > 100]
    want = f.groupby("k", as_index=False).agg(sv=("v", "sum"),
                                              n=("v", "size"))
    # budget far below the cached scan: the handler spills cached batches
    # down the tiers; the tiny host tier forces the second hop too
    s.device_manager.hbm_budget = 64 << 10
    s.buffer_catalog.host_store.limit_bytes = 128 << 10
    scan = s.create_dataframe(pdf)
    before = s.memory_event_handler.spill_count
    got1 = q(s, scan).collect()
    mm = s.last_query_metrics["memory"]
    assert s.memory_event_handler.spill_count > before, mm
    assert mm["spillEvents.device_to_host"] > 0
    assert mm["spillBytes.host_to_disk"] > 0
    tiers = {s.buffer_catalog.buffer_tier(bid)
             for _src, parts in s.device_scan_cache.values()
             for bids in parts.values() for bid in bids}
    assert StorageTier.DISK in tiers, tiers
    faults0 = (REGISTRY.value("spill.faultBacks", tier="host")
               + REGISTRY.value("spill.faultBacks", tier="disk"))
    got2 = q(s, scan).collect()
    assert (REGISTRY.value("spill.faultBacks", tier="host")
            + REGISTRY.value("spill.faultBacks", tier="disk")) > faults0
    for got in (got1, got2):
        _same_by_key(got, want, "k")
    _same_by_key(got1, with_tpu_session(ref), "k")
    s.stop()
    assert s.buffer_catalog.device_store.total_size == 0
    assert not list(tmp_path.iterdir())


def test_cached_scan_batches_are_metered_once(tmp_path):
    """A cached scan batch is metered by the catalog it lives in, not
    also as an uploaded batch: after a collect the meter holds exactly the
    device tier's bytes."""
    import gc
    pdf = _table()
    s = _session(tmp_path, **{"spark.rapids.sql.cacheDeviceScans": True,
                              "spark.rapids.sql.batchSizeRows": 2048})
    scan = s.create_dataframe(pdf)
    for _ in range(2):
        scan.filter(F.col("w") > 100).group_by("k").agg(
            F.sum("v").alias("sv")).collect()
        gc.collect()
        store = s.buffer_catalog.device_store
        assert store.total_size > 0
        assert s.device_manager.allocated == store.total_size
    s.stop()
    gc.collect()
    assert s.device_manager.allocated == 0


def test_sessions_sharing_a_spill_dir_keep_their_own_files(tmp_path):
    """Two live sessions spilling into one diskDir: each catalog numbers
    its buffers from 1, yet each faults back its own rows, and one
    session's stop leaves the other's files in place."""
    conf = {"spark.rapids.sql.cacheDeviceScans": True,
            "spark.rapids.sql.batchSizeRows": 2048}
    pdfs = [_table(seed=1), _table(seed=2)]
    sessions = [_session(tmp_path, **conf) for _ in pdfs]
    scans = []
    for s, pdf in zip(sessions, pdfs):
        s.device_manager.hbm_budget = 64 << 10
        s.buffer_catalog.host_store.limit_bytes = 1
        scans.append(s.create_dataframe(pdf))

    def run(i):
        got = scans[i].group_by("k").agg(F.sum("v").alias("sv"),
                                         F.sum("w").alias("sw")).collect()
        want = pdfs[i].groupby("k", as_index=False).agg(
            sv=("v", "sum"), sw=("w", "sum"))
        _same_by_key(got, want, "k")

    for i in (0, 1, 0, 1):
        run(i)
    for s in sessions:
        tiers = {s.buffer_catalog.buffer_tier(bid)
                 for _src, parts in s.device_scan_cache.values()
                 for bids in parts.values() for bid in bids}
        assert StorageTier.DISK in tiers, tiers
    assert len(list(tmp_path.iterdir())) == 2
    sessions[0].stop()
    assert len(list(tmp_path.iterdir())) == 1
    run(1)
    run(1)
    sessions[1].stop()
    assert not list(tmp_path.iterdir())


def test_broadcast_table_spills_at_its_band(tmp_path, monkeypatch):
    """Broadcast tables live in the catalog (GpuBroadcastExchangeExec
    keeps them as spillable device buffers): each use acquires one,
    faulting an evicted table back; freed at the query's end."""
    spilled = []
    orig = spill_mod.SpillableBuffer.spill_to_host

    def recording(self, arena=None):
        freed = orig(self, arena)
        if freed:
            spilled.append(self.priority)
        return freed
    monkeypatch.setattr(spill_mod.SpillableBuffer, "spill_to_host",
                        recording)
    left = _table(4000)
    right = pd.DataFrame({"k": np.array(["g%02d" % i for i in range(25)]),
                          "tag": np.arange(25, dtype=np.int64)})
    s = _session(tmp_path, **{"spark.rapids.sql.batchSizeRows": 1024})
    s.device_manager.hbm_budget = 32 << 10
    got = (s.create_dataframe(left, 4)
           .join(s.create_dataframe(right, 1), on="k", how="inner")
           .group_by("tag").agg(F.sum("v").alias("sv"))).collect()
    assert SpillPriorities.OUTPUT_FOR_WRITE in spilled, spilled
    want = left.merge(right, on="k").groupby("tag", as_index=False).agg(
        sv=("v", "sum"))
    _same_by_key(got, want, "tag")
    assert not s._transient_bids
    assert s.buffer_catalog.device_store.total_size == 0
    assert s.buffer_catalog.host_store.total_size == 0


def test_transient_metering_does_not_grow(tmp_path):
    import gc
    pdf = _table(4000)
    s = _session(tmp_path)

    def q():
        return s.create_dataframe(pdf, 2).group_by("k").agg(
            F.sum("v").alias("sv")).collect()
    q()
    gc.collect()
    first = s.device_manager.allocated
    for _ in range(3):
        q()
    gc.collect()
    assert s.device_manager.allocated <= first
    assert s.device_manager.peak > 0
    assert s.last_query_metrics["memory"]["spillEvents.device_to_host"] == 0

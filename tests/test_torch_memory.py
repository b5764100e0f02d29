"""The port's memory runtime pieces (``memory/leak.py``, ``memory/device.py``,
``memory/semaphore.py``, ``nativelib.py``, the batch's size and flatten,
the labeled metrics), on the CPU, against the contracts of the JAX
package's ``tests/test_leak_tracker.py`` and its ``memory/`` modules.

The leak tracker as the JAX package's tests hold it; the device budget:
``allocFraction`` of 16 GiB for ``device="cpu"`` (the JAX package's
assumption for a backend without statistics), of the card's memory for a
CUDA session, which raises without a card; metering and the spill handler
chain; the semaphore's admission, re-entry, resize and tenant budgets;
the host arena's best fit, coalescing and parked extents; the spill
queue's order; ``DeviceBatch.device_memory_size`` and
``flatten_batch``/``unflatten_batch`` over every column form.
"""

import gc
import threading
import time

import numpy as np
import pandas as pd
import pytest
import torch

from spark_rapids_tpu_torch.columnar.batch import (
    DeviceBatch, flatten_batch, unflatten_batch,
)
from spark_rapids_tpu_torch.config.conf import TpuConf
from spark_rapids_tpu_torch.memory.device import (
    CPU_ASSUMED_BYTES, TpuDeviceManager,
)
from spark_rapids_tpu_torch.memory.leak import (
    TRACKER, LeakTracker, assert_no_leaks,
)
from spark_rapids_tpu_torch.memory.semaphore import TpuSemaphore
from spark_rapids_tpu_torch.nativelib import HashedPriorityQueue, HostArena
from spark_rapids_tpu_torch.obs.metrics import MetricsRegistry
from spark_rapids_tpu_torch.obs.syncledger import SYNCS
from spark_rapids_tpu_torch.testing.signals import release_sigusr1  # noqa: F401


# --- leak tracker (the JAX package's tests/test_leak_tracker.py) ----------

def test_leak_register_unregister_and_report():
    t = LeakTracker()
    a = t.register(1024, "bufA")
    b = t.register(2048, "bufB")
    assert t.live_count == 2 and t.live_bytes == 3072
    lines = t.report()
    assert len(lines) == 2 and "bufA" in lines[0] and "size=1024B" in lines[0]
    t.unregister(a)
    assert t.live_count == 1
    t.unregister(b)
    assert t.live_count == 0 and t.report() == []


def test_leak_stack_capture():
    t = LeakTracker()
    t.capture_stacks = True
    tok = t.register(64, "withstack")
    assert "test_torch_memory" in t.report()[0]  # creation site visible
    t.unregister(tok)


def test_assert_no_leaks_context():
    with assert_no_leaks():
        TRACKER.unregister(TRACKER.register(10, "temp"))
    with pytest.raises(AssertionError, match="buffer leak"):
        with assert_no_leaks():
            leaked = TRACKER.register(10, "oops")
    TRACKER.unregister(leaked)


# --- the device budget ----------------------------------------------------

def test_device_budget_from_the_device():
    conf = TpuConf({"spark.rapids.memory.tpu.allocFraction": 0.5})
    dm = TpuDeviceManager(conf, "cpu")
    assert dm.hbm_total == CPU_ASSUMED_BYTES == 16 << 30
    assert dm.hbm_budget == 8 << 30
    cuda = TpuDeviceManager(conf, "cuda")
    if torch.cuda.is_available():
        assert cuda.hbm_total == torch.cuda.mem_get_info(0)[1]
        assert cuda.hbm_budget == int(cuda.hbm_total * 0.5)
    else:
        # never the CPU's assumption for a CUDA request
        with pytest.raises((RuntimeError, AssertionError)):
            cuda.hbm_budget


def _frame(n=100, seed=0):
    rng = np.random.default_rng(seed)
    return pd.DataFrame({"a": rng.integers(0, 1000, n),
                         "b": rng.uniform(0, 1, n)})


def test_meter_batch_frees_when_the_batch_goes():
    dm = TpuDeviceManager(TpuConf(), "cpu")
    batch = DeviceBatch.from_pandas(_frame(), device="cpu")
    dm.meter_batch(batch)
    size = batch.device_memory_size()
    assert size > 0 and dm.allocated == size == dm.peak
    del batch
    gc.collect()
    assert dm.allocated == 0 and dm.peak == size
    assert dm.per_device_peaks() == {torch.device("cpu"): size}


def test_track_alloc_drives_handlers_until_under_budget():
    dm = TpuDeviceManager(TpuConf(), "cpu")
    dm.hbm_budget = 100
    calls = []

    def h1(need):
        calls.append(("h1", need))
        return 30

    def h2(need):
        calls.append(("h2", need))
        return need
    dm.register_oom_handler(h1)
    dm.register_oom_handler(h2)
    dm.register_oom_handler(h1)  # once only
    dm.track_alloc(90)
    assert calls == []
    dm.track_alloc(60)  # 50 over: h1 frees 30, h2 the other 20
    assert calls == [("h1", 50), ("h2", 20)]
    dm.unregister_oom_handler(h2)
    dm.track_free(150)
    assert dm.allocated == 0


# --- the semaphore --------------------------------------------------------

def test_semaphore_admits_reenters_and_resizes():
    sem = TpuSemaphore(1)
    sem.acquire_if_necessary(task_id=1)
    sem.acquire_if_necessary(task_id=1)  # re-entrant: still one holder
    assert sem.available_permits() == 0
    order = []

    def other():
        sem.acquire_if_necessary(task_id=2)
        order.append("2 in")
        sem.release(task_id=2)
    t = threading.Thread(target=other)
    before = SYNCS.syncs.get("semaphore.wait", 0)
    t.start()
    time.sleep(0.2)
    assert order == []  # blocked behind task 1
    sem.release(task_id=1)
    t.join(10)
    assert order == ["2 in"]
    assert SYNCS.syncs.get("semaphore.wait", 0) == before + 1
    sem.resize(3)
    for tid in (1, 2, 3):
        sem.acquire_if_necessary(task_id=tid)
    assert sem.available_permits() == 0
    for tid in (1, 2, 3):
        sem.release(task_id=tid)
    assert sem.available_permits() == 3


def test_semaphore_tenant_budget_bounds_one_tenant():
    sem = TpuSemaphore(4)
    sem.configure_tenants({"a": 1})
    sem.acquire_if_necessary(task_id=1, tenant="a")
    sem.acquire_if_necessary(task_id=2, tenant="b")
    got = []

    def second_a():
        sem.acquire_if_necessary(task_id=3, tenant="a")
        got.append(3)
    t = threading.Thread(target=second_a)
    t.start()
    time.sleep(0.2)
    assert got == [] and sem.tenant_usage()["a"] == {
        "held": 1, "waiting": 1, "budget": 1}
    sem.release(task_id=1)
    t.join(10)
    assert got == [3]
    for tid in (2, 3):
        sem.release(task_id=tid)
    assert sem.available_permits() == 4


# --- the host arena and the spill queue -------------------------------------

class _Event:
    """A stand-in for a CUDA event: done after ``polls`` queries."""

    def __init__(self, polls):
        self.polls = polls
        self.waited = False

    def query(self):
        self.polls -= 1
        return self.polls < 0

    def synchronize(self):
        self.waited = True
        self.polls = -1


def test_host_arena_best_fit_coalesce_and_round_trip():
    arena = HostArena(1024, pinned=False, alignment=64)
    a = arena.alloc(100)   # 128
    b = arena.alloc(64)    # 64
    c = arena.alloc(200)   # 256
    assert (a, b, c) == (0, 128, 192)
    assert arena.allocated == 448 and arena.largest_free() == 576
    arena.write(b, b"spill me")
    assert arena.read(b, 8) == b"spill me"
    arena.free(b)
    # best fit: the 64-byte hole, not the tail
    assert arena.alloc(10) == 128
    arena.free(128)
    arena.free(a)
    arena.free(c)  # everything coalesces back into one extent
    assert arena.allocated == 0 and arena.largest_free() == 1024
    assert arena.peak == 448
    assert arena.alloc(2048) is None
    arena.close()
    with pytest.raises(ValueError):
        arena.alloc(8)


def test_host_arena_holds_an_extent_until_its_copy_ends():
    arena = HostArena(256, pinned=False, alignment=64)
    a = arena.alloc(256)
    ev = _Event(polls=3)
    assert arena.free(a, ev) == 0  # the copy still runs: parked
    assert arena.allocated == 256
    # the next alloc polls (not done), then waits for it: one counted sync
    before = SYNCS.syncs.get("spill.arenaReuse", 0)
    assert arena.alloc(64) == 0
    assert ev.waited
    assert SYNCS.syncs.get("spill.arenaReuse", 0) == before + 1
    done = _Event(polls=0)
    arena.free(0, done)  # already complete: freed at once
    assert arena.allocated == 0


def test_hashed_priority_queue_order():
    q = HashedPriorityQueue()
    for item, prio in [(5, 0), (3, 0), (9, -50), (1, 100)]:
        q.push(item, prio)
    assert 9 in q and len(q) == 4
    assert q.ordered() == [9, 3, 5, 1]
    assert q.peek_min() == 9 and q.pop_min() == 9
    assert q.remove(5) and not q.remove(5)
    assert [q.pop_min(), q.pop_min(), q.pop_min()] == [3, 1, None]


# --- batch size and flatten ---------------------------------------------------

def _forms_frame(n=400):
    """Every column form: numeric, a dictionary string, a char slab
    string (too many distinct values to encode) and nulls."""
    rng = np.random.default_rng(3)
    return pd.DataFrame({
        "i": rng.integers(-5, 5, n).astype(np.int64),
        "f": pd.array(np.where(rng.random(n) < 0.3, None, rng.random(n)),
                      dtype="Float64"),
        "d": np.array(["x", "yy", "zzz"], dtype=object)[np.arange(n) % 3],
        "s": np.array([f"v{i:05d}-" * (1 + i % 4) if i % 5 else None
                       for i in range(n)], dtype=object),
    })


def test_flatten_round_trip_every_column_form():
    df = _forms_frame()
    batch = DeviceBatch.from_pandas(df, {}, device="cpu",
                                    slab_stride=1 << 10)
    tensors, layout = flatten_batch(batch)
    assert batch.device_memory_size() == sum(
        t.numel() * t.element_size() for t in tensors)
    forms = [(c.dict_values is not None, c.has_slab) for c in batch.columns]
    assert (False, True) in forms and (True, False) in forms
    back = unflatten_batch([t.clone() for t in tensors], layout)
    assert back.host_rows == batch.host_rows
    pd.testing.assert_frame_equal(back.to_pandas(), batch.to_pandas())
    pd.testing.assert_frame_equal(back.to_pandas(), df, check_dtype=False)


def test_metrics_labels_and_gauges():
    r = MetricsRegistry()
    r.counter("spill.events", direction="device_to_host").add(2)
    r.counter("spill.events", direction="host_to_disk").add(1)
    r.counter("plain").add(5)
    r.gauge("memory.tier.bytes", tier="host").set(64)
    assert r.value("spill.events", direction="device_to_host") == 2
    assert r.value("spill.events", direction="nowhere") == 0
    assert r.values() == {"spill.events{direction=device_to_host}": 2,
                          "spill.events{direction=host_to_disk}": 1,
                          "plain": 5, "memory.tier.bytes{tier=host}": 64}

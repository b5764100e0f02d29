"""Three-tier spillable buffer store: device -> host -> disk (counterpart of
the JAX package's ``memory/spill.py``; reference: RapidsBuffer.scala,
RapidsBufferCatalog.scala, RapidsBufferStore.scala:44-188, the
Rapids{Device,Host,Disk}MemoryStores, SpillPriorities.scala:26-50,
DeviceMemoryEventHandler.scala:37-93).

  * ``SpillableBuffer``: one registered DeviceBatch, addressable by id,
    resident in exactly one tier. Device -> host copies every tensor of
    the batch (``columnar/batch.flatten_batch``: row count, data,
    validity, dictionary codes, char slab, lengths) into extents of the
    host store's arena (``nativelib.HostArena``, pinned for a CUDA
    session): asynchronous copies on the current stream, then one counted
    wait (``sync_scope("spill.deviceToHost")``) before the device
    references go, so the host bytes are complete and the device memory
    is free once the spill returns. Where the arena is full the tensors
    land in plain host memory (the same counted wait). Host -> disk
    writes one ``.npz`` a buffer. ``get_batch`` faults a buffer back to
    the device (the acquireBuffer tier walk): an asynchronous copy out of
    the arena, whose extents go back to the pool only once a CUDA event
    recorded after the copy has completed (``HostArena.free``); from
    plain host memory or disk through a pinned staging copy. A batch
    never changes, so a buffer faulted back from disk keeps its file as a
    clean copy, and its next spill only drops the device references
    (``drop_to_disk``, counted by ``spill.cleanDrops``): a cached scan
    read again and again under pressure is written once.
  * ``BufferStore``: per-tier registry and spill order (lowest priority,
    then oldest id, first); ``synchronous_spill(target)`` moves buffers to
    the next tier until the store holds at most ``target`` bytes.
  * ``BufferCatalog``: id -> buffer over the store chain.
  * ``MemoryEventHandler``: registered with the session's
    ``TpuDeviceManager``; an allocation past the budget spills the device
    store down by the overage.

A disk-write failure leaves the buffer in the host tier, emits a
``memoryPressure`` event and advances ``spill.diskWriteFailures``; the
host store then backs off for ``DISK_RETRY_COOLDOWN_S``. Counters go to
``obs/metrics.REGISTRY`` under the JAX package's names: ``spill.events``
and ``spill.bytes`` by ``direction``, ``spill.faultBacks`` by ``tier``;
timers ``spill.time.*`` hold each move's host seconds. As in the JAX
package, each spill is a ``spill`` journal event and a ``PROGRESS.spill``
note, each move a tracer span (``spill.toHost``, ``spill.toDisk``,
``spill.faultBack``), and a spill pass forced by the budget a
``memoryPressure`` event (``obs/events.py``); ``PRESSURE`` keeps the
newest ``memoryPressure`` records for readers without a journal.

``EncodedPageCache`` is the device Parquet scan's cache of column-chunk
decode plans (a host tier of plans, a device tier of their uploaded
buffers). Its device tier is metered against the session's device budget
and, registered as a handler of that budget before the spill handler,
drops its buffers under pressure rather than spilling them: the host
tier still holds the plan, and a later scan uploads it again.
"""

from __future__ import annotations

import collections
import os
import shutil
import tempfile
import threading
import time
import weakref
from enum import IntEnum
from typing import Dict, List, Optional

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar.batch import (
    DeviceBatch, flatten_batch, unflatten_batch,
)
from spark_rapids_tpu_torch.obs.events import EVENTS
from spark_rapids_tpu_torch.obs.metrics import REGISTRY
from spark_rapids_tpu_torch.obs.progress import PROGRESS
from spark_rapids_tpu_torch.obs.syncledger import sync_scope
from spark_rapids_tpu_torch.obs.trace import TRACER

# host seconds of each tier move: a device -> host copy includes its wait,
# a fault-back its reads and the enqueue of its copies
_TIMES = {k: REGISTRY.timer(f"spill.time.{k}")
          for k in ("device_to_host", "host_to_disk", "fault_back_host",
                    "fault_back_disk")}
# the newest memoryPressure events' fields, newest last
PRESSURE: collections.deque = collections.deque(maxlen=256)


def record_pressure(**fields) -> None:
    """A ``memoryPressure`` journal event, kept in ``PRESSURE`` too."""
    EVENTS.emit("memoryPressure", **fields)
    PRESSURE.append(dict(fields, kind="memoryPressure", at=time.time()))


class StorageTier(IntEnum):
    """reference: StorageTier (RapidsBuffer.scala:52-66)."""
    DEVICE = 0
    HOST = 1
    DISK = 2


class SpillPriorities:
    """Priority bands (reference: SpillPriorities.scala:26-50). Lower
    spills first."""
    OUTPUT_FOR_READ = -100
    CACHED_SCAN = -50   # re-faultable device scan cache: cheap to evict
    OUTPUT_FOR_WRITE = 0
    ACTIVE_BATCH = 100
    INPUT = 2 ** 62  # last resort


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _to_device(a: np.ndarray, shape, device: torch.device) -> torch.Tensor:
    """A host array on ``device``: through a pinned staging copy to a CUDA
    device (stream-ordered, no wait), a private tensor on the CPU."""
    if device.type == "cuda":
        from spark_rapids_tpu_torch.columnar.column import host_to_device
        return host_to_device(a, device).reshape(shape)
    return torch.from_numpy(np.array(a)).reshape(shape)


class SpillableBuffer:
    """One spillable columnar batch (reference: RapidsBuffer trait)."""

    def __init__(self, buffer_id: int, batch: DeviceBatch, priority: int,
                 catalog: "BufferCatalog"):
        self.id = buffer_id
        self.priority = priority
        # weak: a catalog dropped with its session frees its buffers' device
        # memory at once, not at the next cyclic collection
        self._catalog = weakref.ref(catalog)
        self.tier = StorageTier.DEVICE
        self.size = batch.device_memory_size()
        self.device = batch.device
        self._device_batch: Optional[DeviceBatch] = batch
        # host tier: {"layout", "tensors", "extents" (offsets or None)}
        self._host: Optional[dict] = None
        self._disk_path: Optional[str] = None
        self._disk_layout = None
        self._lock = threading.RLock()
        self._disk_write_failed = False
        self.closed = False
        from spark_rapids_tpu_torch.memory.leak import TRACKER
        self._leak_token = TRACKER.register(self.size, "SpillableBuffer")

    # --- tier movement -----------------------------------------------------
    def spill_to_host(self, arena=None) -> int:
        """DEVICE -> HOST. Returns the device bytes freed."""
        with self._lock:
            if self.tier != StorageTier.DEVICE or self.closed:
                return 0
            t0 = time.perf_counter()
            tensors, layout = flatten_batch(self._device_batch)
            placed = self._place(arena, tensors) if arena is not None \
                else None
            with TRACER.span("spill.toHost", buffer=self.id,
                             bytes=self.size), \
                    sync_scope("spill.deviceToHost", nbytes=self.size):
                if placed is not None:
                    host = placed[1]
                    for dst, src in zip(host, tensors):
                        dst.copy_(src, non_blocking=True)
                    if self.device.type == "cuda":
                        ev = torch.cuda.Event()
                        ev.record()
                        ev.synchronize()
                else:
                    host = [t.to("cpu", copy=True) for t in tensors]
            self._host = {"layout": layout, "tensors": host,
                          "shapes": [tuple(t.shape) for t in tensors],
                          "extents": placed[0] if placed else None,
                          "arena": arena if placed else None}
            del tensors
            self._device_batch = None
            self.tier = StorageTier.HOST
            _TIMES["device_to_host"].record(time.perf_counter() - t0)
            return self.size

    @staticmethod
    def _place(arena, tensors):
        """(offsets, typed views) of arena extents for every tensor, or
        None (nothing held) when the pool cannot fit them all."""
        offs, views = [], []
        for t in tensors:
            n = _nbytes(t)
            off = arena.alloc(max(n, 1))
            if off is None:
                for o in offs:
                    arena.free(o)
                return None
            offs.append(off)
            views.append(arena.view(off, n).view(t.dtype).view(t.shape))
        return offs, views

    def _release_host(self, event=None) -> None:
        host = self._host
        if host and host["extents"] is not None:
            for off in host["extents"]:
                host["arena"].free(off, event)
        self._host = None

    @property
    def has_clean_copy(self) -> bool:
        """On the device with its spill file still on disk (it was faulted
        back from there): a spill needs no copy."""
        return self.tier == StorageTier.DEVICE and self._disk_path is not None

    def drop_to_disk(self) -> int:
        """DEVICE -> DISK for a buffer with a clean copy: drop the device
        references, write nothing. Returns the device bytes freed."""
        with self._lock:
            if not self.has_clean_copy or self.closed:
                return 0
            self._device_batch = None
            self.tier = StorageTier.DISK
            return self.size

    def spill_to_disk(self, disk_dir: str) -> int:
        """HOST -> DISK. Returns the bytes moved (the buffer's size).

        A disk-write failure (full or unwritable spill directory) never
        corrupts the catalog: the buffer stays in the HOST tier, a partial
        file is removed, and the failure surfaces as a ``memoryPressure``
        record and the ``spill.diskWriteFailures`` counter."""
        with self._lock:
            if self.tier != StorageTier.HOST or self.closed:
                return 0
            path = os.path.join(disk_dir, f"spill-{self.id}.npz")
            arrays = {f"a{i}": t.numpy()
                      for i, t in enumerate(self._host["tensors"])}
            try:
                with _TIMES["host_to_disk"].time(), \
                        TRACER.span("spill.toDisk", buffer=self.id,
                                    bytes=self.size):
                    np.savez(path, **arrays)
            except OSError as e:
                try:
                    if os.path.exists(path):
                        os.unlink(path)
                except OSError:
                    pass
                self._disk_write_failed = True  # the host store backs off
                REGISTRY.counter("spill.diskWriteFailures").add(1)
                record_pressure(neededBytes=self.size, freedBytes=0,
                                buffer=self.id, diskWriteError=str(e)[:200])
                return 0
            del arrays
            self._disk_layout = (self._host["layout"], self._host["shapes"])
            self._disk_path = path
            self._release_host()
            self.tier = StorageTier.DISK
            return self.size

    def get_batch(self) -> DeviceBatch:
        """Materialize on the device and promote back to the device tier
        (the acquireBuffer tier walk, RapidsBufferCatalog.scala:104); the
        promotion re-meters the buffer, which may spill colder ones."""
        with self._lock:
            assert not self.closed, f"buffer {self.id} already freed"
            if self.tier == StorageTier.DEVICE:
                return self._device_batch
            old_tier = self.tier
            REGISTRY.counter("spill.faultBacks",
                             tier=old_tier.name.lower()).add(1)
            t0 = time.perf_counter()
            with TRACER.span("spill.faultBack", buffer=self.id,
                             bytes=self.size, tier=old_tier.name.lower()):
                dev = self.device
                event = None
                if old_tier == StorageTier.HOST:
                    host = self._host
                    layout = host["layout"]
                    if host["extents"] is not None:
                        if dev.type == "cuda":
                            tensors = [t.to(dev, non_blocking=True)
                                       for t in host["tensors"]]
                            event = torch.cuda.Event()
                            event.record()
                        else:
                            tensors = [t.clone() for t in host["tensors"]]
                    else:
                        tensors = [_to_device(t.numpy(), s, dev)
                                   for t, s in zip(host["tensors"],
                                                   host["shapes"])]
                else:
                    layout, shapes = self._disk_layout
                    with np.load(self._disk_path) as z:
                        tensors = [_to_device(z[f"a{i}"], s, dev)
                                   for i, s in enumerate(shapes)]
                batch = unflatten_batch(tensors, layout)
            self._device_batch = batch
            self._release_host(event)
            # a batch never changes: the spill file stays as the clean copy
            # a later spill drops back to (``drop_to_disk``)
            self.tier = StorageTier.DEVICE
            _TIMES[f"fault_back_{old_tier.name.lower()}"].record(
                time.perf_counter() - t0)
            catalog = self._catalog()
            catalog.promoted(self, old_tier)
        catalog.metered(self)
        return batch

    def close(self) -> None:
        with self._lock:
            if self.closed:
                return
            self.closed = True
            self._device_batch = None
            self._release_host()
            if self._disk_path and os.path.exists(self._disk_path):
                os.unlink(self._disk_path)
            self._disk_path = None
            from spark_rapids_tpu_torch.memory.leak import TRACKER
            TRACKER.unregister(self._leak_token)


class BufferStore:
    """Per-tier registry + spill ordering (reference:
    RapidsBufferStore.scala:44-188)."""

    def __init__(self, tier: StorageTier,
                 spill_store: Optional["BufferStore"] = None):
        self.tier = tier
        self.spill_store = spill_store
        self._buffers: Dict[int, SpillableBuffer] = {}
        self._total = 0
        self._lock = threading.RLock()
        from spark_rapids_tpu_torch.nativelib import HashedPriorityQueue
        self._spill_queue = HashedPriorityQueue()

    @property
    def total_size(self) -> int:
        with self._lock:
            return self._total

    def add(self, buf: SpillableBuffer) -> None:
        with self._lock:
            if buf.id not in self._buffers:
                self._total += buf.size
            self._buffers[buf.id] = buf
            self._spill_queue.push(buf.id, buf.priority)

    def remove(self, buffer_id: int) -> Optional[SpillableBuffer]:
        with self._lock:
            buf = self._buffers.pop(buffer_id, None)
            if buf is not None:
                self._total -= buf.size
            self._spill_queue.remove(buffer_id)
            return buf

    def _spill_candidates(self) -> List[SpillableBuffer]:
        """Priority-ordered snapshot, lowest (most spillable) first."""
        with self._lock:
            return [self._buffers[i] for i in self._spill_queue.ordered()
                    if i in self._buffers and not self._buffers[i].closed]

    def spill_one(self, buf: SpillableBuffer) -> int:
        raise NotImplementedError

    def synchronous_spill(self, target_size: int) -> int:
        """Spill lowest-priority buffers until the store holds at most
        ``target_size`` bytes (reference: synchronousSpill,
        RapidsBufferStore.scala:148-188). Returns bytes spilled."""
        spilled = 0
        for buf in self._spill_candidates():
            if self.total_size <= target_size:
                break
            spilled += self.spill_one(buf)
        return spilled


class DeviceStore(BufferStore):
    """The device tier (reference: RapidsDeviceMemoryStore.scala): its
    buffers are metered by the device manager."""

    def __init__(self, spill_store: "HostStore", device_manager=None):
        super().__init__(StorageTier.DEVICE, spill_store)
        self.device_manager = device_manager

    def remove(self, buffer_id: int) -> Optional[SpillableBuffer]:
        buf = super().remove(buffer_id)
        if buf is not None and self.device_manager is not None:
            self.device_manager.track_free(buf.size)
        return buf

    def spill_one(self, buf: SpillableBuffer) -> int:
        with buf._lock:
            if buf.has_clean_copy:
                freed = buf.drop_to_disk()
                if freed:
                    self.remove(buf.id)
                    self.spill_store.spill_store.add(buf)
                    REGISTRY.counter("spill.cleanDrops").add(1)
                return freed
            freed = buf.spill_to_host(arena=self.spill_store.arena)
            if freed:
                self.remove(buf.id)
                self.spill_store.add(buf)
        if freed:
            REGISTRY.counter("spill.events", direction="device_to_host") \
                .add(1)
            REGISTRY.counter("spill.bytes", direction="device_to_host") \
                .add(freed)
            EVENTS.emit("spill", direction="device_to_host", bytes=freed,
                        buffer=buf.id)
            if PROGRESS.enabled:
                PROGRESS.spill(freed)
            # keep the host tier within its bound
            self.spill_store.enforce_limit()
        return freed


class HostStore(BufferStore):
    """Bounded host tier (reference: RapidsHostMemoryStore.scala,
    spark.rapids.memory.host.spillStorageSize, default 1 GiB) over one
    arena of that size: pinned for a CUDA session, plain memory for a CPU
    one."""

    #: seconds to back off after a disk-write failure: a full or
    #: unwritable spill directory would otherwise re-serialize every host
    #: buffer (and write a memoryPressure record each) on every spill pass
    DISK_RETRY_COOLDOWN_S = 5.0

    def __init__(self, limit_bytes: int, spill_store: "DiskStore",
                 pinned: bool = False):
        super().__init__(StorageTier.HOST, spill_store)
        self.limit_bytes = limit_bytes
        self._disk_retry_at = 0.0
        from spark_rapids_tpu_torch.nativelib import HostArena
        self.arena = HostArena(max(limit_bytes, 1 << 20), pinned=pinned)

    def spill_one(self, buf: SpillableBuffer) -> int:
        if time.monotonic() < self._disk_retry_at:
            return 0
        with buf._lock:
            freed = buf.spill_to_disk(self.spill_store.disk_dir)
            if buf._disk_write_failed:
                buf._disk_write_failed = False
                self._disk_retry_at = (time.monotonic()
                                       + self.DISK_RETRY_COOLDOWN_S)
            if freed:
                self.remove(buf.id)
                self.spill_store.add(buf)
        if freed:
            self._disk_retry_at = 0.0
            REGISTRY.counter("spill.events", direction="host_to_disk") \
                .add(1)
            REGISTRY.counter("spill.bytes", direction="host_to_disk") \
                .add(freed)
            EVENTS.emit("spill", direction="host_to_disk", bytes=freed,
                        buffer=buf.id)
            if PROGRESS.enabled:
                PROGRESS.spill(freed)
        return freed

    def enforce_limit(self) -> int:
        return self.synchronous_spill(self.limit_bytes)


class DiskStore(BufferStore):
    """The disk tier (reference: RapidsDiskStore.scala +
    RapidsDiskBlockManager): a fresh directory of its own, made at its
    first use under ``disk_dir`` (or the system's temporary directory)
    and removed at cleanup. Catalogs that share one ``disk_dir`` never
    see each other's files, although each numbers its buffers from 1."""

    def __init__(self, disk_dir: Optional[str] = None):
        super().__init__(StorageTier.DISK, None)
        self._parent = disk_dir or None
        self._dir: Optional[str] = None

    @property
    def disk_dir(self) -> str:
        """This catalog's spill directory, made at its first use."""
        with self._lock:
            if self._dir is None:
                if self._parent is not None:
                    os.makedirs(self._parent, exist_ok=True)
                self._dir = tempfile.mkdtemp(prefix="tpu-spill-",
                                             dir=self._parent)
            return self._dir

    def spill_one(self, buf: SpillableBuffer) -> int:
        return 0  # nowhere further to spill

    def cleanup(self) -> None:
        with self._lock:
            if self._dir is not None:
                shutil.rmtree(self._dir, ignore_errors=True)
                self._dir = None


class BufferCatalog:
    """id -> buffer registry over the store chain (reference:
    RapidsBufferCatalog.scala + GpuShuffleEnv.initStorage,
    GpuShuffleEnv.scala:51-72). ``device`` ("cuda" or "cpu") picks the
    host arena's memory: pinned for a CUDA session."""

    def __init__(self, host_limit_bytes: int = 1 << 30,
                 disk_dir: Optional[str] = None, device_manager=None,
                 device="cpu"):
        self.disk_store = DiskStore(disk_dir)
        self.host_store = HostStore(
            host_limit_bytes, self.disk_store,
            pinned=torch.device(device).type == "cuda")
        self.device_store = DeviceStore(self.host_store, device_manager)
        self._buffers: Dict[int, SpillableBuffer] = {}
        self._lock = threading.RLock()
        self._next_id = 0

    def next_id(self) -> int:
        with self._lock:
            self._next_id += 1
            return self._next_id

    def add_batch(self, batch: DeviceBatch,
                  priority: int = SpillPriorities.OUTPUT_FOR_WRITE,
                  buffer_id: Optional[int] = None) -> int:
        bid = buffer_id if buffer_id is not None else self.next_id()
        buf = SpillableBuffer(bid, batch, priority, self)
        with self._lock:
            assert bid not in self._buffers, f"duplicate buffer id {bid}"
            self._buffers[bid] = buf
        self.device_store.add(buf)
        self.metered(buf)
        return bid

    def metered(self, buf: SpillableBuffer) -> None:
        """Meter a buffer that (re)entered the device tier: past the
        budget, the handlers spill (possibly other) buffers."""
        dm = self.device_store.device_manager
        if dm is not None:
            dm.track_alloc(buf.size)

    def acquire_batch(self, buffer_id: int) -> DeviceBatch:
        with self._lock:
            buf = self._buffers.get(buffer_id)
        assert buf is not None, f"unknown buffer id {buffer_id}"
        return buf.get_batch()

    def contains(self, buffer_id: int) -> bool:
        with self._lock:
            return buffer_id in self._buffers

    def promoted(self, buf: SpillableBuffer, old_tier: StorageTier) -> None:
        """A spilled buffer faulted back to the device tier: move its store
        registration (the caller meters it)."""
        if old_tier == StorageTier.HOST:
            self.host_store.remove(buf.id)
        elif old_tier == StorageTier.DISK:
            self.disk_store.remove(buf.id)
        self.device_store.add(buf)

    def buffer_tier(self, buffer_id: int) -> Optional[StorageTier]:
        with self._lock:
            buf = self._buffers.get(buffer_id)
        return None if buf is None else buf.tier

    def remove(self, buffer_id: int) -> None:
        with self._lock:
            buf = self._buffers.pop(buffer_id, None)
        if buf is None:
            return
        with buf._lock:
            for store in (self.device_store, self.host_store,
                          self.disk_store):
                store.remove(buffer_id)
            buf.close()

    def publish_metrics(self, registry=REGISTRY) -> None:
        """Per-tier resident bytes and buffer counts into the registry."""
        for store in (self.device_store, self.host_store, self.disk_store):
            tier = store.tier.name.lower()
            registry.gauge("memory.tier.bytes", tier=tier) \
                .set(store.total_size)
            with store._lock:
                n = sum(1 for b in store._buffers.values() if not b.closed)
            registry.gauge("memory.tier.buffers", tier=tier).set(n)

    def close(self) -> None:
        with self._lock:
            ids = list(self._buffers.keys())
        for bid in ids:
            self.remove(bid)
        self.disk_store.cleanup()
        self.host_store.arena.close()


class MemoryEventHandler:
    """Spill-on-budget callback (reference:
    DeviceMemoryEventHandler.scala:65-89): when the device budget is
    exceeded by ``needed`` bytes, synchronously shrink the device store."""

    def __init__(self, device_store: DeviceStore):
        # weak: the device manager holds this handler and the store holds
        # the manager; a strong reference would keep a dropped session's
        # buffers alive until the next cyclic collection
        self._store = weakref.ref(device_store)
        self.spill_count = 0

    @property
    def device_store(self) -> DeviceStore:
        return self._store()

    def __call__(self, needed_bytes: int) -> int:
        store = self._store()
        if store is None:
            return 0
        target = max(store.total_size - needed_bytes, 0)
        freed = store.synchronous_spill(target)
        if freed:
            self.spill_count += 1
            # the backoff fact (distinct from the per-buffer spill counts
            # it triggered): how much pressure forced the pass
            record_pressure(neededBytes=needed_bytes, freedBytes=freed)
        return freed


class EncodedPageCache:
    """Encoded-page cache of the device Parquet scan: entries keyed by
    (path, file stamp, row group, column, slab limit) hold a column
    chunk's DECODE PLAN (the run tables and encoded page word buffers
    ``ops/parquet_decode`` builds, not decoded values), so the same budget
    holds far more of a table than a cache of decoded batches.

    Two budgets, LRU within each:

      * the host tier (``max_bytes``): the numpy plan buffers; a hit skips
        the file read, page split and run-table build;
      * the device tier (``device_max_bytes``): the buffers a decode
        uploaded and PROMOTED; a hit skips the upload too. Past its budget
        the device tier DEMOTES colder entries (drops their device
        buffers, keeps the host plan); past the host budget an entry
        goes.

    The file's stamp is in the key, so a rewritten file never hits again
    (its stale entries age out). With a ``device_manager`` every device
    byte is metered against the session's budget, and ``__call__`` (an
    over-budget handler of that manager) drops device buffers, coldest
    first, until the overage is freed. Thread-safe: plans are taken and
    put on planning threads, buffers promoted on the consuming thread.
    Counters ``pagecache.*`` (hits, misses, deviceHits, evictions,
    demotions, promotions, drops) and gauges ``pagecache.bytes`` and
    ``pagecache.deviceBytes`` go to ``obs/metrics.REGISTRY``."""

    def __init__(self, max_bytes: int = 256 << 20,
                 device_max_bytes: int = 64 << 20, device_manager=None):
        self.max_bytes = int(max_bytes)
        self.device_max_bytes = int(device_max_bytes)
        self._manager = device_manager
        # key -> [plan, nbytes, device_tree | None, device_nbytes]
        self._entries: "collections.OrderedDict[tuple, list]" = \
            collections.OrderedDict()
        self._bytes = 0
        self._dev_bytes = 0
        self._lock = threading.Lock()
        self._hits = REGISTRY.counter("pagecache.hits")
        self._misses = REGISTRY.counter("pagecache.misses")
        self._dev_hits = REGISTRY.counter("pagecache.deviceHits")
        self._evictions = REGISTRY.counter("pagecache.evictions")
        self._demotions = REGISTRY.counter("pagecache.demotions")
        self._promotions = REGISTRY.counter("pagecache.promotions")
        self._drops = REGISTRY.counter("pagecache.drops")
        self._g_bytes = REGISTRY.gauge("pagecache.bytes")
        self._g_dev = REGISTRY.gauge("pagecache.deviceBytes")

    def get(self, key):
        """Host-tier lookup (planning side): the cached plan, or None.
        Counts the hit or miss."""
        with self._lock:
            ent = self._entries.get(key)
            if ent is None:
                self._misses.add(1)
                return None
            self._entries.move_to_end(key)
            self._hits.add(1)
            return ent[0]

    def get_device(self, key):
        """Device-tier lookup (consuming side): the promoted device
        buffers, or None."""
        with self._lock:
            ent = self._entries.get(key)
            if ent is None or ent[2] is None:
                return None
            self._entries.move_to_end(key)
            self._dev_hits.add(1)
            return ent[2]

    def put(self, key, plan, nbytes: int) -> None:
        with self._lock:
            freed = 0
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old[1]
                freed += self._drop_device_locked(old)
            self._entries[key] = [plan, int(nbytes), None, 0]
            self._bytes += int(nbytes)
            freed += self._evict_locked()
            self._publish_locked()
        self._untrack(freed)

    def promote(self, key, device_tree, nbytes: int) -> None:
        """Attach a decode's freshly uploaded device buffers to the entry
        (metered); demotes colder device residents past the device
        budget."""
        with self._lock:
            ent = self._entries.get(key)
            if (ent is None or ent[2] is not None
                    or int(nbytes) > self.device_max_bytes):
                return
            ent[2], ent[3] = device_tree, int(nbytes)
            self._dev_bytes += int(nbytes)
            self._promotions.add(1)
            freed = 0
            for k in list(self._entries):
                if self._dev_bytes <= self.device_max_bytes:
                    break
                e = self._entries[k]
                if k != key and e[2] is not None:
                    freed += self._drop_device_locked(e)
                    self._demotions.add(1)
            self._publish_locked()
        self._untrack(freed)
        if self._manager is not None:
            self._manager.track_alloc(int(nbytes),
                                      device=self._manager.device)

    def __call__(self, needed_bytes: int) -> int:
        """Over-budget handler: drop device buffers, coldest first, until
        ``needed_bytes`` are freed; returns the bytes freed."""
        with self._lock:
            freed = 0
            for e in self._entries.values():
                if freed >= needed_bytes:
                    break
                if e[2] is not None:
                    freed += self._drop_device_locked(e)
                    self._drops.add(1)
            self._publish_locked()
        self._untrack(freed)
        return freed

    def _drop_device_locked(self, ent: list) -> int:
        freed = ent[3]
        self._dev_bytes -= freed
        ent[2], ent[3] = None, 0
        return freed

    def _evict_locked(self) -> int:
        freed = 0
        while self._bytes > self.max_bytes and len(self._entries) > 1:
            _k, ent = self._entries.popitem(last=False)
            self._bytes -= ent[1]
            freed += self._drop_device_locked(ent)
            self._evictions.add(1)
        return freed

    def _untrack(self, nbytes: int) -> None:
        if nbytes and self._manager is not None:
            self._manager.track_free(nbytes, device=self._manager.device)

    def _publish_locked(self) -> None:
        self._g_bytes.set(self._bytes)
        self._g_dev.set(self._dev_bytes)

    @property
    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._entries), "bytes": self._bytes,
                    "deviceBytes": self._dev_bytes}

    def clear(self) -> None:
        with self._lock:
            freed = self._dev_bytes
            self._entries.clear()
            self._bytes = 0
            self._dev_bytes = 0
            self._publish_locked()
        self._untrack(freed)

"""Host-side data structures of the memory runtime (counterpart of the JAX
package's ``nativelib.py``, without its C library).

  * ``HashedPriorityQueue``: the spill order of a store's buffers, a
    min-priority queue with O(1) membership (the JAX package's Python
    fallback of its native queue: a dict scanned for its minimum).
  * ``HostArena``: the host tier's staging pool (the reference's
    PinnedMemoryPool + AddressSpaceAllocator): one ``torch.uint8`` tensor,
    allocated at its first use and kept until ``close``, sub-allocated
    best fit into aligned extents. For a CUDA session the tensor is pinned,
    so a device -> host spill and a host -> device fault-back are
    asynchronous copies; for a CPU session (the tests' device) it is plain
    memory. The choice is the caller's, by device, never a probe.

An extent an asynchronous copy still reads or writes must not be handed
out again before the copy ends: ``free(offset, event)`` parks the extent
until the CUDA ``event`` recorded after the copy has completed, and
``alloc`` reclaims parked extents whose events are done (``event.query``,
no wait); only when nothing else fits does it wait for them, one counted
host wait (``spill.arenaReuse``).
"""

from __future__ import annotations

import bisect
import threading
from typing import List, Optional, Tuple

import torch

from spark_rapids_tpu_torch.obs.syncledger import sync_scope


class HostArena:
    """Aligned host memory pool with best-fit sub-allocation over one
    ``torch.uint8`` tensor of ``capacity`` bytes (pinned when ``pinned``)."""

    def __init__(self, capacity: int, pinned: bool, alignment: int = 64):
        self.capacity = int(capacity)
        self.alignment = int(alignment)
        self.pinned = bool(pinned)
        self._lock = threading.Lock()
        self._closed = False
        self._base: Optional[torch.Tensor] = None
        # free extents as sorted (offset, size); allocated offset -> size
        self._free: List[Tuple[int, int]] = [(0, self.capacity)]
        self._used: dict = {}
        # extents whose last asynchronous copy may still run: (offset, event)
        self._parked: List[Tuple[int, object]] = []
        self._allocated = 0
        self._peak = 0

    def _check_open(self) -> None:
        if self._closed:
            raise ValueError("arena is closed")

    def _tensor(self) -> torch.Tensor:
        if self._base is None:
            self._base = torch.empty(self.capacity, dtype=torch.uint8,
                                     pin_memory=self.pinned)
        return self._base

    def _round(self, size: int) -> int:
        a = self.alignment
        return max(a, (int(size) + a - 1) // a * a)

    def _take_locked(self, need: int) -> Optional[int]:
        best = None
        for i, (off, size) in enumerate(self._free):
            if size >= need and (best is None or size < self._free[best][1]):
                best = i
        if best is None:
            return None
        off, size = self._free.pop(best)
        if size > need:
            bisect.insort(self._free, (off + need, size - need))
        self._used[off] = need
        self._allocated += need
        self._peak = max(self._peak, self._allocated)
        return off

    def _release_locked(self, offset: int) -> int:
        size = self._used.pop(offset, None)
        if size is None:
            return 0
        self._allocated -= size
        i = bisect.bisect_left(self._free, (offset, size))
        # coalesce with the neighbours
        if i < len(self._free) and self._free[i][0] == offset + size:
            size += self._free.pop(i)[1]
        if i > 0 and sum(self._free[i - 1]) == offset:
            offset, prev = self._free.pop(i - 1)
            size += prev
            i -= 1
        self._free.insert(i, (offset, size))
        return size

    def _reap_locked(self, wait: bool) -> None:
        keep = []
        for off, ev in self._parked:
            if ev.query():
                self._release_locked(off)
            elif wait:
                with sync_scope("spill.arenaReuse"):
                    ev.synchronize()
                self._release_locked(off)
            else:
                keep.append((off, ev))
        self._parked = keep

    def alloc(self, size: int) -> Optional[int]:
        """An offset of ``size`` free bytes, or None when the arena cannot
        fit them."""
        need = self._round(size)
        with self._lock:
            self._check_open()
            if need > self.capacity:
                return None
            self._reap_locked(wait=False)
            off = self._take_locked(need)
            if off is None and self._parked:
                self._reap_locked(wait=True)
                off = self._take_locked(need)
            if off is not None:
                self._tensor()
            return off

    def free(self, offset: int, event=None) -> int:
        """Return an extent; with ``event`` (a CUDA event recorded after
        the last copy that touches it) only once the event has completed.
        Returns the bytes freed now (0 for a parked extent)."""
        with self._lock:
            if self._closed:
                return 0
            if event is not None and not event.query():
                self._parked.append((offset, event))
                return 0
            return self._release_locked(offset)

    def view(self, offset: int, size: int) -> torch.Tensor:
        """Writable uint8 view over an allocated extent."""
        with self._lock:
            self._check_open()
            return self._tensor()[offset:offset + size]

    def write(self, offset: int, data: bytes) -> None:
        src = torch.frombuffer(bytearray(data), dtype=torch.uint8)
        self.view(offset, len(data)).copy_(src)

    def read(self, offset: int, size: int) -> bytes:
        return self.view(offset, size).numpy().tobytes()

    @property
    def allocated(self) -> int:
        with self._lock:
            return 0 if self._closed else self._allocated

    @property
    def peak(self) -> int:
        with self._lock:
            return self._peak

    def largest_free(self) -> int:
        with self._lock:
            if self._closed:
                return 0
            return max((s for _o, s in self._free), default=0)

    def close(self) -> None:
        """Release the pool: every parked copy is waited for first."""
        with self._lock:
            if self._closed:
                return
            for _off, ev in self._parked:
                with sync_scope("spill.arenaReuse"):
                    ev.synchronize()
            self._parked = []
            self._closed = True
            self._base = None
            self._used.clear()
            self._free = [(0, self.capacity)]
            self._allocated = 0


class HashedPriorityQueue:
    """Min-priority queue with O(1) membership, for spill ordering
    (reference: HashedPriorityQueue.java): ties pop the smaller id first
    (the older buffer)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._prio: dict = {}

    def push(self, item_id: int, priority: int) -> None:
        with self._lock:
            self._prio[item_id] = priority

    def _min_locked(self) -> Optional[int]:
        if not self._prio:
            return None
        return min(self._prio.items(), key=lambda kv: (kv[1], kv[0]))[0]

    def pop_min(self) -> Optional[int]:
        with self._lock:
            item = self._min_locked()
            if item is not None:
                del self._prio[item]
            return item

    def peek_min(self) -> Optional[int]:
        with self._lock:
            return self._min_locked()

    def remove(self, item_id: int) -> bool:
        with self._lock:
            return self._prio.pop(item_id, None) is not None

    def ordered(self) -> List[int]:
        """Every id, in pop order (a snapshot; the queue is unchanged)."""
        with self._lock:
            return [k for k, _p in sorted(self._prio.items(),
                                          key=lambda kv: (kv[1], kv[0]))]

    def __contains__(self, item_id: int) -> bool:
        with self._lock:
            return item_id in self._prio

    def __len__(self) -> int:
        with self._lock:
            return len(self._prio)

    def close(self) -> None:
        with self._lock:
            self._prio.clear()

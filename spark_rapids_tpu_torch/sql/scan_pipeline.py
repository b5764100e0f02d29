"""Bounded-depth split prefetch on a shared planning thread pool (the
counterpart of the JAX package's ``sql/scan_pipeline.py``).

A file scan has three serial stages per split: host planning (page reads,
decompression, run-table parsing; pyarrow and numpy release the GIL for
most of it), the host-to-device copy, and the device decode and compute.
``ScanPrefetcher`` plans up to ``depth`` splits ahead of the consumer on a
shared daemon pool, so the host planning of row group i+1 overlaps the
device decode of row group i.

Contract (as in the JAX package):

  * partition order is preserved exactly: split i's result is yielded by
    partition i;
  * the first planning exception propagates to the consumer of the
    failing split, and no further splits are submitted after a failure;
  * abandoning a partition generator early cancels every not-yet-started
    split and drops planned-split references, so the pipeline holds no
    buffers after GC;
  * ``depth=0`` is the serial reader: each split is planned on the
    consuming thread when it is pulled.

Backpressure: planned-but-unconsumed splits are host memory; submission
stalls once their bytes exceed ``max_bytes``. The JAX package's journal
events, spans, progress notes and device-budget gate are not ported, nor
its reclaiming of splits a consumer skipped (partitions here are consumed
in order). A wait for a planned split is a host wait, not a device sync,
and is not counted by ``obs/syncledger``.
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from typing import Callable, Iterator, List, Optional

# one planning task per split: () -> a RawRowGroup or a pandas frame
DecodeFn = Callable[[], object]
Partition = Callable[[], Iterator[object]]

DEFAULT_DEPTH = 2
DEFAULT_MAX_BYTES = 256 << 20

_POOL: Optional[ThreadPoolExecutor] = None
_POOL_SIZE = 0
_POOL_LOCK = threading.Lock()


def default_threads() -> int:
    """Planning threads: the JAX package's default (2 to 4, one core left
    for the consumer)."""
    return min(4, max(2, (os.cpu_count() or 2) - 1))


def _nbytes(obj) -> int:
    """Host bytes a planned split retains in the prefetch queue: pandas
    frames by column memory_usage, RawRowGroups by their ``nbytes``."""
    if obj is None:
        return 0
    mu = getattr(obj, "memory_usage", None)
    if mu is not None:
        return int(mu(deep=False).sum())
    return int(getattr(obj, "nbytes", 0) or 0)


def decode_pool(threads: int) -> ThreadPoolExecutor:
    """Shared daemon planning pool. One per process; rebuilt (the old pool
    left to drain) when the thread count changes."""
    global _POOL, _POOL_SIZE
    with _POOL_LOCK:
        if _POOL is None or _POOL_SIZE != threads:
            if _POOL is not None:
                _POOL.shutdown(wait=False)
            _POOL = ThreadPoolExecutor(
                max_workers=threads, thread_name_prefix="srt-scan-decode")
            _POOL_SIZE = threads
        return _POOL


class ScanPrefetcher:
    """Bounded-depth, order-preserving prefetch over one scan's splits.

    ``get(i)`` submits splits ``i .. i+depth`` (so while the consumer
    drains split i, up to ``depth`` later splits plan concurrently), blocks
    on split i's future, and hands the result over; the prefetcher drops
    its own reference so a consumed split is GC-eligible the moment the
    consumer releases it.
    """

    def __init__(self, tasks: List[DecodeFn], depth: int,
                 pool: ThreadPoolExecutor, max_bytes: int):
        self._tasks = tasks
        self._depth = max(1, depth)
        self._pool = pool
        self._max_bytes = max(1, max_bytes)
        self._lock = threading.Lock()
        self._futures: dict = {}          # split index -> Future
        self._submitted: set = set()
        self._cancelled = False
        self._failed = False
        self._pending_bytes = 0           # planned, not yet consumed

    # -- worker side --------------------------------------------------------
    def _decode(self, i: int):
        with self._lock:
            if self._cancelled:
                return None
        out = self._tasks[i]()
        nbytes = _nbytes(out)
        with self._lock:
            if self._cancelled:
                # raced a cancel mid-planning: drop the result so the
                # abandoned work retains no buffers or budget
                return None
            self._pending_bytes += nbytes
        return out

    # -- consumer side ------------------------------------------------------
    def _submit_window_locked(self, i: int) -> None:
        if self._cancelled or self._failed:
            hi = i  # the requested split itself must still plan
        else:
            hi = min(i + self._depth, len(self._tasks) - 1)
        for j in range(i, hi + 1):
            if j in self._submitted:
                continue
            if j > i and self._pending_bytes >= self._max_bytes:
                break
            self._submitted.add(j)
            self._futures[j] = self._pool.submit(self._decode, j)

    def get(self, i: int):
        """Planned split ``i`` (blocking). Re-raises the split's planning
        exception; marks the pipeline failed so no later splits are
        submitted after the first error."""
        with self._lock:
            self._submit_window_locked(i)
            fut = self._futures.pop(i, None)
        if fut is None:
            # split consumed before by another consumer: plan inline
            return self._tasks[i]()
        if not fut.done():
            wait([fut], return_when=FIRST_COMPLETED)
        try:
            out = fut.result()
        except BaseException:
            with self._lock:
                self._failed = True
            raise
        if out is not None:
            with self._lock:
                self._pending_bytes -= _nbytes(out)
        return out

    def cancel(self) -> None:
        """Early consumer exit: cancel unstarted splits and drop every
        retained result. Running planning tasks finish (file reads are
        not interruptible) but their results are discarded."""
        with self._lock:
            self._cancelled = True
            futures = list(self._futures.values())
            self._futures.clear()
            self._pending_bytes = 0
        for f in futures:
            f.cancel()


def build_partitions(tasks: List[DecodeFn], depth: int = DEFAULT_DEPTH,
                     threads: Optional[int] = None) -> List[Partition]:
    """One partition per split. ``depth`` > 0 pulls each split from a
    shared ScanPrefetcher on ``threads`` planning threads; ``depth`` 0 is
    the serial reader, planning on the consuming thread at pull time."""
    if depth <= 0:
        def make_serial(fn: DecodeFn) -> Partition:
            def run():
                yield fn()
            return run
        return [make_serial(fn) for fn in tasks]

    prefetcher = ScanPrefetcher(tasks, depth,
                                decode_pool(threads or default_threads()),
                                DEFAULT_MAX_BYTES)

    def make(i: int) -> Partition:
        def run():
            out = prefetcher.get(i)
            if out is None:  # a cancelled scan re-consumed: plan inline
                out = tasks[i]()
            try:
                yield out
            except BaseException:
                # abandoned mid-yield (GeneratorExit) or a downstream
                # error thrown into the generator: stop feeding the pool
                prefetcher.cancel()
                raise
        return run
    return [make(i) for i in range(len(tasks))]

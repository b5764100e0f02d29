"""Device-buffer leak tracker (counterpart of the JAX package's
``memory/leak.py``, copied).

The reference inherits leak detection from cuDF's Java ``MemoryCleaner``
(strict refcount/AutoCloseable discipline, Arm.scala:1-40); SURVEY.md
section 5 notes this build must supply its own. Every ``SpillableBuffer``
registers here on construction and deregisters on ``close()``; anything
still live at ``report()`` time is a leak candidate. With
``SPARK_RAPIDS_TPU_LEAK_STACKS=1`` each registration also captures its
creation stack so the report points at the allocation site, the way
cudf's leak log does.
"""

from __future__ import annotations

import os
import threading
import time
import traceback
from typing import Dict, List, Optional


class LeakRecord:
    __slots__ = ("buffer_id", "size_bytes", "created_at", "stack", "label")

    def __init__(self, buffer_id: int, size_bytes: int,
                 stack: Optional[str], label: str):
        self.buffer_id = buffer_id
        self.size_bytes = size_bytes
        self.created_at = time.monotonic()
        self.stack = stack
        self.label = label


class LeakTracker:
    """Process-wide registry of live tracked buffers."""

    def __init__(self):
        self._lock = threading.Lock()
        self._live: Dict[int, LeakRecord] = {}
        self._seq = 0
        self._live_bytes = 0
        self._gauges = None  # (liveBuffers, liveBytes), resolved lazily
        self.capture_stacks = (
            os.environ.get("SPARK_RAPIDS_TPU_LEAK_STACKS", "0") == "1")

    def _publish_locked(self) -> None:
        """Mirror the live set into the process-wide registry so the
        observability layer sees leak candidates without calling report()
        (obs/: memory.liveBuffers / memory.liveBytes gauges). Caller holds
        self._lock — publishing under it keeps the gauges ordered with
        the mutations (an unlocked publish could land a stale count last
        and leave phantom leaked bytes on the gauge). The registry lock
        nests inside the tracker lock, never the reverse. Gauge handles
        are resolved once — this runs per buffer alloc/free."""
        if self._gauges is None:
            from spark_rapids_tpu_torch.obs.metrics import REGISTRY
            self._gauges = (REGISTRY.gauge("memory.liveBuffers"),
                            REGISTRY.gauge("memory.liveBytes"))
        self._gauges[0].set(len(self._live))
        self._gauges[1].set(self._live_bytes)

    def register(self, size_bytes: int, label: str = "buffer") -> int:
        stack = None
        if self.capture_stacks:
            stack = "".join(traceback.format_stack(limit=12)[:-1])
        with self._lock:
            self._seq += 1
            token = self._seq
            self._live[token] = LeakRecord(token, size_bytes, stack, label)
            self._live_bytes += size_bytes
            self._publish_locked()
        return token

    def unregister(self, token: int) -> None:
        with self._lock:
            rec = self._live.pop(token, None)
            if rec is not None:
                self._live_bytes -= rec.size_bytes
            self._publish_locked()

    @property
    def live_count(self) -> int:
        with self._lock:
            return len(self._live)

    @property
    def live_bytes(self) -> int:
        with self._lock:
            return self._live_bytes

    def report(self) -> List[str]:
        """Human-readable lines, one per live (leaked) buffer."""
        now = time.monotonic()
        with self._lock:
            recs = sorted(self._live.values(),
                          key=lambda r: r.created_at)
        lines = []
        for r in recs:
            age = now - r.created_at
            line = (f"LEAK {r.label} id={r.buffer_id} "
                    f"size={r.size_bytes}B age={age:.1f}s")
            if r.stack:
                line += "\n" + r.stack
            lines.append(line)
        return lines

    def clear(self) -> None:
        with self._lock:
            self._live.clear()
            self._live_bytes = 0
            self._publish_locked()


TRACKER = LeakTracker()


class assert_no_leaks:
    """Test fixture: fails if the tracked-live set grew across the block
    (the MemoryCleaner-at-shutdown check, usable per test)."""

    def __enter__(self):
        self._before = TRACKER.live_count
        return TRACKER

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            return False
        after = TRACKER.live_count
        if after > self._before:
            report = "\n".join(TRACKER.report())
            raise AssertionError(
                f"buffer leak: {after - self._before} buffer(s) not closed\n"
                + report)
        return False

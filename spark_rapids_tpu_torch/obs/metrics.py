"""Process-wide counters and timers (the counter and timer part of the JAX
package's ``obs/metrics.py``; gauges, histograms and labels wait).

The device Parquet scan reports through ``REGISTRY``:

  * counters ``scan.device.{splits,columns,fallbackColumns,bytesDevice,
    bytesHost,fileReads,fileReadBytes}``: row groups decoded on the device,
    columns decoded there, columns decoded on the host by pyarrow, encoded
    bytes uploaded, host-decoded bytes uploaded, column-chunk file reads
    and their bytes;
  * timers ``scan.device.{prepTime,decodeTime,hostDecodeTime}``: host
    planning, device decode dispatch, host decode of fallback columns.

``registry.counter(name)`` and ``registry.timer(name)`` return the same
object for the same name, creating it on first use. Updates take one lock,
so the scan's planning threads and the consumer can update concurrently.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Tuple, Union


class Counter:
    kind = "counter"

    def __init__(self, name: str, lock: threading.Lock):
        self.name = name
        self._lock = lock
        self._value = 0

    def add(self, n=1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self):
        with self._lock:
            return self._value


class Timer:
    """Accumulated wall seconds; ``with timer.time():`` or
    ``timer.record(seconds)``."""

    kind = "timer"

    def __init__(self, name: str, lock: threading.Lock):
        self.name = name
        self._lock = lock
        self._total = 0.0

    def record(self, seconds: float) -> None:
        with self._lock:
            self._total += seconds

    def time(self) -> "_TimerCtx":
        return _TimerCtx(self)

    @property
    def value(self) -> float:
        with self._lock:
            return self._total


class _TimerCtx:
    __slots__ = ("_timer", "_t0")

    def __init__(self, timer: Timer):
        self._timer = timer

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._timer.record(time.perf_counter() - self._t0)
        return False


Metric = Union[Counter, Timer]


class MetricsRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple[str, str], Metric] = {}

    def _get(self, cls, name: str) -> Metric:
        with self._lock:
            m = self._metrics.get((cls.kind, name))
            if m is None:
                m = cls(name, self._lock)
                self._metrics[(cls.kind, name)] = m
            return m

    def counter(self, name: str) -> Counter:
        return self._get(Counter, name)

    def timer(self, name: str) -> Timer:
        return self._get(Timer, name)

    def values(self) -> Dict[str, float]:
        """{name: value} of every metric (timers: total seconds)."""
        with self._lock:
            metrics = list(self._metrics.values())
        return {m.name: m.value for m in metrics}


def delta(before: Dict[str, float], after: Dict[str, float]
          ) -> Dict[str, float]:
    """The non-zero differences of two ``values()`` snapshots."""
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v - before.get(k, 0)}


REGISTRY = MetricsRegistry()

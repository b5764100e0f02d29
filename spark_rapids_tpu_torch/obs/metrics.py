"""Process-wide counters, gauges and timers with labels (the counter, gauge
and timer part of the JAX package's ``obs/metrics.py``; histograms and the
snapshot export wait for ROADMAP A.11).

The device Parquet scan reports through ``REGISTRY``:

  * counters ``scan.device.{splits,columns,fallbackColumns,bytesDevice,
    bytesHost,fileReads,fileReadBytes}``: row groups decoded on the device,
    columns decoded there, columns decoded on the host by pyarrow, encoded
    bytes uploaded, host-decoded bytes uploaded, column-chunk file reads
    and their bytes;
  * timers ``scan.device.{prepTime,decodeTime,hostDecodeTime}``: host
    planning, device decode dispatch, host decode of fallback columns.

The memory runtime (``memory/``, ``exec/outofcore.py``) reports under the
JAX package's names and labels: counters ``spill.events`` and
``spill.bytes`` by ``direction`` (``device_to_host``, ``host_to_disk``),
``spill.faultBacks`` by ``tier``, ``spill.diskWriteFailures``,
``ooc.operators`` and ``ooc.fanout`` by ``op``; gauges
``memory.liveBuffers``, ``memory.liveBytes``, ``memory.tier.bytes`` and
``memory.tier.buffers`` by ``tier``, ``semaphore.holders``.

``registry.counter(name, **labels)``, ``registry.gauge(...)`` and
``registry.timer(...)`` return the same object for the same name and
labels, creating it on first use; ``registry.value(name, **labels)`` reads
one (0 before its first use). Updates take one lock, so the scan's
planning threads and the consumer can update concurrently. ``values()``
keys an unlabeled metric by its name and a labeled one as
``name{k=v,...}``.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Tuple, Union

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, Any]) -> LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _display(name: str, key: LabelKey) -> str:
    if not key:
        return name
    return name + "{" + ",".join(f"{k}={v}" for k, v in key) + "}"


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


class Gauge:
    """A value set from outside (``set``), e.g. resident bytes."""

    kind = "gauge"

    def __init__(self, name: str, lock: threading.Lock):
        self.name = name
        self._lock = lock
        self._value = 0

    def set(self, v) -> None:
        with self._lock:
            self._value = v

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


Metric = Union[Counter, Gauge, Timer]


class MetricsRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple[str, str, LabelKey], Metric] = {}

    def _get(self, cls, name: str, labels: Dict[str, Any]) -> Metric:
        key = (cls.kind, name, _label_key(labels))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls(name, self._lock)
                self._metrics[key] = m
            return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def timer(self, name: str, **labels) -> Timer:
        return self._get(Timer, name, labels)

    def value(self, name: str, **labels):
        """The value of the counter, gauge or timer ``name`` with exactly
        these labels; 0 where none exists."""
        key = _label_key(labels)
        with self._lock:
            found = [m for (_k, n, lk), m in self._metrics.items()
                     if n == name and lk == key]
        return found[0].value if found else 0

    def values(self) -> Dict[str, float]:
        """{name: value} of every metric (timers: total seconds)."""
        with self._lock:
            items = list(self._metrics.items())
        return {_display(n, lk): m.value for (_k, n, lk), m in items}


def delta(before: Dict[str, float], after: Dict[str, float]
          ) -> Dict[str, float]:
    """The non-zero differences of two ``values()`` snapshots."""
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v - before.get(k, 0)}


REGISTRY = MetricsRegistry()

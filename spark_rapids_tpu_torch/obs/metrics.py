"""Process-wide counters, gauges, timers and histograms with labels
(counterpart of the JAX package's ``obs/metrics.py``).

The device Parquet scan reports through ``REGISTRY``:

  * counters ``scan.device.{splits,columns,fallbackColumns,bytesDevice,
    bytesHost,fileReads,fileReadBytes}``: row groups decoded on the device,
    columns decoded there, columns decoded on the host by pyarrow, encoded
    bytes uploaded, host-decoded bytes uploaded, column-chunk file reads
    and their bytes;
  * timers ``scan.device.{prepTime,decodeTime,hostDecodeTime}``: host
    planning, device decode dispatch, host decode of fallback columns;
  * the prefetch pipeline's ``scan.prefetch.*`` (``sql/scan_pipeline.py``:
    splits, bytesDecoded, budgetStalls, cancelled; timers stallTime and
    decodeTime; gauges queueDepth and queueDepthPeak).

The memory runtime (``memory/``, ``exec/outofcore.py``) reports under the
JAX package's names and labels: counters ``spill.events`` and
``spill.bytes`` by ``direction`` (``device_to_host``, ``host_to_disk``),
``spill.faultBacks`` by ``tier``, ``spill.diskWriteFailures``,
``ooc.operators`` and ``ooc.fanout`` by ``op``; gauges
``memory.liveBuffers``, ``memory.liveBytes``, ``memory.tier.bytes`` and
``memory.tier.buffers`` by ``tier``, ``semaphore.holders``. The host-sync
ledger (``obs/syncledger.py``) adds ``host_syncs`` and ``host_sync.bytes``
by ``site`` and the timer ``host_sync`` by ``site``.

``registry.counter(name, **labels)``, ``gauge``, ``timer`` and
``histogram`` return the same object for the same name and labels,
creating it on first use; ``registry.value(name, **labels)`` reads one (0
before its first use). Updates take one lock, so the scan's planning
threads and the consumer can update concurrently. ``values()`` keys an
unlabeled metric by its name and a labeled one as ``name{k=v,...}``
(timers: total seconds, histograms: count); ``flow_values()`` is the same
without gauges (state, not flow), the per-query snapshot whose
``registry_delta`` the session's profile report publishes; ``snapshot()``
is every metric's full record.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Tuple

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, Any]) -> LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _display(name: str, key: LabelKey) -> str:
    if not key:
        return name
    return name + "{" + ",".join(f"{k}={v}" for k, v in key) + "}"


class Metric:
    """Identity and the owning registry's lock (shared, so a snapshot sees
    a consistent cut across metrics)."""

    kind = "metric"

    def __init__(self, name: str, labels: Dict[str, Any],
                 lock: threading.Lock):
        self.name = name
        self.labels = dict(labels)
        self._lock = lock

    def snapshot(self) -> Dict[str, Any]:
        return {"kind": self.kind, "name": self.name,
                "labels": self.labels, "value": self.value}


class Counter(Metric):
    kind = "counter"

    def __init__(self, name, labels, lock):
        super().__init__(name, labels, lock)
        self._value = 0

    def add(self, n=1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self):
        with self._lock:
            return self._value


class Gauge(Metric):
    """A value set from outside (``set``), e.g. resident bytes."""

    kind = "gauge"

    def __init__(self, name, labels, lock):
        super().__init__(name, labels, lock)
        self._value = 0

    def set(self, v) -> None:
        with self._lock:
            self._value = v

    @property
    def value(self):
        with self._lock:
            return self._value


class Timer(Metric):
    """Accumulated wall seconds with count, min and max; ``with
    timer.time():`` or ``timer.record(seconds)``."""

    kind = "timer"

    def __init__(self, name, labels, lock):
        super().__init__(name, labels, lock)
        self._count = 0
        self._total = 0.0
        self._min = float("inf")
        self._max = 0.0

    def record(self, seconds: float) -> None:
        with self._lock:
            self._count += 1
            self._total += seconds
            if seconds < self._min:
                self._min = seconds
            if seconds > self._max:
                self._max = seconds

    def time(self) -> "_TimerCtx":
        return _TimerCtx(self)

    @property
    def count(self):
        with self._lock:
            return self._count

    @property
    def value(self) -> float:
        with self._lock:
            return self._total

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"kind": self.kind, "name": self.name,
                    "labels": self.labels, "count": self._count,
                    "total_s": self._total,
                    "min_s": self._min if self._count else 0.0,
                    "max_s": self._max, "value": self._total}


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


class Histogram(Metric):
    """Value distribution with exact percentiles over a bounded reservoir.

    Keeps every observation up to ``max_samples``; past that, decimates by
    keeping every other retained sample (doubling the implicit stride), so
    memory stays bounded while the tail quantiles stay representative of
    the smooth distributions it records (span and sync durations)."""

    kind = "histogram"
    max_samples = 8192

    def __init__(self, name, labels, lock):
        super().__init__(name, labels, lock)
        self._samples: List[float] = []
        self._stride = 1
        self._pending = 0
        self._count = 0
        self._total = 0.0

    def observe(self, v: float) -> None:
        with self._lock:
            self._count += 1
            self._total += v
            self._pending += 1
            if self._pending >= self._stride:
                self._pending = 0
                self._samples.append(v)
                if len(self._samples) > self.max_samples:
                    self._samples = self._samples[::2]
                    self._stride *= 2

    @property
    def count(self):
        with self._lock:
            return self._count

    @property
    def value(self):
        with self._lock:
            return self._count

    def percentile(self, p: float) -> float:
        """Exact percentile of the retained reservoir (p in [0, 100])."""
        with self._lock:
            samples = sorted(self._samples)
        if not samples:
            return 0.0
        if len(samples) == 1:
            return samples[0]
        rank = (p / 100.0) * (len(samples) - 1)
        lo = int(rank)
        hi = min(lo + 1, len(samples) - 1)
        frac = rank - lo
        return samples[lo] * (1 - frac) + samples[hi] * frac

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            count, total = self._count, self._total
        return {"kind": self.kind, "name": self.name, "labels": self.labels,
                "count": count, "total": total,
                "p50": self.percentile(50), "p95": self.percentile(95),
                "p99": self.percentile(99), "value": count}


class MetricsRegistry:
    _KINDS = {"counter": Counter, "gauge": Gauge, "timer": Timer,
              "histogram": Histogram}

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple[str, str, LabelKey], Metric] = {}

    def _get(self, kind: str, name: str, labels: Dict[str, Any]) -> Metric:
        key = (kind, name, _label_key(labels))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = self._KINDS[kind](name, labels, self._lock)
                self._metrics[key] = m
            return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get("counter", name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get("gauge", name, labels)

    def timer(self, name: str, **labels) -> Timer:
        return self._get("timer", name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get("histogram", name, labels)

    def metrics(self) -> List[Metric]:
        with self._lock:
            return list(self._metrics.values())

    def snapshot(self) -> List[Dict[str, Any]]:
        return [m.snapshot() for m in self.metrics()]

    def value(self, name: str, **labels):
        """The value of the metric ``name`` with exactly these labels; 0
        where none exists."""
        lk = _label_key(labels)
        with self._lock:
            for kind in self._KINDS:
                m = self._metrics.get((kind, name, lk))
                if m is not None:
                    break
            else:
                return 0
        return m.value

    def values(self) -> Dict[str, float]:
        """{name: value} of every metric (timers: total seconds,
        histograms: count)."""
        return {_display(m.name, _label_key(m.labels)): m.value
                for m in self.metrics()}

    def flow_values(self) -> Dict[str, float]:
        """``values()`` without the gauges: the start/end snapshot pair a
        query's ``registry_delta`` is taken of (a gauge's difference is
        meaningless)."""
        return {_display(m.name, _label_key(m.labels)): m.value
                for m in self.metrics() if m.kind != "gauge"}

    def clear(self) -> None:
        with self._lock:
            self._metrics.clear()


def delta(before: Dict[str, float], after: Dict[str, float]
          ) -> Dict[str, float]:
    """The non-zero differences of two ``values()`` snapshots."""
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v - before.get(k, 0)}


# the JAX package's name: the per-query delta of a ``flow_values()`` pair
registry_delta = delta


REGISTRY = MetricsRegistry()

_BUMP_LOCK = threading.Lock()


def bump(counts: Dict[str, int], key: str, n: int = 1) -> None:
    """``counts[key] += n`` under one process lock: the module-level
    route and branch counters (``ops/aggregate.BRANCHES``,
    ``exec/tpujoin.ROUTES``/``BUILDS``) stay exact when queries run on
    several threads (the serving scheduler's workers)."""
    with _BUMP_LOCK:
        counts[key] = counts.get(key, 0) + n

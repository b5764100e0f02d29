"""Span tracer with Chrome ``trace_event`` JSON export (counterpart of the
JAX package's ``obs/trace.py``).

The reference wraps every operator and memory transition in NVTX ranges
(NvtxWithMetrics.scala:17-44) so Nsight shows where a query's wall time
went; here a process-wide tracer's spans export to the Chrome trace-event
format, viewable in Perfetto (ui.perfetto.dev) or chrome://tracing:

    with TRACER.span("TpuHashAggregateExec", batch_rows=n):
        ...
    TRACER.instant("scan.stall", split=i)
    TRACER.export_chrome("query.trace.json")

Design, as in the JAX package:

  * no hot-path cost when disabled: ``span()`` is one attribute check and
    returns a shared null context (no allocation, no clock read). The
    session enables the tracer per query from ``spark.rapids.tpu.trace.*``;
  * thread-safe: the scan's planning threads and the consumer append under
    one lock; events carry the emitting thread id;
  * span nesting is tracked per thread (``depth``/``parent`` ride the
    event args);
  * a span is host time: CUDA launches are asynchronous, so an operator's
    span measures its dispatch unless ``spark.rapids.sql.profile.syncEachOp``
    syncs after each batch.

The JAX package's ``jaxAnnotations`` passthrough becomes NVTX
(``spark.rapids.tpu.trace.nvtx``): each span also pushes a
``torch.cuda.nvtx`` range, popped on exit (an exception included), so the
spans show in a CUDA profiler's timeline. It needs a card:
``configure(..., nvtx=True)`` raises where CUDA is unavailable.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

_NULL = contextlib.nullcontext()


class Span:
    """One open span, recorded on exit (so a partially entered span never
    reaches the export). Made only by ``Tracer.span``."""

    __slots__ = ("tracer", "name", "args", "_t0", "_nvtx")

    def __init__(self, tracer: "Tracer", name: str, args: Dict[str, Any]):
        self.tracer = tracer
        self.name = name
        self.args = args
        self._nvtx = False

    def set(self, **kw) -> "Span":
        """Attach attributes found mid-span (row counts...)."""
        self.args.update(kw)
        return self

    def __enter__(self) -> "Span":
        tr = self.tracer
        stack = tr._stack()
        self.args["depth"] = len(stack)
        if stack:
            self.args["parent"] = stack[-1].name
        stack.append(self)
        if tr.nvtx:
            from spark_rapids_tpu_torch.shims.loader import shims
            shims().nvtx_push(self.name)
            self._nvtx = True
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        dur = time.perf_counter() - self._t0
        if self._nvtx:
            from spark_rapids_tpu_torch.shims.loader import shims
            shims().nvtx_pop()
        stack = self.tracer._stack()
        if stack and stack[-1] is self:
            stack.pop()
        if exc_type is not None:
            self.args["error"] = exc_type.__name__
        self.tracer._emit(self.name, self._t0, dur, self.args)
        return False


class Tracer:
    """Process-wide event collector. ``enabled`` is the only hot-path
    state."""

    def __init__(self):
        self.enabled = False
        self.nvtx = False
        self._lock = threading.Lock()
        self._events: List[Dict[str, Any]] = []
        self._tls = threading.local()
        self._epoch = time.perf_counter()
        # cap, so a forgotten enabled tracer cannot grow without bound
        # (~100 bytes an event -> ~50 MB at worst)
        self.max_events = 500_000
        self._dropped = 0
        # the flight recorder's mirror (obs/events.py installs it): called
        # with each recorded event while tracing is on
        self.flight_hook = None

    # -- configuration ------------------------------------------------------
    def configure(self, enabled: bool, nvtx: bool = False) -> None:
        """Turn tracing on or off; ``nvtx`` mirrors every span into an
        NVTX range and raises where CUDA is unavailable."""
        if nvtx and enabled:
            import torch
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "spark.rapids.tpu.trace.nvtx needs a CUDA device: NVTX "
                    "ranges go to a CUDA profiler's timeline")
        self.enabled = bool(enabled)
        self.nvtx = bool(nvtx) and self.enabled

    def clear(self) -> None:
        with self._lock:
            self._events = []
            self._dropped = 0
        self._epoch = time.perf_counter()

    # -- recording ----------------------------------------------------------
    def _stack(self) -> List[Span]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def span(self, name: str, **args):
        """Context manager timing a region. Yields the ``Span`` (callers
        may ``sp.set(rows=...)``), or None when tracing is off."""
        if not self.enabled:
            return _NULL
        return Span(self, name, args)

    def instant(self, name: str, **args) -> None:
        """Zero-duration marker event."""
        if not self.enabled:
            return
        stack = self._stack()
        if stack:
            args.setdefault("parent", stack[-1].name)
        self._emit(name, time.perf_counter(), None, args, phase="i")

    def _emit(self, name: str, t0: float, dur: Optional[float],
              args: Dict[str, Any], phase: str = "X") -> None:
        ev = {"name": name, "ph": phase, "pid": os.getpid(),
              "tid": threading.get_ident(),
              "ts": round((t0 - self._epoch) * 1e6, 1),
              "args": args}
        if dur is not None:
            ev["dur"] = round(dur * 1e6, 1)
        if phase == "i":
            ev["s"] = "t"  # instant scope: thread
        with self._lock:
            if len(self._events) >= self.max_events:
                self._dropped += 1
                return
            self._events.append(ev)
        hook = self.flight_hook
        if hook is not None:
            try:
                hook(ev)
            except Exception:  # noqa: BLE001 - observability must not fail
                pass

    @property
    def dropped(self) -> int:
        """Events dropped at the cap (the profile's ``observability``
        section reports them)."""
        with self._lock:
            return self._dropped

    # -- export -------------------------------------------------------------
    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def export_chrome(self, path: Optional[str] = None) -> Dict[str, Any]:
        """Chrome trace-event JSON (object form), written to ``path`` where
        given; always returned."""
        with self._lock:
            events = list(self._events)
            dropped = self._dropped
        doc: Dict[str, Any] = {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {"producer": "spark-rapids-tpu-torch/obs"},
        }
        if dropped:
            doc["otherData"]["droppedEvents"] = dropped
        if path:
            d = os.path.dirname(os.path.abspath(path))
            os.makedirs(d, exist_ok=True)
            with open(path, "w") as f:
                # one C-encoded string, one write (json.dump writes token
                # by token)
                f.write(json.dumps(doc))
        return doc


TRACER = Tracer()

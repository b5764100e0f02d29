"""Host-sync ledger: every point where the host waits for the device, by
site, with its seconds (counterpart of the JAX package's
``obs/syncledger.py``).

Every host wait of the port (``.item()``, ``.cpu()``, a copy from
pageable memory) runs inside ``sync_scope(site, nbytes=...)``:

  * ``SYNCS`` (a ``SyncCounter``) counts every scope and the bytes it
    declared, by site, on entry: the counts the chip smoke and the tests
    gate on;
  * the process-wide ``SYNC_LEDGER`` records one entry per OUTERMOST scope
    of a thread that completed: site, optional detail, wall seconds,
    bytes, the plan operator executing on the thread
    (``obs/compileledger.current_op``), the query (the event journal's
    window), the thread and a sequence number. An inner scope folds its
    bytes into the outer one and records nothing of its own; a scope whose
    body raised records nothing. The ledger is a bounded deque
    (``spark.rapids.tpu.sync.ledger.maxEntries``), on by default
    (``...sync.ledger.enabled``); each entry also advances the
    ``host_syncs``/``host_sync``/``host_sync.bytes`` metrics by site and,
    with the journal on, writes a ``hostSync`` event (at least
    ``...sync.ledger.eventMinSeconds`` long);
  * while tracing, an outermost scope is a ``sync.<site>`` span, the sync
    track ``tools/trace_summary.py`` ranks as the device's idle gaps;
  * ``rollup(entries)`` groups entries by site, ranked by seconds, and
    ``occupancy_pct(sync_s, wall_s)`` is the share of a query's wall not
    blocked on a recorded sync: an estimate, the profile's ``syncs``
    section and the trace summary report it.

The transfer-guard audit (``spark.rapids.tpu.debug.transferGuard``:
``off``, ``log``, ``disallow``) is PyTorch's CUDA sync debug mode
(``warn``, ``error``) around a query's body on a CUDA device
(``guard_context``): every host wait outside a ``sync_scope`` then warns
or raises, since each scope lifts the mode for its body. On a CPU device
the audit has no effect: a CPU tensor never waits for a device.

The debug mode is process-wide while scopes open on several threads (the
query thread, the shuffle server's and the socket transport's): one
count of open scopes, under ``_MODE_LOCK``, lifts the mode when it goes
0 -> 1 and restores the value it had before the first scope when it
goes 1 -> 0, so no thread's exit restores the mode under another
thread's open scope. ``guard_context`` sets and restores the mode through
the same lock (while scopes are open, by changing the value they
restore).
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Any, Dict, List, Optional

import torch

from spark_rapids_tpu_torch.obs import compileledger
from spark_rapids_tpu_torch.obs.events import EVENTS
from spark_rapids_tpu_torch.obs.metrics import REGISTRY
from spark_rapids_tpu_torch.obs.trace import TRACER

DEFAULT_MAX_ENTRIES = 4096
# flight-recorder tail size
DUMP_TAIL = 32

_tls = threading.local()

# the sync debug mode across threads: scopes open in the process, and the
# mode in force before the first of them (restored when the last closes)
_MODE_LOCK = threading.Lock()
_MODE = {"open": 0, "saved": 0}


def _lift_mode() -> None:
    with _MODE_LOCK:
        if _MODE["open"] == 0:
            saved = (torch.cuda.get_sync_debug_mode()
                     if torch.cuda.is_initialized() else 0)
            if saved:
                torch.cuda.set_sync_debug_mode(0)
            _MODE["saved"] = saved
        _MODE["open"] += 1


def _restore_mode() -> None:
    with _MODE_LOCK:
        _MODE["open"] -= 1
        if _MODE["open"] == 0 and _MODE["saved"]:
            torch.cuda.set_sync_debug_mode(_MODE["saved"])
            _MODE["saved"] = 0


class SyncCounter:
    """Counted scopes and declared bytes by site, exact under concurrent
    threads (one lock)."""

    def __init__(self):
        self.syncs: Dict[str, int] = {}
        self.bytes: Dict[str, int] = {}
        self._lock = threading.Lock()

    def add(self, site: str, nbytes: int) -> None:
        with self._lock:
            self.syncs[site] = self.syncs.get(site, 0) + 1
            self.bytes[site] = self.bytes.get(site, 0) + int(nbytes)

    def total(self) -> int:
        with self._lock:
            return sum(self.syncs.values())


SYNCS = SyncCounter()


def _scope_stack() -> List["sync_scope"]:
    st = getattr(_tls, "scopes", None)
    if st is None:
        st = _tls.scopes = []
    return st


class sync_scope:
    """``with sync_scope("batch.fetch", nbytes=n):``: one host wait for
    the device. Counts it in ``counter`` (``SYNCS``), lifts the CUDA sync
    debug mode for the body (so a run under the mode "error" allows the
    counted waits only) and, as the thread's outermost scope, times it
    into the ledger."""

    __slots__ = ("site", "detail", "nbytes", "_counter", "_t0", "_outer",
                 "_trace")

    def __init__(self, site: str, nbytes: int = 0,
                 counter: SyncCounter = SYNCS,
                 detail: Optional[str] = None):
        self.site = site
        self.detail = detail
        self.nbytes = int(nbytes)
        self._counter = counter
        self._trace = None

    def add_bytes(self, n: int) -> "sync_scope":
        """Attach bytes found mid-scope (to the ledger's entry; ``SYNCS``
        counted the bytes declared on entry)."""
        self.nbytes += int(n)
        return self

    def __enter__(self) -> "sync_scope":
        self._counter.add(self.site, self.nbytes)
        st = _scope_stack()
        self._outer = not st
        st.append(self)
        if self._outer and TRACER.enabled:
            self._trace = TRACER.span("sync." + self.site, site=self.site)
            self._trace.__enter__()
        _lift_mode()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        seconds = time.perf_counter() - self._t0
        _restore_mode()
        st = _scope_stack()
        if st and st[-1] is self:
            st.pop()
        if not self._outer:
            # nested under another scope: its seconds cover ours, so only
            # the bytes go up
            if st and self.nbytes:
                st[-1].nbytes += self.nbytes
            return False
        if self._trace is not None:
            if self.nbytes:
                self._trace.set(bytes=self.nbytes)
            self._trace.__exit__(exc_type, exc, tb)
        if exc_type is None:
            SYNC_LEDGER.record(self.site, seconds, nbytes=self.nbytes,
                               detail=self.detail)
        return False


class SyncLedger:
    """Process-wide bounded record of host syncs. Thread-safe."""

    def __init__(self, max_entries: int = DEFAULT_MAX_ENTRIES):
        self._lock = threading.Lock()
        self.enabled = True
        self.event_min_seconds = 0.0
        self._entries: collections.deque = collections.deque(
            maxlen=max(1, max_entries))
        self._seq = 0
        self.total_recorded = 0
        self.total_seconds = 0.0
        self.total_bytes = 0

    # -- configuration ------------------------------------------------------
    def configure(self, enabled: bool = True,
                  max_entries: Optional[int] = None,
                  event_min_seconds: Optional[float] = None) -> None:
        with self._lock:
            self.enabled = bool(enabled)
            if event_min_seconds is not None:
                self.event_min_seconds = float(event_min_seconds)
            if max_entries is not None and \
                    self._entries.maxlen != max(1, int(max_entries)):
                self._entries = collections.deque(
                    self._entries, maxlen=max(1, int(max_entries)))

    def configure_from_conf(self, conf) -> bool:
        self.configure(
            conf.get_bool("spark.rapids.tpu.sync.ledger.enabled", True),
            max_entries=int(conf.get(
                "spark.rapids.tpu.sync.ledger.maxEntries",
                DEFAULT_MAX_ENTRIES)),
            event_min_seconds=float(conf.get(
                "spark.rapids.tpu.sync.ledger.eventMinSeconds", 0.0)))
        return self.enabled

    @property
    def seq(self) -> int:
        with self._lock:
            return self._seq

    # -- recording ----------------------------------------------------------
    def record(self, kind: str, seconds: float, nbytes: int = 0,
               detail: Optional[str] = None) -> Optional[Dict[str, Any]]:
        """One completed sync: the entry, from the thread's operator scope
        and the journal's query window. Never raises."""
        if not self.enabled:
            return None
        try:
            return self._record(kind, seconds, nbytes, detail)
        except Exception:  # noqa: BLE001 - observability must not fail
            return None

    def _record(self, kind: str, seconds: float, nbytes: int,
                detail: Optional[str]) -> Dict[str, Any]:
        cur = compileledger.current_op()
        op = cur[0] if cur is not None else None
        entry: Dict[str, Any] = {
            "ts": round(time.time(), 6),
            "query": EVENTS.current_query,
            "site": kind,
            "op": op,
            "seconds": round(seconds, 6),
            "bytes": int(nbytes),
            "thread": threading.get_ident(),
        }
        if detail:
            entry["detail"] = str(detail)[:200]
        with self._lock:
            self._seq += 1
            entry["seq"] = self._seq
            self._entries.append(entry)
            self.total_recorded += 1
            self.total_seconds += seconds
            self.total_bytes += int(nbytes)
        REGISTRY.counter("host_syncs", site=kind).add(1)
        REGISTRY.timer("host_sync", site=kind).record(seconds)
        if nbytes:
            REGISTRY.counter("host_sync.bytes", site=kind).add(nbytes)
        if EVENTS.enabled and seconds >= self.event_min_seconds:
            EVENTS.emit("hostSync", site=kind,
                        seconds=round(seconds, 6), bytes=int(nbytes),
                        op=(op or "")[:200] or None)
        return entry

    # -- introspection ------------------------------------------------------
    def entries(self, since_seq: int = 0,
                query: Optional[str] = None) -> List[Dict[str, Any]]:
        with self._lock:
            out = [dict(e) for e in self._entries if e["seq"] > since_seq]
        if query is not None:
            out = [e for e in out if e.get("query") == query]
        return out

    def tail(self, n: int = DUMP_TAIL) -> List[Dict[str, Any]]:
        """The newest ``n`` entries, oldest first (flight-recorder
        dumps)."""
        with self._lock:
            return [dict(e) for e in list(self._entries)[-max(1, n):]]

    def query_stats(self, query: str) -> Dict[str, Any]:
        """One query's syncs: count, seconds, bytes, top sites."""
        roll = rollup(self.entries(query=query))
        return {"syncs": roll["count"], "seconds": roll["seconds"],
                "bytes": roll["bytes"], "sites": roll["bySite"][:10]}

    def reset_for_tests(self) -> None:
        with self._lock:
            self._entries.clear()
            self._seq = 0
            self.total_recorded = 0
            self.total_seconds = 0.0
            self.total_bytes = 0
            self.enabled = True
            self.event_min_seconds = 0.0


SYNC_LEDGER = SyncLedger()


def rollup(entries: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Group ledger entries (or ``hostSync`` events) by site: ``{"count",
    "seconds", "bytes", "bySite": [{site, syncs, seconds, bytes, op}]}``,
    sites ranked by seconds; ``op`` is each site's most expensive
    operator (short name)."""
    by_site: Dict[str, Dict[str, Any]] = {}
    total_s = 0.0
    total_b = 0
    for e in entries:
        secs = float(e.get("seconds", 0.0) or 0.0)
        nb = int(e.get("bytes", 0) or 0)
        total_s += secs
        total_b += nb
        site = e.get("site") or "(unattributed)"
        g = by_site.setdefault(site, {"site": site, "syncs": 0,
                                      "seconds": 0.0, "bytes": 0,
                                      "_ops": {}})
        g["syncs"] += 1
        g["seconds"] += secs
        g["bytes"] += nb
        op = e.get("op")
        if op:
            short = op.split("(", 1)[0].strip()
            g["_ops"][short] = g["_ops"].get(short, 0.0) + secs
    out = []
    for g in sorted(by_site.values(), key=lambda g: -g["seconds"]):
        ops = g.pop("_ops")
        g["seconds"] = round(g["seconds"], 6)
        if ops:
            g["op"] = max(ops.items(), key=lambda kv: kv[1])[0]
        out.append(g)
    return {"count": sum(g["syncs"] for g in out),
            "seconds": round(total_s, 6), "bytes": total_b,
            "bySite": out}


def occupancy_pct(sync_seconds: float,
                  wall_s: Optional[float]) -> Optional[float]:
    """The share of a query's wall NOT blocked on a recorded host sync, in
    percent: an estimate (overlapping syncs on two threads count twice,
    and the device may work under a sync). None without a wall."""
    if not wall_s or wall_s <= 0:
        return None
    idle = min(max(sync_seconds, 0.0) / wall_s, 1.0)
    return round(100.0 * (1.0 - idle), 2)


# ---------------------------------------------------------------------------
# Transfer-guard audit
# ---------------------------------------------------------------------------

_DEBUG_MODES = {"log": "warn", "disallow": "error"}
# the audit mode in force ("log", "disallow" or None), as the JAX
# package's guard_mode reports it; the query body's guard_context arms it
_GUARD = {"mode": None}


def set_guard_mode(mode: Optional[str]) -> None:
    """Record the audit mode (``spark.rapids.tpu.debug.transferGuard``):
    "log" or "disallow", anything else None. ``guard_context`` sets it
    for the query body; every ``sync_scope`` lifts the card's sync debug
    mode whatever it is."""
    _GUARD["mode"] = mode if mode in ("log", "disallow") else None


def guard_mode() -> Optional[str]:
    return _GUARD["mode"]


@contextlib.contextmanager
def guard_context(mode: Optional[str], device="cuda"):
    """The query body's transfer guard: on a CUDA ``device``, PyTorch's
    sync debug mode "warn" (``log``) or "error" (``disallow``), restored
    on exit; every ``sync_scope`` lifts it. No effect for ``off``, or on a
    CPU device, where no host wait exists to catch."""
    debug = _DEBUG_MODES.get(mode)
    audit = guard_mode()
    set_guard_mode(mode)
    try:
        if debug is None or torch.device(device).type != "cuda":
            yield
            return
        prev = _set_guard_mode(debug)
        try:
            yield
        finally:
            _set_guard_mode(prev)
    finally:
        set_guard_mode(audit)


def _set_guard_mode(mode):
    """Put ``mode`` in force outside the open scopes and return the one it
    replaces: with no scope open the card's own, else the value the last
    scope to close restores."""
    with _MODE_LOCK:
        if _MODE["open"]:
            prev, _MODE["saved"] = _MODE["saved"], mode
            return prev
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(mode)
        return prev

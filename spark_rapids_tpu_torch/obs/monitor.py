"""Embedded live monitor (counterpart of the JAX package's
``obs/monitor.py``; the headless Spark-UI analogue).

A stdlib ``ThreadingHTTPServer``, off by default
(``spark.rapids.tpu.ui.enabled``): no thread runs and the progress
heartbeats stay off until the session's query-start hook
(``maybe_serve``) turns it on.

Endpoints:

  ``GET /metrics``        the process ``REGISTRY`` in Prometheus text
                          format (``srt_`` prefix, labels kept)
  ``GET /healthz``        ``{"status": "ok", "uptime_s": ...}``
  ``GET /api/status``     the card: ``torch.cuda.get_device_name``,
                          ``mem_get_info``, ``max_memory_allocated``;
                          the session's device budget and metered bytes,
                          the spill catalog's tiers, semaphore permits,
                          the shuffle transport, the scan decode and page
                          cache, the journal's drop counts, the pre-warm
                          pass and the shared compile cache
  ``GET /api/queries``    in-flight and recent queries
  ``GET /api/query/<id>`` one query in full (plan tree with per-operator
                          rows, batches and time so far, AQE stages,
                          scan, shuffle and spill counters, its syncs)
  ``GET /api/tenants``    per-tenant accounting (``tenant.*`` counters)
  ``GET /api/scheduler``  live admission schedulers (``serving/``)
  ``GET /api/fleet``      live fleet routers (``serving/fleet/``), empty
                          when none runs in this process
  ``GET /``               a minimal HTML live view

Signal diagnostics (``install_signal_diagnostics``): on SIGUSR1 the
process dumps every thread's stack, the live queries and the flight
recorder into the journal (``kill -USR1 <pid>``).
"""

from __future__ import annotations

import json
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional
from urllib.parse import unquote, urlparse

from spark_rapids_tpu_torch.obs.progress import PROGRESS

# ---------------------------------------------------------------------------
# Prometheus text exposition
# ---------------------------------------------------------------------------

_PREFIX = "srt_"


def _prom_name(name: str, suffix: str = "") -> str:
    """Sanitize a registry metric name into a Prometheus family name:
    ``shuffle.fetch.rtt`` -> ``srt_shuffle_fetch_rtt``."""
    out = []
    for ch in name:
        out.append(ch if (ch.isalnum() or ch == "_") else "_")
    return _PREFIX + "".join(out) + suffix


def _prom_label_value(v: Any) -> str:
    return (str(v).replace("\\", "\\\\").replace("\"", "\\\"")
            .replace("\n", "\\n"))


def _prom_labels(labels: Dict[str, Any], extra: str = "") -> str:
    parts = [f'{k}="{_prom_label_value(v)}"'
             for k, v in sorted(labels.items())]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _prom_value(v: Any) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    try:
        return repr(float(v))
    except (TypeError, ValueError):
        return "0"


def render_prometheus(registry) -> str:
    """Render a MetricsRegistry in Prometheus text format (one ``# TYPE``
    line per family, samples grouped under it). Timers expose
    ``_seconds_total`` + ``_calls_total`` counters; histograms expose a
    summary (p50/p95/p99 quantiles, ``_sum``, ``_count``)."""
    families: Dict[str, Dict[str, Any]] = {}

    def add(fam: str, ftype: str, line: str) -> None:
        f = families.setdefault(fam, {"type": ftype, "samples": []})
        f["samples"].append(line)

    for m in registry.metrics():
        snap = m.snapshot()
        labels = snap.get("labels") or {}
        if m.kind == "counter":
            fam = _prom_name(m.name, "_total")
            add(fam, "counter",
                f"{fam}{_prom_labels(labels)} {_prom_value(snap['value'])}")
        elif m.kind == "gauge":
            fam = _prom_name(m.name)
            add(fam, "gauge",
                f"{fam}{_prom_labels(labels)} {_prom_value(snap['value'])}")
        elif m.kind == "timer":
            fam = _prom_name(m.name, "_seconds_total")
            add(fam, "counter",
                f"{fam}{_prom_labels(labels)} "
                f"{_prom_value(snap['total_s'])}")
            fam2 = _prom_name(m.name, "_calls_total")
            add(fam2, "counter",
                f"{fam2}{_prom_labels(labels)} "
                f"{_prom_value(snap['count'])}")
        elif m.kind == "histogram":
            fam = _prom_name(m.name)
            for q, key in (("0.5", "p50"), ("0.95", "p95"),
                           ("0.99", "p99")):
                extra = 'quantile="%s"' % q
                add(fam, "summary",
                    f"{fam}{_prom_labels(labels, extra)} "
                    f"{_prom_value(snap[key])}")
            add(fam, "summary",
                f"{fam}_sum{_prom_labels(labels)} "
                f"{_prom_value(snap['total'])}")
            add(fam, "summary",
                f"{fam}_count{_prom_labels(labels)} "
                f"{_prom_value(snap['count'])}")
    lines: List[str] = []
    for fam in sorted(families):
        f = families[fam]
        lines.append(f"# TYPE {fam} {f['type']}")
        lines.extend(f["samples"])
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# Status / tenants snapshots
# ---------------------------------------------------------------------------

def _device_info(device) -> Dict[str, Any]:
    """The card a session runs on: name, free and total memory, the
    allocator's peak; a CPU device is named and nothing more."""
    import torch
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"platform": dev.type, "name": dev.type}
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    free, total = torch.cuda.mem_get_info(idx)
    return {"platform": "gpu", "name": torch.cuda.get_device_name(idx),
            "index": idx, "count": torch.cuda.device_count(),
            "freeBytes": int(free), "totalBytes": int(total),
            "allocatedBytes": int(torch.cuda.memory_allocated(idx)),
            "maxAllocatedBytes": int(torch.cuda.max_memory_allocated(idx)),
            "reservedBytes": int(torch.cuda.memory_reserved(idx))}


def status_snapshot() -> Dict[str, Any]:
    from spark_rapids_tpu_torch.obs.events import EVENTS
    from spark_rapids_tpu_torch.obs.metrics import REGISTRY
    out: Dict[str, Any] = {
        "status": "ok", "time": round(time.time(), 3),
        "inflightQueries": sum(PROGRESS.inflight_by_tenant().values()),
        "eventLog": {
            "enabled": EVENTS.enabled, "path": EVENTS.path,
            "dropped": EVENTS.dropped, "rotations": EVENTS.rotations,
            "rotateFailures": EVENTS.rotate_failures,
        },
    }
    # session state resolved per request: the monitor outlives sessions
    # and must not pin one
    from spark_rapids_tpu_torch.session import TpuSparkSession
    s = TpuSparkSession._active
    if s is not None:
        dm = s.device_manager
        out["device"] = _device_info(s.device)
        cat = s.buffer_catalog
        out["memory"] = {
            "deviceTotalBytes": dm.hbm_total,
            "budgetBytes": dm.hbm_budget,
            "meteredBytes": dm.allocated,
            "peakMeteredBytes": dm.peak,
            "deviceStoreBytes": cat.device_store.total_size,
            "hostStoreBytes": cat.host_store.total_size,
            "diskStoreBytes": cat.disk_store.total_size,
        }
        sem = s.semaphore
        if sem is not None:
            out["semaphore"] = {"permits": sem.permits,
                                "available": sem.available_permits()}
        # the shuffle data plane: the manager's transport and the socket
        # peers' wire counters (srt_shuffle_transport_*)
        peers: Dict[str, Dict[str, Any]] = {}
        for m in REGISTRY.metrics():
            if m.name.startswith("shuffle.transport."):
                peer = m.labels.get("peer")
                if peer is None:
                    continue
                rec = peers.setdefault(peer, {})
                if m.kind == "histogram":
                    rec["rtt_p50_s"] = round(m.percentile(50), 6)
                    rec["rtt_p99_s"] = round(m.percentile(99), 6)
                    rec["requests_timed"] = m.count
                else:
                    key = m.name.rsplit(".", 1)[-1]
                    d = m.labels.get("direction") or m.labels.get("kind")
                    k = f"{key}_{d}" if d else key
                    rec[k] = rec.get(k, 0) + m.value
        out["shuffleTransport"] = {
            "managerEnabled": bool(s.conf.get_bool(
                "spark.rapids.shuffle.transport.enabled", False)),
            "transportClass": str(s.conf.get(
                "spark.rapids.shuffle.transport.class", "inprocess")),
            "socketPeers": peers,
        }
        # the device Parquet decode and the encoded-page cache
        scan_dev: Dict[str, Any] = {}
        page: Dict[str, Any] = {}
        for m in REGISTRY.metrics():
            if m.name.startswith("scan.device."):
                v = m.value
                scan_dev[m.name.split("scan.device.", 1)[1]] = \
                    round(v, 6) if isinstance(v, float) else v
            elif m.name.startswith("pagecache."):
                v = m.value
                page[m.name.split("pagecache.", 1)[1]] = \
                    round(v, 6) if isinstance(v, float) else v
        if scan_dev or page:
            from spark_rapids_tpu_torch.obs.profile import scan_decode_mode
            out["scanDecode"] = {
                "mode": scan_decode_mode(
                    {f"scan.device.{k}": v for k, v in scan_dev.items()}),
                "device": scan_dev,
                "pageCache": page,
            }
    # the zero-warm-up layer: the pre-warm pass and the shared compile
    # cache (a fleet's "is this worker warm yet?" probe)
    from spark_rapids_tpu_torch.serving import prewarm
    p = prewarm.active()
    if p is not None:
        out["aot"] = p.snapshot()
    from spark_rapids_tpu_torch.obs.compilecache import SHARED
    if SHARED.enabled:
        out["sharedCompileCache"] = SHARED.stats()
    return out


def tenants_snapshot() -> Dict[str, Any]:
    """Aggregate per-tenant accounting from the ``tenant.*`` registry
    counters (written once per query end by the session) plus the live
    in-flight census."""
    from spark_rapids_tpu_torch.obs.metrics import REGISTRY
    tenants: Dict[str, Dict[str, Any]] = {}

    def rec(t: str) -> Dict[str, Any]:
        return tenants.setdefault(t, {
            "queries": 0, "failed": 0, "wall_s": 0.0, "rows": 0,
            "inflight": 0})

    for m in REGISTRY.metrics():
        t = m.labels.get("tenant")
        if t is None or not m.name.startswith("tenant."):
            continue
        d = rec(t)
        if m.name == "tenant.queries":
            d["queries"] += m.value
            if m.labels.get("status") == "failed":
                d["failed"] += m.value
        elif m.name == "tenant.wallSeconds":
            d["wall_s"] = round(d["wall_s"] + m.value, 6)
        elif m.name == "tenant.rowsReturned":
            d["rows"] += m.value
    for t, n in PROGRESS.inflight_by_tenant().items():
        rec(t)["inflight"] = n
    return {"tenants": tenants}


# ---------------------------------------------------------------------------
# HTTP server
# ---------------------------------------------------------------------------

_INDEX_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>spark-rapids-tpu monitor</title>
<style>
 body{font-family:monospace;margin:1.5em;background:#fafafa;color:#222}
 table{border-collapse:collapse}
 td,th{border:1px solid #ccc;padding:3px 8px;text-align:left}
 .running{color:#06c}.failed{color:#c00}.success{color:#080}
 a{color:inherit}
</style></head><body>
<h3>spark-rapids-tpu live monitor</h3>
<p><a href="/metrics">/metrics</a> &middot;
   <a href="/api/status">/api/status</a> &middot;
   <a href="/api/queries">/api/queries</a> &middot;
   <a href="/api/tenants">/api/tenants</a></p>
<table id="q"><tr><th>query</th><th>tenant</th><th>status</th>
<th>wall_s</th><th>beats</th><th>aqe stages</th><th>scan splits</th>
<th>description</th></tr></table>
<script>
async function tick(){
  try{
    const r = await fetch('/api/queries'); const d = await r.json();
    const t = document.getElementById('q');
    while(t.rows.length > 1) t.deleteRow(1);
    for(const q of d.queries){
      // build cells with textContent, never innerHTML: descriptions and
      // error strings are arbitrary text ('<' in a TypeError, markup in
      // a job-group description) and must render inert
      const row = t.insertRow(-1);
      const a = document.createElement('a');
      a.href = '/api/query/' + encodeURIComponent(q.id);
      a.textContent = q.id;
      row.insertCell(-1).appendChild(a);
      row.insertCell(-1).textContent = q.tenant;
      const st = document.createElement('span');
      st.className = q.status; st.textContent = q.status;
      row.insertCell(-1).appendChild(st);
      const aqe = q.aqe ? (q.aqe.stagesMaterialized + '/' +
                           q.aqe.stagesTotal) : '-';
      for(const txt of [q.wall_s, q.heartbeats, aqe,
                        q.scan.splitsDecoded,
                        (q.description || '') +
                        (q.error ? ' [' + q.error + ']' : '')]){
        row.insertCell(-1).textContent = txt;
      }
    }
  }catch(e){}
  setTimeout(tick, 2000);
}
tick();
</script></body></html>
"""


class JsonHandler(BaseHTTPRequestHandler):
    """Shared request-handler base of the live monitor and the fleet
    router's endpoint: quiet logging and text/JSON send helpers."""

    server_version = "spark-rapids-tpu"

    def log_message(self, *args) -> None:  # quiet: no stderr per request
        pass

    def _send(self, code: int, body: str, ctype: str) -> None:
        data = body.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        try:
            self.wfile.write(data)
        except (BrokenPipeError, ConnectionResetError):
            pass

    def _send_json(self, doc: Any, code: int = 200) -> None:
        self._send(code, json.dumps(doc, default=str, indent=1),
                   "application/json")


class BackgroundHttpServer:
    """One ThreadingHTTPServer on a daemon thread. ``port=0`` binds an
    ephemeral port (tests); the bound port is ``self.port``. Shared by
    the live monitor and the fleet router's endpoint."""

    def __init__(self, handler_cls, host: str = "127.0.0.1",
                 port: int = 0, thread_name: str = "tpu-http"):
        self._httpd = ThreadingHTTPServer((host, port), handler_cls)
        self._httpd.daemon_threads = True
        self._httpd._started_ts = time.time()
        self.host, self.port = self._httpd.server_address[:2]
        self._thread: Optional[threading.Thread] = None
        self._thread_name = thread_name

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "BackgroundHttpServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name=self._thread_name,
            daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


class _Handler(JsonHandler):
    server_version = "spark-rapids-tpu-monitor"

    def do_GET(self) -> None:  # noqa: N802 — BaseHTTPRequestHandler API
        path = urlparse(self.path).path
        try:
            if path == "/metrics":
                from spark_rapids_tpu_torch.obs.metrics import REGISTRY
                self._send(200, render_prometheus(REGISTRY),
                           "text/plain; version=0.0.4; charset=utf-8")
            elif path == "/healthz":
                self._send_json({"status": "ok", "uptime_s": round(
                    time.time() - self.server._started_ts, 3)})
            elif path == "/api/status":
                self._send_json(status_snapshot())
            elif path == "/api/queries":
                self._send_json({"queries": PROGRESS.queries(full=False)})
            elif path.startswith("/api/query/"):
                qid = unquote(path[len("/api/query/"):])
                qp = PROGRESS.get(qid)
                if qp is None:
                    self._send_json({"error": f"unknown query {qid!r}"},
                                    404)
                else:
                    doc = qp.snapshot(full=True)
                    # live per-query host-sync counts + top sites
                    # (obs/syncledger.py)
                    from spark_rapids_tpu_torch.obs.syncledger import (
                        SYNC_LEDGER,
                    )
                    sstats = SYNC_LEDGER.query_stats(qid)
                    if sstats["syncs"]:
                        doc["syncStats"] = sstats
                    # per-query decode-mode verdict from the live scan
                    # counters
                    sc = doc.get("scan") or {}
                    dev_c = int(sc.get("deviceColumns", 0) or 0)
                    host_c = int(sc.get("hostColumns", 0) or 0)
                    doc["scanDecodeMode"] = \
                        "device" if dev_c and not host_c else \
                        ("mixed" if dev_c else "host")
                    self._send_json(doc)
            elif path == "/api/tenants":
                self._send_json(tenants_snapshot())
            elif path == "/api/scheduler":
                # live admission-scheduler state (serving/scheduler.py):
                # queue depth, running set, per-tenant quota usage, shed
                # counts; an empty list when no scheduler is running
                from spark_rapids_tpu_torch.serving.scheduler import (
                    snapshot_all,
                )
                self._send_json(snapshot_all())
            elif path == "/api/fleet":
                # live fleet-router state (serving/fleet/router.py):
                # per-replica health, placement map, churn/shed totals.
                # Resolved via sys.modules so the single-process path
                # never imports the fleet package — an empty list when
                # no router runs in this process
                mod = sys.modules.get(
                    "spark_rapids_tpu_torch.serving.fleet.router")
                self._send_json(mod.snapshot_all() if mod is not None
                                else {"fleets": []})
            elif path in ("/", "/index.html"):
                self._send(200, _INDEX_HTML, "text/html; charset=utf-8")
            else:
                self._send_json({"error": f"no route {path}"}, 404)
        except Exception as e:  # noqa: BLE001 — a broken page, not a query
            self._send_json(
                {"error": f"{type(e).__name__}: {e}"[:300]}, 500)


class MonitorServer(BackgroundHttpServer):
    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        super().__init__(_Handler, host, port, thread_name="tpu-ui")
        # the REQUESTED address, so maybe_serve can detect a conf
        # change (the bound self.port differs when port=0)
        self.requested = (host, port)


_LOCK = threading.Lock()
_SERVER: Optional[MonitorServer] = None
# whether the monitor turned the progress tracker on (it turns off only
# what it turned on: a caller's own PROGRESS.configure(True) stands)
_PROGRESS_OWNED = False
# sticky per ADDRESS: one warning, not one per query; a changed
# host/port conf retries automatically
_FAILED_ADDR: Optional[tuple] = None


def maybe_serve(conf) -> Optional[MonitorServer]:
    """Session hook, called at every query start: start the monitor when
    ``spark.rapids.tpu.ui.enabled`` turns on, stop it when it turns off,
    rebind it when ``ui.host``/``ui.port`` change, and keep
    ``PROGRESS.enabled`` in lockstep with it (the port turns progress off
    only where the monitor turned it on). Idempotent and cheap when nothing
    changed (a few conf reads + compares). A bind failure warns ONCE per
    address and stays off (progress heartbeats stay disabled too — no
    tracking without a reader); changing the address or toggling
    ui.enabled retries."""
    global _SERVER, _FAILED_ADDR, _PROGRESS_OWNED
    enabled = conf.get_bool("spark.rapids.tpu.ui.enabled", False)
    recent = conf.get_int("spark.rapids.tpu.ui.recentQueries", 64)
    with _LOCK:
        if not enabled:
            _FAILED_ADDR = None
            if _SERVER is not None:
                _SERVER.stop()
                _SERVER = None
        else:
            host = str(conf.get("spark.rapids.tpu.ui.host", "127.0.0.1"))
            port = conf.get_int("spark.rapids.tpu.ui.port", 4040)
            addr = (host, port)
            if _SERVER is not None and _SERVER.requested != addr:
                # conf moved while enabled: rebind (compared against the
                # REQUESTED address — an ephemeral port=0 request stays
                # satisfied by whatever port it bound)
                _SERVER.stop()
                _SERVER = None
            if _SERVER is None and _FAILED_ADDR != addr:
                try:
                    _SERVER = MonitorServer(host, port).start()
                    _FAILED_ADDR = None
                except OSError as e:
                    _FAILED_ADDR = addr
                    import logging
                    logging.getLogger(__name__).warning(
                        "monitor: could not bind %s:%s (%s); live UI "
                        "disabled for this process (change the address "
                        "or toggle spark.rapids.tpu.ui.enabled to "
                        "retry)", host, port, e)
        if _SERVER is not None:
            PROGRESS.configure(True, recent=recent)
            _PROGRESS_OWNED = True
        elif _PROGRESS_OWNED:
            PROGRESS.configure(False, recent=recent)
            _PROGRESS_OWNED = False
        return _SERVER


def server() -> Optional[MonitorServer]:
    return _SERVER


def stop() -> None:
    global _SERVER, _FAILED_ADDR, _PROGRESS_OWNED
    with _LOCK:
        if _SERVER is not None:
            _SERVER.stop()
            _SERVER = None
        _FAILED_ADDR = None
        owned, _PROGRESS_OWNED = _PROGRESS_OWNED, False
    if owned:
        PROGRESS.configure(False)


# ---------------------------------------------------------------------------
# Signal-triggered diagnostics (SIGUSR1)
# ---------------------------------------------------------------------------

_SIGNAL_INSTALLED = False


def dump_diagnostics(reason: str = "manual") -> Dict[str, Any]:
    """Dump the hung-query triad into the event log: all-thread stack
    traces, current query-progress snapshots, and the flight-recorder
    ring. Returns the ``diagnostics`` event."""
    import sys
    import traceback

    from spark_rapids_tpu_torch.obs.events import EVENTS
    from spark_rapids_tpu_torch.obs.syncledger import SYNC_LEDGER
    names = {t.ident: t.name for t in threading.enumerate()}
    stacks: Dict[str, List[str]] = {}
    for tid, frame in sys._current_frames().items():
        entries = traceback.format_stack(frame)
        stacks[f"{names.get(tid, 'thread')}-{tid}"] = [
            ln.rstrip("\n") for ln in entries[-40:]]
    # the sync ledger's tail answers "what was the last host wait for
    # the device?" for a query hung mid-fetch (the port has no compile
    # ledger: its one compile, the nvcc build, is in the build's events)
    ev = EVENTS.emit("diagnostics", reason=reason, threads=stacks,
                     queries=PROGRESS.queries(full=False),
                     compiles=[], syncs=SYNC_LEDGER.tail())
    EVENTS.dump_flight(reason=f"diagnostics:{reason}")
    return ev


def install_signal_diagnostics() -> bool:
    """Install the SIGUSR1 -> ``dump_diagnostics`` handler (main thread
    only; signal-less platforms and nested installs no-op). An
    embedding application's OWN SIGUSR1 handler is never replaced —
    this engine is a library, and hijacking a host app's signal would
    break it silently. Returns whether the handler is installed."""
    global _SIGNAL_INSTALLED
    if _SIGNAL_INSTALLED:
        return True
    import signal
    if not hasattr(signal, "SIGUSR1"):
        return False
    if threading.current_thread() is not threading.main_thread():
        return False
    current = signal.getsignal(signal.SIGUSR1)
    if current not in (signal.SIG_DFL, signal.SIG_IGN, None):
        return False  # the host application owns this signal

    def _handler(signum, frame):  # noqa: ARG001 — signal API
        # The dump runs on a helper thread, NEVER inline: the handler
        # interrupts the main thread between bytecodes, and the main
        # thread may be holding EventLog._lock (non-reentrant, held
        # across file I/O and gzip rotation) or a QueryProgress lock —
        # an inline EVENTS.emit would deadlock the process this tool
        # exists to debug. Off-thread, the locks release normally and
        # the captured main-thread stack shows where the query actually
        # hangs instead of the handler frame.
        try:
            threading.Thread(target=dump_diagnostics,
                             kwargs={"reason": "SIGUSR1"},
                             name="tpu-diagnostics",
                             daemon=True).start()
        except Exception:  # noqa: BLE001 — a handler must never raise
            pass

    try:
        signal.signal(signal.SIGUSR1, _handler)
    except (ValueError, OSError):
        return False
    _SIGNAL_INSTALLED = True
    return True

"""Fleet worker process: one whole session behind a JSON-lines protocol
(counterpart of the JAX package's ``serving/fleet/worker.py``).

``python -m spark_rapids_tpu_torch.serving.fleet.worker <spec.json>``
boots a ``TpuSparkSession`` on the spec's ``"device"`` (default "cuda")
from the spec's conf (the shared nvcc build directory, the warm
manifest, optionally a pre-warm manifest: ``warmstate.worker_conf``) and
serves requests over stdin/stdout, one JSON object a line. The router
(``router.ProcessWorker``) is its one client.

Requests (each carries ``id``; each reply echoes it):

  ``{"op": "ping"}``            -> ``{"pong": true, "pid", "replica"}``
  ``{"op": "submit", "tenant", "description", "deadline_s",
     "queued_elapsed_s", "want_result", "query": {...}}``
                                -> a reply when the job is terminal:
                                   ``{"status", "error", "wall_s", "rows",
                                   "result"?, "query_id"}``
                                   (``queued_elapsed_s``: the router's
                                   queue time, counted into the deadline)
  ``{"op": "status"}``          -> ``{"status": <monitor status_snapshot>,
                                   "scheduler": <scheduler snapshot>,
                                   "compiles": {"backend", "cacheHits",
                                   "real"}, "prime"}``: ``backend`` and
                                   ``real`` are this process's nvcc runs,
                                   ``cacheHits`` the libraries it found
                                   built (``obs/compilecache.py``)
  ``{"op": "drain", "timeout"}``-> ``{"drained": bool, "queueDepth"}``
  ``{"op": "oracle", "query"}`` -> ``{"result": <split-json frame>}``:
                                   the same query through the CPU
                                   operators (a session of its own with
                                   ``spark.rapids.sql.enabled`` off)
  ``{"op": "exit"}``            -> drains and exits 0.

Query specs (``"query"``):

  ``{"kind": "noop"}``                      a tiny 8-row frame
  ``{"kind": "sleep", "seconds": s}``       sleep, then the tiny frame
  ``{"kind": "suite", "suite": "tpch",
     "query": "q1", "sf": 0.05}``           a query of ``models/tpch``
                                            (or ``"tpcxbb"``); each table
                                            is generated in the worker at
                                            its first use, once per (suite,
                                            sf)

A spec may carry ``primeQueries`` (the router's recent dispatches): the
worker runs them during its boot, before the ready line, and waits for
its pre-warm pass, so a rolling restart's replacement takes its first
traffic warm.

Stdout carries protocol lines only: the real fd 1 is duplicated for the
protocol and fd 1 rebound to stderr before the session boots.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import Any, Callable, Dict, Optional


def _serialize_frame(df) -> Optional[str]:
    if df is None:
        return None
    try:
        return df.to_json(orient="split", double_precision=15)
    except Exception:  # noqa: BLE001 — a reply must always go out
        return None


def deserialize_frame(payload: Optional[str]):
    """The router's inverse of the worker's result serialization."""
    if not payload:
        return None
    import io

    import pandas as pd
    return pd.read_json(io.StringIO(payload), orient="split")


class _LazyTables(dict):
    """A suite's tables as DataFrames of ``session``, each generated at
    its first use (a query reads only its own tables)."""

    def __init__(self, session, gens: Dict[str, Callable], sf: float):
        super().__init__()
        self._session = session
        self._gens = gens
        self._sf = sf
        self._lock = threading.Lock()

    def __missing__(self, name):
        with self._lock:
            if not dict.__contains__(self, name):
                frame = self._gens[name](self._sf)
                self[name] = self._session.create_dataframe(frame)
            return dict.__getitem__(self, name)


class _WorkerServer:
    def __init__(self, spec: Dict[str, Any], out):
        self.spec = spec
        self.replica = str(spec.get("replica", "r0"))
        self.device = str(spec.get("device", "cuda"))
        self.out = out
        self.out_lock = threading.Lock()
        self.prime = {"queries": 0, "failed": 0, "seconds": 0.0}
        self.boot_seconds = 0.0
        self.session = None
        self.sched = None
        self._oracle = None
        self._suites: Dict[tuple, Dict[str, Callable]] = {}
        self._suite_lock = threading.Lock()

    # -- protocol ------------------------------------------------------------
    def reply(self, req_id, doc: Dict[str, Any]) -> None:
        doc = dict(doc, id=req_id)
        with self.out_lock:
            self.out.write(json.dumps(doc, default=str) + "\n")
            self.out.flush()

    # -- boot ----------------------------------------------------------------
    def start(self) -> None:
        t0 = time.perf_counter()
        from spark_rapids_tpu_torch.session import TpuSparkSession
        builder = TpuSparkSession.builder().device(self.device)
        for k, v in (self.spec.get("conf") or {}).items():
            builder = builder.config(k, v)
        self.session = builder.get_or_create()
        self.sched = self.session.serving_scheduler(
            workers=int(self.spec.get("schedulerWorkers", 2)),
            max_queue=int(self.spec["maxQueue"])
            if self.spec.get("maxQueue") else None)
        self._prime()
        self.boot_seconds = round(time.perf_counter() - t0, 3)

    def _prime(self) -> None:
        """Run the spec's ``primeQueries`` before the ready line, then
        wait for the pre-warm pass, so the worker takes traffic warm."""
        queries = self.spec.get("primeQueries") or []
        self.prime = {"queries": 0, "failed": 0, "seconds": 0.0}
        t0 = time.perf_counter()
        for q in queries:
            try:
                out = self.thunk(q)(self.session)
                collect = getattr(out, "collect", None)
                if callable(collect):
                    collect()
                self.prime["queries"] += 1
            except Exception:  # noqa: BLE001 — a stale spec must not block boot
                self.prime["failed"] += 1
        from spark_rapids_tpu_torch.serving import prewarm
        p = prewarm.active()
        if p is not None:
            p.wait_idle(timeout=float(
                self.spec.get("prewarmIdleTimeout", 60.0)))
        self.prime["seconds"] = round(time.perf_counter() - t0, 3)

    # -- queries -------------------------------------------------------------
    def _tiny(self, s):
        import pandas as pd
        return s.create_dataframe(
            pd.DataFrame({"a": list(range(8)), "b": [1.0] * 8}), 2)

    def _suite(self, name: str, sf: float) -> Dict[str, Callable]:
        key = (name, sf)
        with self._suite_lock:
            built = self._suites.get(key)
            if built is not None:
                return built
            if name == "tpch":
                from spark_rapids_tpu_torch.models import tpch as suite
                from spark_rapids_tpu_torch.models.tpch_data import (
                    ALL_TABLES,
                )
                gens = ALL_TABLES
            elif name == "tpcxbb":
                from spark_rapids_tpu_torch.models import tpcxbb as suite
                from spark_rapids_tpu_torch.models.tpcxbb_data import (
                    ALL_TABLES as BB_TABLES,
                )
                gens = {n: (lambda sf_, f=f: f(sf_, None))
                        for n, f in BB_TABLES.items()}
            else:
                raise ValueError(f"unknown suite {name!r}")
            tables = _LazyTables(self.session, gens, sf)
            built = {q: (lambda s, q=q: suite.QUERIES[q](s, tables))
                     for q in suite.QUERIES}
            self._suites[key] = built
            return built

    def thunk(self, query: Dict[str, Any]) -> Callable:
        kind = query.get("kind", "noop")
        if kind == "noop":
            return self._tiny
        if kind == "sleep":
            seconds = float(query.get("seconds", 0.1))

            def _sleep(s):
                time.sleep(seconds)
                return self._tiny(s)
            return _sleep
        if kind == "suite":
            fns = self._suite(str(query["suite"]),
                              float(query.get("sf", 0.05)))
            return fns[str(query["query"])]
        raise ValueError(f"unknown query kind {kind!r}")

    # -- ops -----------------------------------------------------------------
    def op_submit(self, req_id, req: Dict[str, Any]) -> None:
        want_result = bool(req.get("want_result"))
        try:
            fn = self.thunk(req.get("query") or {})
        except Exception as e:  # noqa: BLE001 — reported to the router
            self.reply(req_id, {"status": "failed",
                                "error": f"{type(e).__name__}: {e}"[:300]})
            return
        job = self.sched.submit(
            fn, tenant=str(req.get("tenant", "default")),
            description=str(req.get("description", "")),
            deadline_s=req.get("deadline_s"),
            queued_elapsed_s=float(req.get("queued_elapsed_s", 0.0)))

        def waiter() -> None:
            job.wait()
            doc: Dict[str, Any] = {
                "status": job.status, "error": job.error,
                "wall_s": job.wall_s, "query_id": job.query_id,
                "rows": (len(job.result)
                         if job.result is not None else None),
            }
            if want_result and job.status == "succeeded":
                doc["result"] = _serialize_frame(job.result)
            self.reply(req_id, doc)

        if job.done():  # shed / dead on arrival: reply at once
            waiter()
        else:
            threading.Thread(target=waiter, daemon=True,
                             name=f"fleet-wait-{job.id}").start()

    def op_status(self, req_id) -> None:
        from spark_rapids_tpu_torch.obs.compilecache import compile_counts
        from spark_rapids_tpu_torch.obs.monitor import status_snapshot
        self.reply(req_id, {"replica": self.replica,
                            "status": status_snapshot(),
                            "scheduler": self.sched.snapshot(),
                            "compiles": compile_counts(),
                            "prime": dict(self.prime),
                            "bootSeconds": self.boot_seconds})

    def op_oracle(self, req_id, req: Dict[str, Any]) -> None:
        """The query through the CPU operators, in a session of its own
        (the serving session's conf is not touched while jobs run)."""
        from spark_rapids_tpu_torch.config.conf import TpuConf
        from spark_rapids_tpu_torch.session import DataFrame, TpuSparkSession
        if self._oracle is None:
            # the serving conf (its pre-warm manifest too, which a session
            # without one would cancel), the device path off
            settings = dict(self.session.conf._settings)
            settings["spark.rapids.sql.enabled"] = False
            self._oracle = TpuSparkSession(TpuConf(settings), "cpu")
        df = self.thunk(req.get("query") or {})(self.session)
        out = DataFrame(self._oracle, df._plan).collect()
        self.reply(req_id, {"result": _serialize_frame(out)})

    # -- main loop -----------------------------------------------------------
    def serve(self) -> None:
        self.reply(None, {"ready": True, "replica": self.replica,
                          "pid": os.getpid(),
                          "bootSeconds": self.boot_seconds})
        for line in sys.stdin:
            line = line.strip()
            if not line:
                continue
            try:
                req = json.loads(line)
            except json.JSONDecodeError:
                continue
            req_id = req.get("id")
            op = req.get("op")
            try:
                if op == "exit":
                    break
                if op == "ping":
                    self.reply(req_id, {"pong": True, "pid": os.getpid(),
                                        "replica": self.replica})
                elif op == "submit":
                    self.op_submit(req_id, req)
                elif op == "status":
                    self.op_status(req_id)
                elif op == "drain":
                    ok = self.sched.drain(
                        timeout=float(req.get("timeout", 30.0)))
                    self.reply(req_id, {
                        "drained": ok,
                        "queueDepth": self.sched.queue_depth()})
                elif op == "oracle":
                    self.op_oracle(req_id, req)
                else:
                    self.reply(req_id,
                               {"error": f"unknown op {op!r}"})
            except Exception as e:  # noqa: BLE001 — reported, never fatal
                self.reply(req_id,
                           {"error": f"{type(e).__name__}: {e}"[:300]})
        try:
            self.sched.close(cancel_pending=True, timeout=30.0)
            from spark_rapids_tpu_torch.serving import prewarm
            prewarm.cancel_active()
            self.session.stop()
        except Exception:  # noqa: BLE001 — already exiting
            pass


def main(argv: Optional[list] = None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    if not args:
        print("usage: python -m spark_rapids_tpu_torch.serving.fleet.worker "
              "<spec.json>", file=sys.stderr)
        return 2
    with open(args[0], "r", encoding="utf-8") as f:
        spec = json.load(f)
    # the protocol channel is the ORIGINAL stdout; fd 1 is rebound to
    # stderr so that a stray print can never tear a reply line
    out = os.fdopen(os.dup(1), "w", buffering=1)
    os.dup2(2, 1)
    server = _WorkerServer(spec, out)
    try:
        server.start()
    except Exception as e:  # noqa: BLE001 — a boot failure, reported
        server.reply(None, {"fatal": f"{type(e).__name__}: {e}"[:300]})
        return 1
    server.serve()
    return 0


if __name__ == "__main__":
    sys.exit(main())

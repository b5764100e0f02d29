"""Background pre-warm from a manifest (counterpart of the JAX package's
``serving/prewarm.py``).

The JAX package replays recorded compiles so that a fresh process's first
query finds its executables built. The port's first-launch costs are
others, and eager PyTorch really pays them: the nvcc build (or the load)
of a kernel's library, CUDA's lazy load of its module at the first
launch, and the caching allocator's first segments of the launch's
sizes. A session configured with ``spark.rapids.tpu.compile.aot.manifest``
starts one background thread that pays them before traffic:

  * it loads every library the manifest names (``ops/cudalib.load``,
    building where the build directory lacks it: with a seeded shared
    directory, ``obs/compilecache.py``, none is built);
  * it replays each replayable entry once through its wrapper in
    ``ops/kernels`` on the zero-filled, all-invalid inputs of
    ``utils/argspec.build`` (counted in ``kernels.PREWARM_LAUNCHES``,
    not in the main path's ``LAUNCHES``).

The manifest is the fleet's warm manifest (JSONL, one record per
wrapper's first launch of a signature in some process, appended by
``obs/compilecache.SharedCompileCache.note_launch``), a bare list of such
records, or ``{"entries": [...]}``.

  * **background**: the pass never blocks a query;
  * **cancellable**: ``cancel()`` (and ``session.stop()``) stops it at
    the next entry;
  * **budget-capped**: ``compile.aot.budgetSeconds`` bounds its wall;
    entries left when it is spent stay pending and warm at first use;
  * **honest accounting**: an entry without an argument spec (the decode
    wrappers' descriptor tables, B5-B7) is "skipped", never launched on
    made-up descriptors; warmed, skipped, failed and pending show at
    ``/api/status`` and as ``aot.*`` counters.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any, Dict, List, Optional

_ACTIVE: Optional["AotPrewarmer"] = None
_ACTIVE_LOCK = threading.Lock()


def load_manifest(path: str) -> List[Dict[str, Any]]:
    """The entries of a manifest: ``{"entries": [...]}``, a bare list of
    entry dicts, or JSONL of one entry per line (a torn last line, left by
    a writer that died, is skipped)."""
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        text = f.read()
    try:
        doc = json.loads(text)
    except json.JSONDecodeError:
        entries: List[Dict[str, Any]] = []
        for line in text.splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue  # torn tail from a crashed writer
            if isinstance(rec, dict):
                entries.append(rec)
        if not entries:
            raise ValueError(f"{path}: not an AOT manifest") from None
        return entries
    if isinstance(doc, dict) and "entries" not in doc \
            and ("kernelKey" in doc or "kernel" in doc):
        return [doc]  # a one-record JSONL parses as one dict
    entries = doc.get("entries") if isinstance(doc, dict) else doc
    if not isinstance(entries, list):
        raise ValueError(f"{path}: not an AOT manifest")
    return [e for e in entries if isinstance(e, dict)]


def _entry_key(e: Dict[str, Any]) -> tuple:
    return (e.get("kernelKey") or e.get("kernel"), e.get("fn"),
            json.dumps(e.get("argspec"), sort_keys=True, default=str))


class AotPrewarmer:
    def __init__(self, manifest_path: str, budget_s: float = 120.0,
                 device=None):
        self.manifest_path = manifest_path
        self.budget_s = float(budget_s)
        self.device = device
        self._lock = threading.Lock()
        self._cancel = threading.Event()
        self._done = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.warmed = 0
        self.failed = 0
        self.skipped = 0
        self.seconds = 0.0
        self.budget_exhausted = False
        self.libraries: List[str] = []
        self.libraries_loaded = 0
        self.errors: List[str] = []
        self._pending: List[Dict[str, Any]] = []
        seen = set()
        for e in load_manifest(manifest_path):
            key = _entry_key(e)
            if key[0] is None or key in seen:
                continue
            seen.add(key)
            lib = e.get("library")
            if lib and lib not in self.libraries:
                self.libraries.append(lib)
            if not e.get("argspec") or not e.get("fn"):
                self.skipped += 1
                continue
            self._pending.append(e)

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "AotPrewarmer":
        self._thread = threading.Thread(
            target=self._run, name="srt-aot-prewarm", daemon=True)
        self._thread.start()
        return self

    def cancel(self) -> None:
        self._cancel.set()

    def join(self, timeout: Optional[float] = None) -> None:
        t = self._thread
        if t is not None:
            t.join(timeout)

    def _on_card(self) -> bool:
        import torch
        return self.device is not None \
            and torch.device(self.device).type == "cuda"

    # -- the pass -------------------------------------------------------------
    def _run(self) -> None:
        from spark_rapids_tpu_torch.obs.metrics import REGISTRY
        t_start = time.perf_counter()
        try:
            if self._on_card():
                from spark_rapids_tpu_torch.ops import cudalib
                for lib in self.libraries:
                    if self._cancel.is_set():
                        return
                    try:
                        cudalib.load(lib)
                        with self._lock:
                            self.libraries_loaded += 1
                    except Exception as e:  # noqa: BLE001 — reported
                        with self._lock:
                            self.errors.append(f"{lib}: {e}"[:300])
            while not self._cancel.is_set():
                with self._lock:
                    if not self._pending:
                        return
                    if (self.budget_s > 0 and time.perf_counter()
                            - t_start >= self.budget_s):
                        # spent: what is left warms on first use
                        self.budget_exhausted = True
                        return
                    e = self._pending.pop(0)
                t0 = time.perf_counter()
                ok = self._warm_one(e)
                dt = time.perf_counter() - t0
                with self._lock:
                    self.seconds += dt
                    if ok:
                        self.warmed += 1
                    else:
                        self.failed += 1
                REGISTRY.counter("aot.warmed" if ok else "aot.failed").add(1)
                REGISTRY.timer("aot.seconds").record(dt)
        finally:
            with self._lock:
                self.seconds = max(self.seconds,
                                   time.perf_counter() - t_start)
            self._done.set()

    def _warm_one(self, entry: Dict[str, Any]) -> bool:
        """Launch one recorded wrapper call on rebuilt zero-filled inputs,
        under the ``AotPrewarm`` operator scope, its launch counted apart
        (``kernels.prewarm_launches``)."""
        from spark_rapids_tpu_torch.obs import compileledger
        from spark_rapids_tpu_torch.ops import kernels
        from spark_rapids_tpu_torch.utils import argspec
        try:
            fn = getattr(kernels, str(entry["fn"]))
            args, kwargs = argspec.build(entry["argspec"], self.device)
            with kernels.prewarm_launches(), \
                    compileledger.op_context("AotPrewarm"):
                fn(*args, **kwargs)
            return True
        except Exception as e:  # noqa: BLE001 — a bad entry must not stop the pass
            with self._lock:
                self.errors.append(f"{entry.get('fn')}: "
                                   f"{type(e).__name__}: {e}"[:300])
            return False

    # -- introspection --------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "manifest": self.manifest_path,
                "libraries": list(self.libraries),
                "librariesLoaded": self.libraries_loaded,
                "warmed": self.warmed,
                "failed": self.failed,
                "skipped": self.skipped,
                "pending": len(self._pending),
                "seconds": round(self.seconds, 3),
                "budgetSeconds": self.budget_s,
                "budgetExhausted": self.budget_exhausted,
                "cancelled": self._cancel.is_set(),
                "done": self._done.is_set(),
                "errors": list(self.errors[:8]),
            }

    def wait_idle(self, timeout: float = 30.0) -> bool:
        """Wait until the pass ended (all warmed, the budget spent or
        cancelled)."""
        return self._done.wait(timeout)


def active() -> Optional[AotPrewarmer]:
    return _ACTIVE


def cancel_active() -> None:
    global _ACTIVE
    with _ACTIVE_LOCK:
        p, _ACTIVE = _ACTIVE, None
    if p is not None:
        p.cancel()


def maybe_start_from_conf(conf, device=None) -> Optional[AotPrewarmer]:
    """Session hook: start (once per manifest path) the background pass
    when ``spark.rapids.tpu.compile.aot.manifest`` is set. A path change
    cancels the old pass, and clearing the conf cancels the active one."""
    global _ACTIVE
    path = str(conf.get("spark.rapids.tpu.compile.aot.manifest", "")
               or "")
    if not path:
        cancel_active()
        return None
    with _ACTIVE_LOCK:
        if _ACTIVE is not None and _ACTIVE.manifest_path == path \
                and not _ACTIVE._cancel.is_set():
            return _ACTIVE
        old, _ACTIVE = _ACTIVE, None
        if old is not None:
            old.cancel()
        try:
            p = AotPrewarmer(path, budget_s=float(conf.get(
                "spark.rapids.tpu.compile.aot.budgetSeconds", 120.0)),
                device=device)
        except (OSError, ValueError):
            return None
        _ACTIVE = p
        p.start()
    return p

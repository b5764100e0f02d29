"""The compile cache of the nvcc build (counterpart of the JAX package's
``obs/compilecache.py``).

The JAX package compiles a kernel per shape through XLA and mirrors jax's
persistent-cache events into the registry. The port compiles nothing per
shape: its one compile is ``ops/cudalib.build``, one shared library per
``csrc/*.cu`` named by a hash of its source. This module is that build's
cache and its accounting:

  * ``spark.rapids.tpu.compile.sharedCache.dir`` (a fleet's
    ``<fleet.dir>/compilecache``) becomes the directory the libraries are
    built into and loaded from, in place of the package's own
    ``build/``; each library builds under an ``flock`` of its own
    (``cudalib``), so of two processes one runs nvcc and the other waits
    and loads what it built;
  * the counters keep the JAX package's names, in the process registry:

        compileCache.backendCompiles / backendCompileTime  nvcc runs and
            their seconds
        compileCache.persistentHits / persistentMisses      libraries found
            built in the directory, or not
        compileCache.timeSaved                              the recorded
            build seconds of each library found built
        compileCache.retrievalTime                          ctypes load
            seconds

    and, with the shared directory on, ``sharedCache.hits``/``steals``
    (a steal: a library another process built), ``misses`` and ``writes``
    (records appended to ``<dir>/manifest.jsonl``, one per nvcc run);
    a miss emits ``compileCacheMiss``, an nvcc run ``backendCompile``;
    the profile's ``compileCache`` section is the query's delta of them;
  * the warm manifest (``spark.rapids.tpu.fleet.warmManifest``): each
    kernel wrapper's first launch of a signature in a process appends one
    flock-serialized JSONL record (wrapper, library, the launch's
    replayable argument spec of ``utils/argspec.py`` or None), the input
    of ``serving/prewarm.py``.

Every file touch is best effort: a broken shared volume degrades to the
process's own behavior and never fails a query.
"""

from __future__ import annotations

import hashlib
import json
import os
import socket
import threading
import time
from typing import Any, Dict, Optional


def locked_append(path: str, payload: bytes) -> bool:
    """Append ``payload`` to ``path`` as ONE record: O_APPEND, an
    exclusive flock held across the write, and the write looped to its
    end, so no reader under the lock sees a torn record."""
    try:
        fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
    except OSError:
        return False
    try:
        try:
            import fcntl
            fcntl.flock(fd, fcntl.LOCK_EX)
        except (ImportError, OSError):
            pass  # O_APPEND alone still lands whole small lines
        view = memoryview(payload)
        while view:
            try:
                n = os.write(fd, view)
            except OSError:
                return False  # the record may be torn: readers skip it
            if n <= 0:
                return False
            view = view[n:]
    finally:
        try:
            os.close(fd)  # releases the flock
        except OSError:
            pass
    return True


def _sidecar(lib_path) -> str:
    return str(lib_path) + ".json"


class SharedCompileCache:
    """The nvcc build directory shared by processes, and the accounting of
    the build (module docstring). Thread-safe."""

    VERSION = "srtcc-nvcc-1"

    def __init__(self):
        self._lock = threading.Lock()
        self.enabled = False
        self.directory = ""
        self._manifest_path = ""
        self._ident = (os.getpid(), socket.gethostname())
        # the warm manifest (fleet.warmManifest) and the launch signatures
        # this process has recorded in it
        self.warm_manifest_path = ""
        self._warm_seen: set = set()

    # -- configuration ------------------------------------------------------
    def configure_from_conf(self, conf) -> bool:
        self.configure_warm_manifest(str(conf.get(
            "spark.rapids.tpu.fleet.warmManifest", "") or ""))
        return self.configure(str(conf.get(
            "spark.rapids.tpu.compile.sharedCache.dir", "") or ""))

    def configure_warm_manifest(self, path: str) -> None:
        with self._lock:
            if path != self.warm_manifest_path:
                self.warm_manifest_path = path or ""
                self._warm_seen = set()

    def configure(self, directory: str) -> bool:
        """Point the nvcc build at ``directory`` (empty: back to the
        package's own build directory). Returns whether it is on."""
        from spark_rapids_tpu_torch.ops import cudalib
        with self._lock:
            if not directory:
                if self.enabled:
                    cudalib.set_build_dir(None)
                self.enabled = False
                self.directory = ""
                return False
            if self.enabled and directory == self.directory:
                return True
            try:
                os.makedirs(directory, exist_ok=True)
            except OSError:
                return False
            cudalib.set_build_dir(directory)
            self.directory = directory
            self._manifest_path = os.path.join(directory, "manifest.jsonl")
            self.enabled = True
            return True

    # -- the build's hooks (ops/cudalib.py) ---------------------------------
    def note_found(self, name: str, lib_path) -> None:
        """A library found built in the directory: a persistent hit, with
        the build seconds its sidecar records as saved (a steal where
        another process built it)."""
        from spark_rapids_tpu_torch.obs.metrics import REGISTRY
        REGISTRY.counter("compileCache.persistentHits").add(1)
        rec = None
        try:
            with open(_sidecar(lib_path), "r", encoding="utf-8") as f:
                rec = json.load(f)
        except (OSError, ValueError):
            pass
        if isinstance(rec, dict) and rec.get("seconds") is not None:
            REGISTRY.timer("compileCache.timeSaved").record(
                float(rec["seconds"]))
        if self.enabled:
            stolen = isinstance(rec, dict) and (
                rec.get("pid"), rec.get("host")) != self._ident
            REGISTRY.counter("sharedCache.steals" if stolen
                             else "sharedCache.hits").add(1)

    def note_missing(self, name: str) -> None:
        """A library not built in the directory: an nvcc run follows."""
        from spark_rapids_tpu_torch.obs.events import EVENTS
        from spark_rapids_tpu_torch.obs.metrics import REGISTRY
        REGISTRY.counter("compileCache.persistentMisses").add(1)
        if self.enabled:
            REGISTRY.counter("sharedCache.misses").add(1)
        EVENTS.emit("compileCacheMiss", library=name)

    def note_built(self, name: str, lib_path, seconds: float) -> None:
        """One nvcc run that built ``lib_path``: its counters and event,
        the sidecar recording its seconds and builder, and with the shared
        directory on a manifest record."""
        from spark_rapids_tpu_torch.obs.events import EVENTS
        from spark_rapids_tpu_torch.obs.metrics import REGISTRY
        REGISTRY.counter("compileCache.backendCompiles").add(1)
        REGISTRY.timer("compileCache.backendCompileTime").record(seconds)
        EVENTS.emit("backendCompile", library=name,
                    seconds=round(seconds, 4))
        rec = {"key": os.path.basename(str(lib_path)), "kernel": name,
               "seconds": round(seconds, 4), "pid": self._ident[0],
               "host": self._ident[1], "ts": round(time.time(), 3),
               "version": self.VERSION}
        try:
            tmp = f"{_sidecar(lib_path)}.{os.getpid()}." \
                  f"{threading.get_ident()}.tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(rec, f)
            os.replace(tmp, _sidecar(lib_path))
        except OSError:
            pass
        if self.enabled and locked_append(
                self._manifest_path,
                (json.dumps(rec) + "\n").encode("utf-8")):
            REGISTRY.counter("sharedCache.writes").add(1)

    @staticmethod
    def note_load(seconds: float) -> None:
        from spark_rapids_tpu_torch.obs.metrics import REGISTRY
        REGISTRY.timer("compileCache.retrievalTime").record(seconds)

    # -- the warm manifest --------------------------------------------------
    def note_launch(self, kernel: str, fn: str, library: str,
                    args: Optional[tuple]) -> None:
        """A wrapper's launch: on the first launch of its signature in
        this process, append a replayable record to the warm manifest.
        ``args`` None marks a launch whose arguments cannot be rebuilt
        (descriptor tables): recorded once per wrapper, with no argspec,
        so the pre-warm loads its library and counts it skipped."""
        path = self.warm_manifest_path
        if not path:
            return
        from spark_rapids_tpu_torch.utils import argspec
        spec = None if args is None else argspec.capture(args, {})
        blob = json.dumps(spec, sort_keys=True, default=str)
        key = hashlib.sha1(f"{kernel}|{fn}|{blob}".encode()).hexdigest()[:20]
        with self._lock:
            if key in self._warm_seen:
                return
            self._warm_seen.add(key)
        rec = {"kernel": kernel, "kernelKey": key, "fn": fn,
               "library": library, "argspec": spec,
               "avals": argspec.avals(spec), "op": _current_op(),
               "pid": self._ident[0], "host": self._ident[1],
               "ts": round(time.time(), 3)}
        if locked_append(path, (json.dumps(rec, default=str)
                                + "\n").encode("utf-8")):
            from spark_rapids_tpu_torch.obs.metrics import REGISTRY
            REGISTRY.counter("fleet.warmManifest.writes").add(1)

    # -- introspection ------------------------------------------------------
    def manifest_entries(self) -> Dict[str, Dict[str, Any]]:
        """The manifest's records by key (torn lines skipped)."""
        out: Dict[str, Dict[str, Any]] = {}
        try:
            with open(self._manifest_path, "r", encoding="utf-8",
                      errors="replace") as f:
                for line in f:
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue
                    if isinstance(rec, dict) and "key" in rec:
                        out.setdefault(rec["key"], rec)
        except OSError:
            pass
        return out

    def stats(self) -> Dict[str, Any]:
        from spark_rapids_tpu_torch.obs.metrics import REGISTRY
        out: Dict[str, Any] = {
            "enabled": self.enabled, "dir": self.directory,
            "knownKernels": len(self.manifest_entries())
            if self.enabled else 0}
        for name in ("hits", "misses", "steals", "writes"):
            out[name] = REGISTRY.counter(f"sharedCache.{name}").value
        return out

    def reset_for_tests(self) -> None:
        self.configure("")
        self.configure_warm_manifest("")


def _current_op() -> Optional[str]:
    from spark_rapids_tpu_torch.obs import compileledger
    cur = compileledger.current_op()
    return cur[0] if cur else None


SHARED = SharedCompileCache()


def compile_counts() -> Dict[str, int]:
    """This process's nvcc runs and libraries found built, from the
    registry (the fleet worker's ``compiles``)."""
    from spark_rapids_tpu_torch.obs.metrics import REGISTRY
    nvcc = int(REGISTRY.counter("compileCache.backendCompiles").value)
    return {"backend": nvcc,
            "cacheHits": int(REGISTRY.counter(
                "compileCache.persistentHits").value),
            "real": nvcc}

"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` (Hopper) into
its own shared library with a plain C interface, loaded with ``ctypes``. A
library is named by a hash of its source and the shared ``csrc/*.cuh``
headers, so a changed source rebuilds and an unchanged one is reused.
Builds go to ``spark_rapids_tpu_torch/build/`` at first use, or to the
shared directory ``spark.rapids.tpu.compile.sharedCache.dir`` names
(``obs/compilecache.py``, ``set_build_dir``); ``build()`` compiles every
missing library at once, one ``nvcc`` process per source, all started
together.

Builds are safe across threads and processes: ``load`` and ``build`` run
under one lock of the process, each library is built under an exclusive
``flock`` of ``<library>.lock`` in the build directory (taken in name
order, so two builders never wait on each other in a cycle) and looked
for again once it is held, so of two processes that want one library
only one runs nvcc; nvcc writes a temporary file named by the process
and the thread, renamed into place when it succeeds.

Nothing here runs at import: the CPU tests import every module of the port
on a machine with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD = PKG / "build"
SOURCES = ("compact", "hash_agg", "hash_join", "parquet_decode")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C signatures: name -> {function: (restype, argtypes)}
_SIGNATURES = {
    "compact": {
        "srt_compact_permutation": (_I, [_P, _LL, _P, _P, _P, _P, _P,
                                           _P]),
        "srt_compact_tile_rows": (_I, []),
        "srt_error_string": (ctypes.c_char_p, [_I]),
    },
    "hash_agg": {
        "srt_hash_agg": (_I, [_P, _P]),
        "srt_hash_agg_max_keys": (_I, []),
        "srt_hash_agg_max_jobs": (_I, []),
        "srt_error_string": (ctypes.c_char_p, [_I]),
    },
    "hash_join": {
        "srt_hash_build": (_I, [_P, _I, _I, _P, _P, _P, _I, _P, _P, _P]),
        "srt_hash_probe": (_I, [_P, _P, _P, _P, _I, _I, _P, _I, _P, _P, _P,
                                _P]),
        "srt_hash_join_max_keys": (_I, []),
        "srt_error_string": (ctypes.c_char_p, [_I]),
    },
    "parquet_decode": {
        "srt_hybrid_expand_many": (_I, [_P, _I, _P]),
        "srt_hybrid_expand_max_streams": (_I, []),
        "srt_delta_unpack_many": (_I, [_P, _I, _P, _LL, ctypes.c_ulonglong,
                                       _P]),
        "srt_delta_unpack_max_chunks": (_I, []),
        "srt_delta_unpack_tile_rows": (_I, []),
        "srt_plain_fixed_many": (_I, [_P, _I, _P]),
        "srt_plain_fixed_max_segments": (_I, []),
        "srt_slab_pack": (_I, [_P, _LL, _P, _P, _LL, _I, _P, _P]),
        "srt_error_string": (ctypes.c_char_p, [_I]),
    },
}

_LIBS: Dict[str, ctypes.CDLL] = {}
# the build directory in force (set_build_dir) and the lock that
# serializes this process's loads and builds
_BUILD_DIR = [BUILD]
_LOCK = threading.RLock()
# ptxas's resource report (registers, shared memory, spills) per library
# built by this process
BUILD_LOGS: Dict[str, str] = {}
# the nvcc build cache's counters of this process: libraries compiled
# (misses) and their summed wall seconds, libraries found built (hits)
BUILD_STATS = {"builds": 0, "seconds": 0.0, "hits": 0}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def set_build_dir(path: Optional[str]) -> None:
    """Build into and load from ``path`` (None: the package's own
    ``build/``). Libraries already loaded stay loaded."""
    with _LOCK:
        _BUILD_DIR[0] = Path(path) if path else BUILD


def build_dir() -> Path:
    return _BUILD_DIR[0]


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    # the shared headers too: a changed header rebuilds its includers
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every library of ``names`` not built yet, all in parallel,
    inside a ``kernelcache.build`` tracer span (the JAX package's span
    around a kernel build). Returns wall seconds per library (0.0 where it
    was already built). Raises with nvcc's output if any compile fails."""
    from spark_rapids_tpu_torch.obs.trace import TRACER
    names = list(names)
    with TRACER.span("kernelcache.build", signature=",".join(names)[:160]):
        return _build(names)


# the libraries this process found or built (each counted once)
_RESOLVED: set = set()


def _lock_file(out: Path) -> int:
    """An exclusive flock on ``<library>.lock``, blocking while another
    process builds the library; the fd (closing it unlocks)."""
    import fcntl
    fd = os.open(str(out) + ".lock", os.O_CREAT | os.O_RDWR, 0o644)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
    except OSError:
        os.close(fd)
        raise
    return fd


def _found(name: str, out: Path) -> None:
    from spark_rapids_tpu_torch.obs.compilecache import SHARED
    if name not in _RESOLVED:
        _RESOLVED.add(name)
        BUILD_STATS["hits"] += 1
        SHARED.note_found(name, out)


def _build(names: List[str]) -> Dict[str, float]:
    from spark_rapids_tpu_torch.obs.compilecache import SHARED
    with _LOCK:
        build_dir().mkdir(parents=True, exist_ok=True)
        # name -> (nvcc, temporary output, library, start, lock fd)
        started: Dict[str, Tuple[subprocess.Popen, Path, Path, float,
                                 int]] = {}
        secs = {name: 0.0 for name in names}
        failed = []
        try:
            for name in sorted(secs):
                out = library_path(name)
                if out.exists():
                    _found(name, out)
                    continue
                fd = _lock_file(out)
                if out.exists():  # built by another process meanwhile
                    os.close(fd)
                    _found(name, out)
                    continue
                SHARED.note_missing(name)
                tmp = out.with_name(f"{out.name}.{os.getpid()}."
                                    f"{threading.get_ident()}.tmp")
                cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                       str(CSRC / f"{name}.cu")]
                try:
                    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True)
                except BaseException:
                    os.close(fd)
                    raise
                started[name] = (proc, tmp, out, time.perf_counter(), fd)
            for name, (proc, tmp, out, t0, fd) in started.items():
                log, _ = proc.communicate()
                BUILD_LOGS[name] = log
                if proc.returncode != 0:
                    failed.append(f"nvcc failed for {name}.cu:\n{log}")
                    continue
                os.replace(tmp, out)
                secs[name] = time.perf_counter() - t0
                _RESOLVED.add(name)
                BUILD_STATS["builds"] += 1
                BUILD_STATS["seconds"] += secs[name]
                SHARED.note_built(name, out, secs[name])
        finally:
            for proc, _tmp, _out, _t0, fd in started.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                os.close(fd)
    if failed:
        raise RuntimeError("\n".join(failed))
    return secs


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, building it first if needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = library_path(name)
            if path.exists():
                _found(name, path)
            else:
                build([name])
            t0 = time.perf_counter()
            lib = ctypes.CDLL(str(path))
            for fn, (restype, argtypes) in _SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.restype = restype
                f.argtypes = argtypes
            from spark_rapids_tpu_torch.obs.compilecache import SHARED
            SHARED.note_load(time.perf_counter() - t0)
            _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = lib.srt_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err}: {msg}")

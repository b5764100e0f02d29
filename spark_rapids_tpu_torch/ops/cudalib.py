"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` (Hopper) into
its own shared library with a plain C interface, loaded with ``ctypes``. A
library is named by a hash of its source and the shared ``csrc/*.cuh``
headers, so a changed source rebuilds and an unchanged one is reused.
Builds go to ``spark_rapids_tpu_torch/build/`` at first use; ``build()``
compiles every missing library at once, one ``nvcc`` process per source,
all started together.

Nothing here runs at import: the CPU tests import every module of the port
on a machine with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Tuple

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD = PKG / "build"
SOURCES = ("compact", "hash_agg", "hash_join")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C signatures: name -> {function: (restype, argtypes)}
_SIGNATURES = {
    "compact": {
        "srt_compact_permutation": (_I, [_P, _LL, _P, _P, _P, _P, _P]),
        "srt_compact_tile_rows": (_I, []),
        "srt_error_string": (ctypes.c_char_p, [_I]),
    },
    "hash_agg": {
        "srt_hash_agg": (_I, [_P, _I, _I, _P, _P, _P, _I, _P, _P, _P, _I,
                              _P]),
        "srt_hash_agg_max_keys": (_I, []),
        "srt_error_string": (ctypes.c_char_p, [_I]),
    },
    "hash_join": {
        "srt_hash_build": (_I, [_P, _I, _I, _P, _P, _P, _I, _P, _P, _P]),
        "srt_hash_probe": (_I, [_P, _P, _P, _I, _I, _P, _I, _P, _P]),
        "srt_hash_join_max_keys": (_I, []),
        "srt_error_string": (ctypes.c_char_p, [_I]),
    },
}

_LIBS: Dict[str, ctypes.CDLL] = {}
# ptxas's resource report (registers, shared memory, spills) per library
# built by this process
BUILD_LOGS: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    # the shared headers too: a changed header rebuilds its includers
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every library of ``names`` not built yet, all in parallel.
    Returns wall seconds per library (0.0 where it was already built).
    Raises with nvcc's output if any compile fails."""
    BUILD.mkdir(parents=True, exist_ok=True)
    started: Dict[str, Tuple[subprocess.Popen, Path, Path, float]] = {}
    secs = {name: 0.0 for name in names}
    for name in secs:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        started[name] = (proc, tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in started.items():
        log, _ = proc.communicate()
        BUILD_LOGS[name] = log
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, out)
        secs[name] = time.perf_counter() - t0
    if failed:
        raise RuntimeError("\n".join(failed))
    return secs


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, building it first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        for fn, (restype, argtypes) in _SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.restype = restype
            f.argtypes = argtypes
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = lib.srt_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err}: {msg}")

"""Exclusive-mode device discovery (counterpart of the JAX package's
``memory/discovery.py``).

The reference ships a Spark ``ResourceDiscoveryPlugin`` that probes GPUs
and claims one per executor in PROCESS_EXCLUSIVE mode, so co-located
executors never share a device
(sql-plugin/.../ExclusiveModeGpuDiscoveryPlugin.scala:42+,
GpuDeviceManager.scala:72-96). As in the JAX package, a claim is an
exclusive OS file lock per device ordinal: two executor processes racing
for one card resolve through ``flock``. The ordinals are the CUDA
devices PyTorch sees, ``range(torch.cuda.device_count())``.
"""

from __future__ import annotations

import os
import tempfile
from typing import List, Optional


class DeviceClaim:
    """A held exclusive claim on one local device ordinal."""

    def __init__(self, ordinal: int, lock_path: str, lock_fd: int):
        self.ordinal = ordinal
        self._lock_path = lock_path
        self._lock_fd = lock_fd

    def release(self) -> None:
        if self._lock_fd is not None:
            try:
                os.close(self._lock_fd)
            except OSError:
                pass
            self._lock_fd = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.release()


def _lock_dir() -> str:
    d = os.environ.get("SPARK_RAPIDS_TPU_LOCK_DIR",
                       os.path.join(tempfile.gettempdir(),
                                    "spark-rapids-tpu-locks"))
    os.makedirs(d, exist_ok=True)
    return d


def _try_claim(ordinal: int) -> Optional[DeviceClaim]:
    import fcntl
    path = os.path.join(_lock_dir(), f"device-{ordinal}.lock")
    fd = os.open(path, os.O_CREAT | os.O_RDWR, 0o644)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
    except OSError:
        os.close(fd)
        return None
    os.ftruncate(fd, 0)
    os.write(fd, str(os.getpid()).encode())
    return DeviceClaim(ordinal, path, fd)


def visible_device_ordinals() -> List[int]:
    import torch
    return list(range(torch.cuda.device_count()))


def discover_and_claim(ordinals: Optional[List[int]] = None) -> DeviceClaim:
    """Claim the first unclaimed local device; raises if every device is
    held by another process (the reference's executor init likewise fails
    fast rather than oversubscribing, Plugin.scala:129-136)."""
    if ordinals is None:
        ordinals = visible_device_ordinals()
    for o in ordinals:
        claim = _try_claim(o)
        if claim is not None:
            return claim
    raise RuntimeError(
        f"no unclaimed CUDA device among ordinals {ordinals}; every device "
        "is exclusively held by another executor process")

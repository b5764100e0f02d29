"""The device memory budget (counterpart of the JAX package's
``memory/device.py``; reference: GpuDeviceManager.scala).

PyTorch's caching allocator owns the card's memory; the framework meters
its own columnar buffers against a budget of
``spark.rapids.memory.tpu.allocFraction`` of the device's memory and drives
the spill handlers (``memory/spill.MemoryEventHandler``) when an allocation
passes it: the RMM pool's alloc-failure contract, by metering, never by
allocator callbacks. A ``torch.OutOfMemoryError`` is not caught anywhere.

The budget comes from the card: ``torch.cuda.mem_get_info(device)[1]``
(its total memory) times the fraction, read at the first metered
allocation, so a session that never touches its device never asks for
one; a CUDA session without a card raises there. For ``device="cpu"`` (the
tests' device, which has no such statistic) the JAX package's assumption
of 16 GiB stands in; it is never a fallback from a CUDA request.

Unlike the JAX package's process-wide singleton, each session holds its
own manager (sessions of the port are independent objects, each with its
own confs and catalog). Left out with their callers: the persistent
compile cache switch (ROADMAP A.11) and the mesh's device list (A.9);
per-device peaks are kept by ``torch.device``.
"""

from __future__ import annotations

import threading
import weakref
from typing import Optional

import torch

# the JAX package's assumed memory of a backend without statistics
CPU_ASSUMED_BYTES = 16 << 30


class TpuDeviceManager:
    def __init__(self, conf, device="cuda"):
        self.conf = conf
        self.device = torch.device(device)
        self._hbm_total: Optional[int] = None
        self._hbm_budget: Optional[int] = None
        self._allocated = 0
        self._peak = 0
        self._alloc_lock = threading.Lock()
        self._oom_handlers = []  # callbacks: (needed_bytes) -> freed_bytes
        self._per_device: dict = {}
        self._per_device_peak: dict = {}

    # --- the budget ---------------------------------------------------------
    def _probe_total_bytes(self) -> int:
        if self.device.type == "cuda":
            from spark_rapids_tpu_torch.shims.loader import shims
            return shims().mem_get_info(self.device)[1]
        if self.device.type == "cpu":
            return CPU_ASSUMED_BYTES
        raise ValueError(f"no memory budget for device {self.device}")

    @property
    def hbm_total(self) -> int:
        if self._hbm_total is None:
            self._hbm_total = self._probe_total_bytes()
        return self._hbm_total

    @property
    def hbm_budget(self) -> int:
        if self._hbm_budget is None:
            self._hbm_budget = int(self.hbm_total * self.conf.alloc_fraction)
        return self._hbm_budget

    @hbm_budget.setter
    def hbm_budget(self, value: int) -> None:
        self._hbm_budget = int(value)

    def meter_batch(self, batch) -> None:
        """Meter a transient engine batch against the budget, freed when the
        batch is garbage collected (catalog-registered buffers are metered
        by ``DeviceStore.add_batch`` instead)."""
        size = batch.device_memory_size()
        if size:
            dev = batch.device
            self.track_alloc(size, device=dev)
            weakref.finalize(batch, self.track_free, size, dev)

    # --- budget accounting (the RMM pool + event-handler contract,
    # DeviceMemoryEventHandler.scala:37-93) ----------------------------------
    def register_oom_handler(self, handler) -> None:
        if handler not in self._oom_handlers:
            self._oom_handlers.append(handler)

    def unregister_oom_handler(self, handler) -> None:
        if handler in self._oom_handlers:
            self._oom_handlers.remove(handler)

    def track_alloc(self, nbytes: int, device=None) -> None:
        """Meter a framework allocation; drive the spill handlers
        synchronously while over budget (the reference spills on RMM
        alloc-failure callbacks, RapidsBufferStore.scala:148-188)."""
        budget = self.hbm_budget
        with self._alloc_lock:
            self._allocated += nbytes
            self._peak = max(self._peak, self._allocated)
            if device is not None:
                cur = self._per_device.get(device, 0) + nbytes
                self._per_device[device] = cur
                if cur > self._per_device_peak.get(device, 0):
                    self._per_device_peak[device] = cur
            over = self._allocated - budget
        if over > 0:
            for h in list(self._oom_handlers):
                freed = h(over)
                over -= freed
                if over <= 0:
                    break

    def track_free(self, nbytes: int, device=None) -> None:
        with self._alloc_lock:
            self._allocated -= nbytes
            if device is not None and device in self._per_device:
                self._per_device[device] -= nbytes

    def per_device_peaks(self) -> dict:
        """Snapshot of peak metered bytes per device."""
        with self._alloc_lock:
            return dict(self._per_device_peak)

    def reset_per_device_peaks(self) -> None:
        with self._alloc_lock:
            self._per_device_peak = {d: v for d, v in
                                     self._per_device.items() if v > 0}
            self._peak = self._allocated

    @property
    def allocated(self) -> int:
        return self._allocated

    @property
    def peak(self) -> int:
        """The most bytes metered at once since the last reset."""
        return self._peak

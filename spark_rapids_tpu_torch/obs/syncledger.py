"""Host-sync counter (counterpart of the JAX package's
``obs/syncledger.py``; only ``sync_scope`` is ported).

Every point where the host waits for the device (``.item()``, ``.cpu()``)
runs inside ``sync_scope(site, nbytes=...)``, which counts the sync and the
bytes it moved per site. The counts live on a ``SyncCounter`` object;
``SYNCS`` is the process default.

A run that sets PyTorch's CUDA sync debug mode to "error" makes every
uncounted host wait raise; ``sync_scope`` lifts the mode for its body, so
the counted waits are the only ones such a run allows.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import torch


class SyncCounter:
    def __init__(self):
        self.syncs: Dict[str, int] = {}
        self.bytes: Dict[str, int] = {}

    def add(self, site: str, nbytes: int) -> None:
        self.syncs[site] = self.syncs.get(site, 0) + 1
        self.bytes[site] = self.bytes.get(site, 0) + int(nbytes)

    def total(self) -> int:
        return sum(self.syncs.values())


SYNCS = SyncCounter()


@contextlib.contextmanager
def sync_scope(site: str, nbytes: int = 0, counter: SyncCounter = SYNCS):
    """Count one host sync at ``site`` moving ``nbytes``; the body may wait
    for the device even under the sync debug mode "error"."""
    counter.add(site, nbytes)
    mode = (torch.cuda.get_sync_debug_mode() if torch.cuda.is_initialized()
            else 0)
    if not mode:
        yield
        return
    torch.cuda.set_sync_debug_mode(0)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(mode)

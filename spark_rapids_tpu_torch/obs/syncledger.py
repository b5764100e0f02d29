"""Host-sync counter (counterpart of the JAX package's
``obs/syncledger.py``; only ``sync_scope`` is ported).

Every point where the host waits for the device (``.item()``, ``.cpu()``)
runs inside ``sync_scope(site, nbytes=...)``, which counts the sync and the
bytes it moved per site. The counts live on a ``SyncCounter`` object;
``SYNCS`` is the process default.
"""

from __future__ import annotations

import contextlib
from typing import Dict


class SyncCounter:
    def __init__(self):
        self.syncs: Dict[str, int] = {}
        self.bytes: Dict[str, int] = {}

    def add(self, site: str, nbytes: int) -> None:
        self.syncs[site] = self.syncs.get(site, 0) + 1
        self.bytes[site] = self.bytes.get(site, 0) + int(nbytes)


SYNCS = SyncCounter()


@contextlib.contextmanager
def sync_scope(site: str, nbytes: int = 0, counter: SyncCounter = SYNCS):
    """Count one host sync at ``site`` moving ``nbytes``."""
    counter.add(site, nbytes)
    yield

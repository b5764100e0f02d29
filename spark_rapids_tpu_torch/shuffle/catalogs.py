"""Shuffle buffer catalogs over the spill framework (counterpart of the
JAX package's ``shuffle/catalogs.py``).

reference: ShuffleBufferCatalog / ShuffleReceivedBufferCatalog (~341 LoC)
— thin id-translation layers mapping shuffle block coordinates to
RapidsBufferCatalog ids so shuffle data participates in the spill tiers
(``memory/spill.BufferCatalog``: device -> host arena -> disk).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Tuple

from spark_rapids_tpu_torch.columnar.batch import DeviceBatch
from spark_rapids_tpu_torch.memory.spill import BufferCatalog, SpillPriorities

BlockCoord = Tuple[int, int, int]  # (shuffle_id, map_id, partition_id)


class ShuffleBufferCatalog:
    """Map-side registry: block coordinate -> buffer ids (a map task may
    register several batches per partition)."""

    def __init__(self, catalog: BufferCatalog):
        self.catalog = catalog
        self._blocks: Dict[BlockCoord, List[int]] = {}
        self._lock = threading.Lock()

    def add_batch(self, shuffle_id: int, map_id: int, partition_id: int,
                  batch: DeviceBatch,
                  priority: int = SpillPriorities.OUTPUT_FOR_WRITE) -> int:
        bid = self.catalog.add_batch(batch, priority)
        with self._lock:
            self._blocks.setdefault((shuffle_id, map_id, partition_id),
                                    []).append(bid)
        return bid

    def buffer_ids(self, shuffle_id: int, map_id: int,
                   partition_id: int) -> List[int]:
        with self._lock:
            return list(self._blocks.get((shuffle_id, map_id, partition_id),
                                         []))

    def acquire_batches(self, shuffle_id: int, map_id: int,
                        partition_id: int) -> List[DeviceBatch]:
        return [self.catalog.acquire_batch(b)
                for b in self.buffer_ids(shuffle_id, map_id, partition_id)]

    def remove_shuffle(self, shuffle_id: int) -> None:
        with self._lock:
            doomed = [(k, v) for k, v in self._blocks.items()
                      if k[0] == shuffle_id]
            for k, _ in doomed:
                del self._blocks[k]
        for _, bids in doomed:
            for bid in bids:
                self.catalog.remove(bid)


class ReceivedBufferCatalog:
    """Reduce-side registry for fetched batches (reference:
    ShuffleReceivedBufferCatalog): received data also spills."""

    def __init__(self, catalog: BufferCatalog):
        self.catalog = catalog
        self._received: List[int] = []
        self._lock = threading.Lock()

    def add_batch(self, batch: DeviceBatch) -> int:
        bid = self.catalog.add_batch(
            batch, priority=SpillPriorities.OUTPUT_FOR_READ)
        with self._lock:
            self._received.append(bid)
        return bid

    def acquire_batch(self, bid: int) -> DeviceBatch:
        return self.catalog.acquire_batch(bid)

    def remove_batch(self, bid: int) -> None:
        with self._lock:
            if bid in self._received:
                self._received.remove(bid)
        self.catalog.remove(bid)

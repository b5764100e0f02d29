"""Shuffle manager (counterpart of the JAX package's
``shuffle/manager.py``): caching writer/reader over the catalogs +
transport (reference: RapidsShuffleInternalManagerBase:186-362,
RapidsCachingWriter:74-178, RapidsCachingReader:170,
GpuShuffleEnv.scala:27-136).

``ShuffleEnv`` is the per-executor wiring the reference builds in
GpuShuffleEnv.initStorage: spill-store chain, shuffle catalogs, transport,
server. ``MapStatus`` carries the executor id where the reference smuggles
the UCX port through the BlockManagerId topology field.

The port has no device mesh, so ``select_transport_kind`` never picks
``ICI`` (mode ``ici`` gives LOCAL, as the JAX package's does without a
mesh), and ``mesh_map_output_statistics`` waits for ``shuffle/ici.py``
(ROADMAP A.9).
"""

from __future__ import annotations

import threading
from enum import Enum
from typing import Dict, Iterator, List, Optional, Tuple

from spark_rapids_tpu_torch.columnar.batch import DeviceBatch
from spark_rapids_tpu_torch.memory.spill import BufferCatalog, SpillPriorities
from spark_rapids_tpu_torch.shuffle.catalogs import (
    ReceivedBufferCatalog, ShuffleBufferCatalog,
)
from spark_rapids_tpu_torch.shuffle.client import ShuffleClient
from spark_rapids_tpu_torch.shuffle.server import ShuffleServer
from spark_rapids_tpu_torch.shuffle.transport import (
    BounceBufferManager, ShuffleTransport,
)


class MapStatus:
    """Where a map task's output lives (reference: MapStatus with the
    'rapids=<port>' topology tag, RapidsShuffleInternalManager.scala:157-172
    — here the executor id itself is the address)."""

    def __init__(self, executor_id: str, shuffle_id: int, map_id: int,
                 partition_sizes: List[int]):
        self.executor_id = executor_id
        self.shuffle_id = shuffle_id
        self.map_id = map_id
        self.partition_sizes = partition_sizes


def aggregate_map_statistics(statuses: List[MapStatus]):
    """Fold per-map MapStatus.partition_sizes into MapOutputStatistics
    (sql/adaptive/stats.py) — the aggregation Spark's MapOutputTracker
    performs for AQE (the reference's GpuShuffleExchangeExec reports the
    same shape so Spark can coalesce/demote/split at runtime). Shared by
    the manager path's skew observability and the adaptive executor."""
    from spark_rapids_tpu_torch.sql.adaptive.stats import MapOutputStatistics
    return MapOutputStatistics([list(ms.partition_sizes)
                                for ms in statuses])


class ShuffleTransportKind(Enum):
    """How one exchange EDGE moves its bytes — the per-edge abstraction
    the reference spreads across RapidsShuffleManager wiring
    (GpuShuffleEnv.scala:27-136): UCX for peer links, host fallback
    otherwise. Here the three data planes are:

      * ``LOCAL``   — single-process: collapse concat or in-process
                      bucket materialization (no wire at all);
      * ``MANAGER`` — the catalog + transport shuffle manager
                      (CachingShuffleWriter/Reader over the inprocess or
                      socket wire — the cross-host / DCN path);
      * ``ICI``     — in-slice mesh collective (the JAX package's
                      shuffle/ici.py, not ported: the port has no mesh
                      and never selects it).
    """

    LOCAL = "local"
    MANAGER = "manager"
    ICI = "ici"


def select_transport_kind(conf, session, partitioning_kind: str,
                          n_partitions: int) -> ShuffleTransportKind:
    """Pick the transport for ONE exchange edge (called by
    TpuShuffleExchangeExec.partitions per edge).

    ``spark.rapids.tpu.shuffle.transport.mode`` governs the policy, as in
    the JAX package: 'legacy' (the default) takes the shuffle manager
    where ``spark.rapids.shuffle.transport.enabled`` is set, 'manager'
    forces it, 'auto' also takes it for a multi-executor pool, 'local'
    forces the local routes. The JAX package's mesh comes first in
    'legacy', 'auto' and 'ici'; the port has none, so 'ici' gives LOCAL
    and ICI is never chosen. ``n_partitions`` is the requested count,
    which only a mesh reads."""
    mode = str(conf.get("spark.rapids.tpu.shuffle.transport.mode",
                        "legacy"))
    manager_on = (session is not None and conf.get_bool(
        "spark.rapids.shuffle.transport.enabled", False))
    manager_edge = (session is not None
                    and partitioning_kind in ("hash", "range", "roundrobin"))
    if mode in ("local", "ici") or not manager_edge:
        return ShuffleTransportKind.LOCAL
    if mode == "manager":
        return ShuffleTransportKind.MANAGER
    if mode == "auto":
        # cross-host edges (a configured multi-executor transport pool,
        # the DCN analogue) ride the manager wire; the rest stay local
        multi_exec = int(conf.get("spark.rapids.shuffle.executors", 1)) > 1
        return (ShuffleTransportKind.MANAGER if manager_on or multi_exec
                else ShuffleTransportKind.LOCAL)
    return (ShuffleTransportKind.MANAGER if manager_on
            else ShuffleTransportKind.LOCAL)


def estimate_row_bytes(schema) -> int:
    """Advisory per-row byte width of a schema: exact for fixed-width
    columns (data + validity byte), a flat 16-byte guess for strings
    (offset word + mean chars) — the same cheap estimate class
    sql/adaptive/stats.estimate_frame_bytes applies host-side."""
    import numpy as np
    total = 0
    for dt in schema.dtypes:
        if dt.is_string:
            total += 16
        else:
            total += int(np.dtype(dt.np_dtype).itemsize) + 1
    return max(total, 1)


class ShuffleEnv:
    """Per-executor shuffle environment."""

    def __init__(self, executor_id: str, transport: ShuffleTransport,
                 host_limit_bytes: int = 1 << 30,
                 bounce_buffer_size: int = 1 << 20,
                 bounce_buffer_count: int = 4,
                 disk_dir: Optional[str] = None, device_manager=None,
                 buffer_catalog: Optional[BufferCatalog] = None,
                 device="cuda"):
        self.executor_id = executor_id
        # where this executor's fetched batches land
        self.device = device
        self.transport = transport
        # an engine-integrated env shares the session's catalog so shuffle
        # buffers ride the same spill tiers as everything else
        # (GpuShuffleEnv.scala:51-72); standalone envs build their own
        self._owns_catalog = buffer_catalog is None
        self.buffer_catalog = buffer_catalog if buffer_catalog is not None \
            else BufferCatalog(host_limit_bytes, disk_dir, device_manager,
                               device=device)
        self.shuffle_catalog = ShuffleBufferCatalog(self.buffer_catalog)
        self.received_catalog = ReceivedBufferCatalog(self.buffer_catalog)
        self.bounce = BounceBufferManager(bounce_buffer_size,
                                          bounce_buffer_count)
        self.server = ShuffleServer(executor_id, transport.get_server(),
                                    self.shuffle_catalog, self.bounce)
        self.bounce_buffer_size = bounce_buffer_size
        self._clients: Dict[str, ShuffleClient] = {}
        self._lock = threading.Lock()

    def client_for(self, peer_executor_id: str) -> ShuffleClient:
        with self._lock:
            c = self._clients.get(peer_executor_id)
            if c is None:
                c = ShuffleClient(self.executor_id,
                                  self.transport.make_client(peer_executor_id),
                                  self.received_catalog,
                                  self.bounce_buffer_size,
                                  peer_id=peer_executor_id,
                                  device=self.device)
                self._clients[peer_executor_id] = c
            return c

    def close(self) -> None:
        if self._owns_catalog:
            self.buffer_catalog.close()
        self.transport.shutdown()


class CachingShuffleWriter:
    """Map side: register partitioned device batches in the catalog instead
    of writing files (reference: RapidsCachingWriter.write:74-178)."""

    def __init__(self, env: ShuffleEnv, shuffle_id: int, map_id: int):
        self.env = env
        self.shuffle_id = shuffle_id
        self.map_id = map_id

    def write(self, partition_batches: List[List[DeviceBatch]]) -> MapStatus:
        sizes = []
        for pid, batches in enumerate(partition_batches):
            total = 0
            for b in batches:
                self.env.shuffle_catalog.add_batch(
                    self.shuffle_id, self.map_id, pid, b,
                    priority=SpillPriorities.OUTPUT_FOR_WRITE)
                total += b.device_memory_size()
            sizes.append(total)
        return MapStatus(self.env.executor_id, self.shuffle_id, self.map_id,
                         sizes)


class CachingShuffleReader:
    """Reduce side: local blocks from the catalog, remote blocks fetched
    over the transport (reference: RapidsCachingReader.scala:170 +
    RapidsShuffleIterator.scala:46-341)."""

    def __init__(self, env: ShuffleEnv):
        self.env = env

    def peer_groups(self, map_statuses: List[MapStatus]):
        """[(peer_or_None, [MapStatus, ...])]: local blocks first (peer
        None), then one group per remote peer — the fetch AND retry
        granule (the reference groups per BlockManagerId the same way,
        RapidsCachingReader.scala:170, and registers per-peer fetch
        handlers, RapidsShuffleIterator.scala:46-341)."""
        local: List[MapStatus] = []
        remote: Dict[str, List[MapStatus]] = {}
        for ms in map_statuses:
            if ms.executor_id == self.env.executor_id:
                local.append(ms)
            else:
                remote.setdefault(ms.executor_id, []).append(ms)
        groups: List[Tuple[Optional[str], List[MapStatus]]] = []
        if local:
            groups.append((None, local))
        groups.extend(remote.items())
        return groups

    def read_group(self, shuffle_id: int, partition_id: int,
                   peer: Optional[str],
                   group: List[MapStatus]) -> List[DeviceBatch]:
        """One peer group's blocks (all its maps in ONE metadata/transfer
        round trip). Remote batches are freed from the received catalog
        on acquisition — consumption is final; a retried task re-fetches
        from the map side, which keeps its registered blocks."""
        if peer is None:
            out: List[DeviceBatch] = []
            for ms in group:
                out.extend(self.env.shuffle_catalog.acquire_batches(
                    shuffle_id, ms.map_id, partition_id))
            return out
        client = self.env.client_for(peer)
        blocks = [(shuffle_id, ms.map_id, partition_id) for ms in group]
        batches = []
        for bid in client.fetch_blocks(blocks):
            batches.append(self.env.received_catalog.acquire_batch(bid))
            self.env.received_catalog.remove_batch(bid)
        return batches

    def read_coalesced_group(self, shuffle_id: int,
                             partition_ids: List[int],
                             peer: Optional[str],
                             group: List[MapStatus]) -> List[DeviceBatch]:
        """Coalesced-partition read: ALL of one peer group's blocks for a
        RANGE of reduce partitions in ONE metadata/transfer round trip —
        the shuffle-reader face of AQE partition coalescing (merged
        partitions are fetched as one, not one round trip per merged
        piece)."""
        if peer is None:
            out: List[DeviceBatch] = []
            for ms in group:
                for pid in partition_ids:
                    out.extend(self.env.shuffle_catalog.acquire_batches(
                        shuffle_id, ms.map_id, pid))
            return out
        client = self.env.client_for(peer)
        blocks = [(shuffle_id, ms.map_id, pid)
                  for ms in group for pid in partition_ids]
        batches = []
        for bid in client.fetch_blocks(blocks):
            batches.append(self.env.received_catalog.acquire_batch(bid))
            self.env.received_catalog.remove_batch(bid)
        return batches

    def read_coalesced(self, shuffle_id: int, partition_ids: List[int],
                       map_statuses: List[MapStatus]
                       ) -> Iterator[DeviceBatch]:
        for peer, group in self.peer_groups(map_statuses):
            yield from self.read_coalesced_group(shuffle_id,
                                                 list(partition_ids),
                                                 peer, group)

    def read_partial(self, shuffle_id: int, partition_id: int,
                     map_statuses: List[MapStatus], map_lo: int,
                     map_hi: int) -> Iterator[DeviceBatch]:
        """Ranged read: one reduce partition restricted to map ids
        [map_lo, map_hi) — the reader face of AQE skew splitting (each
        sub-partition of a skewed reduce partition fetches only its map
        range; the sibling ranges are other tasks' reads)."""
        sel = [ms for ms in map_statuses
               if map_lo <= ms.map_id < map_hi]
        return self.read(shuffle_id, partition_id, sel)

    def read(self, shuffle_id: int, partition_id: int,
             map_statuses: List[MapStatus]) -> Iterator[DeviceBatch]:
        for peer, group in self.peer_groups(map_statuses):
            yield from self.read_group(shuffle_id, partition_id, peer,
                                       group)

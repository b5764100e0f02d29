"""Shuffle client fetch state machine (counterpart of the JAX package's
``shuffle/client.py``; reference: RapidsShuffleClient.scala — doFetch:483,
issueBufferReceives:584, BufferReceiveState:111-358).

Fetch of a set of blocks from one peer:

  1. METADATA request -> per-buffer (id, length, tag) triples;
  2. for each buffer: post tagged receives for every bounce-buffer-sized
     chunk, then issue the TRANSFER request that makes the server send;
  3. reassemble chunks, deserialize onto the client's device (an upload
     through pinned memory, no host wait), hand the batch to the receive
     catalog.

Every wait has a timeout. Errors surface as ``ShuffleFetchFailedError``
so the task layer can retry (reference: RapidsShuffleFetchFailedException).
"""

from __future__ import annotations

import struct
import threading
from typing import List, Tuple

from spark_rapids_tpu_torch.obs.events import EVENTS
from spark_rapids_tpu_torch.obs.metrics import REGISTRY
from spark_rapids_tpu_torch.obs.progress import PROGRESS
from spark_rapids_tpu_torch.obs.trace import TRACER
from spark_rapids_tpu_torch.shuffle import wire
from spark_rapids_tpu_torch.shuffle.catalogs import ReceivedBufferCatalog
from spark_rapids_tpu_torch.shuffle.server import (
    META_REQ, META_RESP, TRANSFER_REQ,
)
from spark_rapids_tpu_torch.shuffle.transport import (
    ClientConnection, RequestType, TransactionStatus,
)


class ShuffleFetchFailedError(RuntimeError):
    pass


class ShuffleClient:
    def __init__(self, executor_id: str, connection: ClientConnection,
                 received: ReceivedBufferCatalog, bounce_buffer_size: int,
                 max_bytes_in_flight: int = 128 << 20,
                 peer_id: str = "", device="cuda"):
        self.executor_id = executor_id
        # where fetched batches land (the session's device)
        self.device = device
        self.connection = connection
        self.received = received
        self.bounce_buffer_size = bounce_buffer_size
        # REMOTE peer this client fetches from — trace attribution keys on
        # it (the local executor_id goes on the wire for reply routing)
        self.peer_id = peer_id or getattr(connection, "peer_id", "")
        # inflight-bytes throttle (reference:
        # spark.rapids.shuffle.ucx.maximumBytesInFlight,
        # RapidsConf.scala:532-537 + UCXShuffleTransport's throttle):
        # bounds receive-side staging memory when fetching from many peers
        self.max_bytes_in_flight = max(1, max_bytes_in_flight)
        self._inflight = 0
        self._inflight_cv = threading.Condition()

    def _acquire_inflight(self, nbytes: int) -> None:
        with self._inflight_cv:
            while (self._inflight > 0
                   and self._inflight + nbytes > self.max_bytes_in_flight):
                if not self._inflight_cv.wait(timeout=30):
                    raise ShuffleFetchFailedError(
                        "timed out waiting for inflight-bytes window")
            self._inflight += nbytes

    def _release_inflight(self, nbytes: int) -> None:
        with self._inflight_cv:
            self._inflight -= nbytes
            self._inflight_cv.notify_all()

    def fetch_blocks(self, blocks: List[Tuple[int, int, int]]) -> List[int]:
        """Fetch all batches of the given (shuffle, map, partition) blocks
        from the peer. Returns received-catalog buffer ids. Transactional:
        a mid-fetch failure unregisters the blocks already received, so a
        task-level retry (exec/tpu.py maxFetchRetries) cannot pile up
        duplicate registered copies in the spillable received catalog."""
        import time
        t0 = time.perf_counter()
        with TRACER.span("shuffle.fetch", peer=self.peer_id,
                         blocks=len(blocks)) as sp:
            out: List[int] = []
            total = 0
            try:
                with TRACER.span("shuffle.fetch.meta",
                                 blocks=len(blocks)):
                    metas = self._fetch_metadata(blocks)
                for bid, length, tag in metas:
                    self._acquire_inflight(length)
                    try:
                        with TRACER.span("shuffle.fetch.buffer",
                                         bytes=length):
                            blob = self._receive_buffer(length, tag)
                    finally:
                        self._release_inflight(length)
                    total += length
                    batch = wire.deserialize_batch(blob, self.device)
                    out.append(self.received.add_batch(batch))
            except BaseException as e:
                REGISTRY.counter("shuffle.fetch.failures").add(1)
                if PROGRESS.enabled:
                    PROGRESS.shuffle_failure()
                # durable record of the failure (timeouts included — they
                # surface as ShuffleFetchFailedError messages): the
                # qualification tool's fetch-hotspot input
                EVENTS.emit("fetchFailure", peer=self.peer_id,
                            blocks=len(blocks),
                            error=f"{type(e).__name__}: {e}"[:200])
                for rbid in out:
                    self.received.remove_batch(rbid)
                raise
            if sp is not None:
                sp.set(bytes=total)
        # fetch RTT distribution — the round-5 tail-attribution question
        # (VERDICT) asked of every slow sweep, now always on record
        REGISTRY.histogram("shuffle.fetch.rtt") \
            .observe(time.perf_counter() - t0)
        REGISTRY.counter("shuffle.fetch.count").add(1)
        REGISTRY.counter("shuffle.fetch.bytes").add(total)
        if PROGRESS.enabled:  # live fetch progress (/api/query/<id>)
            PROGRESS.shuffle_fetch(total)
        return out

    def _fetch_metadata(self, blocks) -> List[Tuple[int, int, int]]:
        payload = b"".join(META_REQ.pack(*b) for b in blocks)
        result = {}
        done = threading.Event()

        def cb(txn, resp: bytes):
            result["txn"] = txn
            result["resp"] = resp
            done.set()
        self.connection.request(RequestType.METADATA, payload, cb)
        if not done.wait(30):
            raise ShuffleFetchFailedError("metadata request timed out")
        if result["txn"].status != TransactionStatus.SUCCESS:
            raise ShuffleFetchFailedError(
                f"metadata request failed: {result['txn'].error_message}")
        resp = result["resp"]
        n = len(resp) // META_RESP.size
        return [META_RESP.unpack_from(resp, i * META_RESP.size)
                for i in range(n)]

    def _receive_buffer(self, length: int, tag: int) -> bytes:
        """Post chunk receives, fire the transfer request, reassemble."""
        size = self.bounce_buffer_size
        nchunks = (length + size - 1) // size or 1
        chunks: List[bytearray] = []
        events: List[threading.Event] = []
        txns = []
        for c in range(nchunks):
            clen = min(size, length - c * size) if length else 0
            target = bytearray(clen)
            ev = threading.Event()
            chunks.append(target)
            events.append(ev)
            txns.append(self.connection.receive(
                tag + 1 + c, target, lambda txn, ev=ev: ev.set()))
        peer = self.executor_id.encode("utf-8")
        payload = (struct.pack("<H", len(peer)) + peer
                   + TRANSFER_REQ.pack(0, tag))
        tdone = threading.Event()
        tres = {}

        def tcb(txn, resp):
            tres["txn"] = txn
            tdone.set()
        self.connection.request(RequestType.TRANSFER, payload, tcb)
        if not tdone.wait(30):
            raise ShuffleFetchFailedError("transfer request timed out")
        if tres["txn"].status != TransactionStatus.SUCCESS:
            raise ShuffleFetchFailedError(
                f"transfer failed: {tres['txn'].error_message}")
        for ev, txn in zip(events, txns):
            if not ev.wait(30):
                raise ShuffleFetchFailedError("chunk receive timed out")
            # a completed-but-failed receive (dropped connection) must not
            # pass off partially-filled chunks as data
            if txn.status != TransactionStatus.SUCCESS:
                raise ShuffleFetchFailedError(
                    f"chunk receive failed: {txn.error_message}")
        return b"".join(chunks)

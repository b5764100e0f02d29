"""Shuffle server (counterpart of the JAX package's ``shuffle/server.py``):
answers metadata requests and streams stored buffers through bounce
buffers (reference: RapidsShuffleServer.scala:67-670 — HandleMeta and
BufferSendState).

Metadata protocol (the reference uses FlatBuffers TableMeta/
MetadataResponse; the same self-describing role is played here by a compact
struct-packed header since the wire format already carries the schema):

  request  = packed [(shuffle_id, map_id, partition_id), ...]
  response = packed [(buffer_id, serialized_length, tag), ...]

Buffer transfer: client posts tagged receives sized by the metadata; the
server serializes the (possibly spilled — the catalog faults it back)
buffer and sends it in bounce-buffer-sized tagged chunks. The handlers run
on the transport's thread (the socket transport's connection thread, or
the caller's for the in-process one); each serialization is one counted
``exchange.wire`` wait (``shuffle/wire.py``).
"""

from __future__ import annotations

import struct
import threading
from typing import Dict

from spark_rapids_tpu_torch.obs.metrics import REGISTRY
from spark_rapids_tpu_torch.obs.trace import TRACER
from spark_rapids_tpu_torch.shuffle import wire
from spark_rapids_tpu_torch.shuffle.catalogs import ShuffleBufferCatalog
from spark_rapids_tpu_torch.shuffle.transport import (
    BounceBufferManager, RequestType, ServerConnection,
)

META_REQ = struct.Struct("<III")
META_RESP = struct.Struct("<IQQ")   # buffer_id, length, tag
TRANSFER_REQ = struct.Struct("<IQ")  # buffer_id, tag


def make_tag(executor_num: int, seq: int) -> int:
    """Compose a unique message tag (reference: UCXConnection tag
    composition — peer id in the high bits, sequence in the low)."""
    return (executor_num << 32) | (seq & 0xFFFFFFFF)


class ShuffleServer:
    def __init__(self, executor_id: str, server: ServerConnection,
                 catalog: ShuffleBufferCatalog,
                 bounce: BounceBufferManager):
        self.executor_id = executor_id
        self.server = server
        self.catalog = catalog
        self.bounce = bounce
        self._tag_seq = 0
        self._tag_lock = threading.Lock()
        # tag -> serialized bytes awaiting a TRANSFER request
        self._staged: Dict[int, bytes] = {}
        server.register_request_handler(RequestType.METADATA,
                                        self.handle_metadata)
        server.register_request_handler(RequestType.TRANSFER,
                                        self.handle_transfer)

    def _next_tag(self, nchunks: int) -> int:
        """Reserve a tag range: the base identifies the buffer, and chunk
        sends ride tags base+1..base+nchunks — so the sequence must advance
        by the chunk count, or consecutive buffers' chunk tags collide."""
        with self._tag_lock:
            base = self._tag_seq
            self._tag_seq += nchunks + 1
            return make_tag(abs(hash(self.executor_id)) & 0xFFFF, base)

    def handle_metadata(self, payload: bytes) -> bytes:
        """HandleMeta (RapidsShuffleServer.scala:88-97): resolve the
        requested blocks, serialize each batch now (faulting spilled tiers
        back through the catalog) and stage it under a fresh tag range."""
        n = len(payload) // META_REQ.size
        out = []
        with TRACER.span("shuffle.server.meta", blocks=n):
            for i in range(n):
                sid, mid, pid = META_REQ.unpack_from(payload,
                                                     i * META_REQ.size)
                for bid in self.catalog.buffer_ids(sid, mid, pid):
                    batch = self.catalog.catalog.acquire_batch(bid)
                    blob = wire.serialize_batch(batch)
                    size = self.bounce.buffer_size
                    nchunks = (len(blob) + size - 1) // size or 1
                    tag = self._next_tag(nchunks)
                    with self._tag_lock:
                        self._staged[tag] = blob
                    out.append(META_RESP.pack(bid, len(blob), tag))
        return b"".join(out)

    def handle_transfer(self, payload: bytes) -> bytes:
        """BufferSendState (RapidsShuffleServer.scala:380-520): for each
        requested tag, chunk the staged blob through bounce buffers into
        tagged sends. Sub-chunk tags are tag+1+chunk_index. The payload
        leads with the requesting peer's executor id."""
        (peer_len,) = struct.unpack_from("<H", payload, 0)
        peer_id = payload[2:2 + peer_len].decode("utf-8")
        body = payload[2 + peer_len:]
        n = len(body) // TRANSFER_REQ.size
        with TRACER.span("shuffle.server.transfer", peer=peer_id,
                         buffers=n):
            for i in range(n):
                bid, tag = TRANSFER_REQ.unpack_from(body,
                                                    i * TRANSFER_REQ.size)
                with self._tag_lock:
                    blob = self._staged.pop(tag, None)
                if blob is None:
                    raise RuntimeError(f"transfer for unknown tag {tag}")
                self._send_chunked(peer_id, tag, blob)
                REGISTRY.counter("shuffle.server.bytesSent").add(len(blob))
        return b"ok"

    def _send_chunked(self, peer_id: str, tag: int, blob: bytes) -> None:
        size = self.bounce.buffer_size
        nchunks = (len(blob) + size - 1) // size or 1
        for c in range(nchunks):
            chunk = blob[c * size:(c + 1) * size]
            bb = self.bounce.acquire_buffer()
            try:
                bb.data[:len(chunk)] = chunk
                done = threading.Event()
                self.server.send(peer_id, tag + 1 + c,
                                 bytes(bb.data[:len(chunk)]),
                                 lambda t: done.set())
                done.wait(30)
            finally:
                bb.free()

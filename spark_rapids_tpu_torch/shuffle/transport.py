"""Shuffle transport SPI + bounce buffers (counterpart of the JAX
package's ``shuffle/transport.py``; host code, copied so the port imports
nothing of that package).

Re-design of the reference's transport layer
(RapidsShuffleTransport.scala:38-295, BounceBufferManager.scala:17-129):
the SPI survives — Connection/ClientConnection/ServerConnection,
metadata/transfer request kinds, tagged buffer sends, a fixed pool of
reusable staging (bounce) buffers — while the UCX endpoint mesh underneath
is replaced by pluggable implementations: ``InProcessTransport`` for tests
and one process, and the TCP loopback ``SocketTransport``
(``shuffle/socket_transport.py``). The JAX package's ICI mesh path needs
more than one card and is not ported (ROADMAP A.9).
"""

from __future__ import annotations

import threading
from enum import Enum
from typing import Callable, Dict, List, Optional


class TransactionStatus(Enum):
    SUCCESS = "success"
    ERROR = "error"
    CANCELLED = "cancelled"


class Transaction:
    """One async transport operation (reference: Transaction,
    RapidsShuffleTransport.scala:86-163)."""

    def __init__(self):
        self.status = TransactionStatus.CANCELLED
        self.error_message: Optional[str] = None
        self.length = 0
        self._done = threading.Event()

    def complete(self, status: TransactionStatus, length: int = 0,
                 error: Optional[str] = None) -> None:
        self.status = status
        self.length = length
        self.error_message = error
        self._done.set()

    def wait(self, timeout: Optional[float] = None) -> "Transaction":
        self._done.wait(timeout)
        return self


class RequestType(Enum):
    METADATA = "metadata"          # reference: MetadataRequest flatbuffer
    TRANSFER = "transfer"          # reference: TransferRequest flatbuffer


class ClientConnection:
    """Executor-side connection to one peer (reference: ClientConnection,
    RapidsShuffleTransport.scala:229-258)."""

    def request(self, req_type: RequestType, payload: bytes,
                cb: Callable[[Transaction, bytes], None]) -> Transaction:
        raise NotImplementedError

    def receive(self, tag: int, target: bytearray,
                cb: Callable[[Transaction], None]) -> Transaction:
        raise NotImplementedError


class ServerConnection:
    """Server side (reference: ServerConnection,
    RapidsShuffleTransport.scala:260-295)."""

    def register_request_handler(
            self, req_type: RequestType,
            handler: Callable[[bytes], bytes]) -> None:
        raise NotImplementedError

    def send(self, peer_id: str, tag: int, data: bytes,
             cb: Callable[[Transaction], None]) -> Transaction:
        raise NotImplementedError


class ShuffleTransport:
    """Factory SPI (reference: RapidsShuffleTransport.makeTransport —
    loaded via reflection; here via conf class path)."""

    def make_client(self, peer_executor_id: str) -> ClientConnection:
        raise NotImplementedError

    def get_server(self) -> ServerConnection:
        raise NotImplementedError

    def shutdown(self) -> None:
        pass


class BounceBuffer:
    """One reusable staging buffer (reference: BounceBuffer,
    BounceBufferManager.scala:17-35)."""

    def __init__(self, size: int, manager: "BounceBufferManager"):
        self.data = bytearray(size)
        self.manager = manager
        self.in_use = False

    def free(self) -> None:
        self.manager.free_buffer(self)


class BounceBufferManager:
    """Fixed pool of staging buffers; acquisition blocks when exhausted —
    the transfer-throttling the reference gets from inflight limits
    (BounceBufferManager.scala:37-129, UCXShuffleTransport bounce pools)."""

    def __init__(self, buffer_size: int, num_buffers: int):
        self.buffer_size = buffer_size
        self._buffers = [BounceBuffer(buffer_size, self)
                         for _ in range(num_buffers)]
        self._free: List[BounceBuffer] = list(self._buffers)
        self._lock = threading.Lock()
        self._available = threading.Condition(self._lock)

    def acquire_buffer(self, timeout: Optional[float] = None) -> BounceBuffer:
        with self._available:
            while not self._free:
                if not self._available.wait(timeout):
                    raise TimeoutError("no bounce buffer available")
            buf = self._free.pop()
            buf.in_use = True
            return buf

    def free_buffer(self, buf: BounceBuffer) -> None:
        with self._available:
            assert buf.in_use, "double free of bounce buffer"
            buf.in_use = False
            self._free.append(buf)
            self._available.notify()

    @property
    def num_free(self) -> int:
        with self._lock:
            return len(self._free)


class InProcessTransport(ShuffleTransport):
    """All executors in one process (tests / local mode): requests call the
    peer's handlers directly; tagged sends rendezvous through a mailbox.
    This is the Ring-2 testing seam — the same SPI surface the mocked
    suites drive in the reference (RapidsShuffleTestHelper.scala:33-135)."""

    _registry: Dict[str, "InProcessTransport"] = {}
    _registry_lock = threading.Lock()

    def __init__(self, executor_id: str):
        self.executor_id = executor_id
        self._server = _InProcessServer(self)
        with InProcessTransport._registry_lock:
            InProcessTransport._registry[executor_id] = self

    @classmethod
    def lookup(cls, executor_id: str) -> "InProcessTransport":
        with cls._registry_lock:
            return cls._registry[executor_id]

    @classmethod
    def clear_registry(cls) -> None:
        with cls._registry_lock:
            cls._registry.clear()

    def make_client(self, peer_executor_id: str) -> ClientConnection:
        return _InProcessClient(self, peer_executor_id)

    def get_server(self) -> ServerConnection:
        return self._server

    def shutdown(self) -> None:
        with InProcessTransport._registry_lock:
            InProcessTransport._registry.pop(self.executor_id, None)


class _InProcessServer(ServerConnection):
    def __init__(self, transport: InProcessTransport):
        self.transport = transport
        self._handlers: Dict[RequestType, Callable[[bytes], bytes]] = {}
        # (peer_id, tag) -> waiting receive (target, txn, cb)
        self._mailbox: Dict[tuple, tuple] = {}
        self._mailbox_lock = threading.Lock()
        self._pending_sends: Dict[tuple, tuple] = {}

    def register_request_handler(self, req_type: RequestType,
                                 handler: Callable[[bytes], bytes]) -> None:
        self._handlers[req_type] = handler

    def handle_request(self, req_type: RequestType, payload: bytes) -> bytes:
        handler = self._handlers.get(req_type)
        if handler is None:
            raise RuntimeError(f"no handler for {req_type}")
        return handler(payload)

    def send(self, peer_id: str, tag: int, data: bytes,
             cb: Callable[[Transaction], None]) -> Transaction:
        txn = Transaction()
        peer = InProcessTransport.lookup(peer_id)
        key = (self.transport.executor_id, tag)
        # take-or-park must be one atomic step under the peer's mailbox
        # lock, else a receive posted in between strands both sides
        with peer._server._mailbox_lock:
            recv = peer._server._mailbox.pop(key, None)
            if recv is None:
                peer._server._pending_sends[key] = (data, txn, cb)
                return txn
        target, rtxn, rcb = recv
        n = min(len(data), len(target))
        target[:n] = data[:n]
        rtxn.complete(TransactionStatus.SUCCESS, n)
        rcb(rtxn)
        txn.complete(TransactionStatus.SUCCESS, n)
        cb(txn)
        return txn

    def post_receive(self, peer_id: str, tag: int, target: bytearray,
                     txn: Transaction, cb) -> None:
        key = (peer_id, tag)
        with self._mailbox_lock:
            pending = self._pending_sends.pop(key, None)
            if pending is None:
                self._mailbox[key] = (target, txn, cb)
                return
        data, stxn, scb = pending
        n = min(len(data), len(target))
        target[:n] = data[:n]
        txn.complete(TransactionStatus.SUCCESS, n)
        cb(txn)
        stxn.complete(TransactionStatus.SUCCESS, n)
        scb(stxn)


class _InProcessClient(ClientConnection):
    def __init__(self, transport: InProcessTransport, peer_id: str):
        self.transport = transport
        self.peer_id = peer_id

    def request(self, req_type: RequestType, payload: bytes,
                cb: Callable[[Transaction, bytes], None]) -> Transaction:
        txn = Transaction()
        try:
            peer = InProcessTransport.lookup(self.peer_id)
            resp = peer._server.handle_request(req_type, payload)
            txn.complete(TransactionStatus.SUCCESS, len(resp))
            cb(txn, resp)
        except Exception as e:  # noqa: BLE001
            txn.complete(TransactionStatus.ERROR, 0, str(e))
            cb(txn, b"")
        return txn

    def receive(self, tag: int, target: bytearray,
                cb: Callable[[Transaction], None]) -> Transaction:
        txn = Transaction()
        self.transport._server.post_receive(self.peer_id, tag, target, txn,
                                            cb)
        return txn

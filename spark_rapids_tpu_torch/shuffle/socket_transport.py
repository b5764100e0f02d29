"""Real-wire shuffle transport (counterpart of the JAX package's
``shuffle/socket_transport.py``): TCP loopback sockets implementing the
transport SPI (reference: the UCX production transport,
shuffle-plugin/src/main/scala/com/nvidia/spark/rapids/shuffle/ucx/
UCX.scala:330-450 + UCXShuffleTransport.scala).

Where the reference registers UCX endpoints keyed by a tag composed from
the peer's BlockManagerId, this transport runs one listening socket per
executor and one bidirectional TCP connection per (client, server) pair:
requests flow client->server as framed messages with correlation ids, and
tagged buffer chunks flow server->client over the SAME socket (the
socket's two directions play the role of the paired UCX endpoints).

Frame format (little-endian):
    [u8 kind][u64 id_or_tag][u32 len][len bytes]
kinds: 1=METADATA request, 2=TRANSFER request, 3=success response,
4=error response, 5=tagged chunk send.

The listener binds 127.0.0.1 on a port the system picks; executors in
other processes find it through the file registry
(``SRT_SHUFFLE_REGISTRY_FILE``). Every thread (the accept loop, one per
served connection, one reader per dialed client) is a daemon, and
``shutdown`` closes every socket the transport opened or accepted and
joins them. A failed request comes back as an error response frame.

Fault injection (tests): ``fault_drop_tagged_after(n)`` hard-closes the
server side of a connection after n tagged frames — the mid-transfer
drop case. The client fails all posted receives immediately (no 30s
timeout), the fetch surfaces ShuffleFetchFailedError, and the engine's
per-peer retry (exec/tpu.py maxFetchRetries) re-fetches from the
still-registered map-side blocks over a fresh connection.
"""

from __future__ import annotations

import socket
import struct
import threading
from typing import Callable, Dict, Optional, Tuple

from spark_rapids_tpu_torch.shuffle.transport import (
    ClientConnection, RequestType, ServerConnection, ShuffleTransport,
    Transaction, TransactionStatus,
)

_HDR = struct.Struct("<BQI")
_K_META = 1
_K_TRANSFER = 2
_K_RESP = 3
_K_ERR = 4
_K_TAGGED = 5

_REQ_KIND = {RequestType.METADATA: _K_META, RequestType.TRANSFER: _K_TRANSFER}


def _transport_counter(name: str, **labels):
    """Process-registry counter under the shuffle.transport.* family —
    rendered as ``srt_shuffle_transport_*`` in one Prometheus scrape, so
    socket edges are comparable to ICI edges (shuffle/ici.py's
    ``shuffle.ici.*`` series) side by side."""
    from spark_rapids_tpu_torch.obs.metrics import REGISTRY
    return REGISTRY.counter(name, transport="socket", **labels)


def _rtt_histogram(peer: str):
    from spark_rapids_tpu_torch.obs.metrics import REGISTRY
    return REGISTRY.histogram("shuffle.transport.rttSeconds",
                              transport="socket", peer=peer)


def _send_frame(sock: socket.socket, kind: int, ident: int,
                payload: bytes) -> None:
    # header and payload in two sends (the caller holds the connection's
    # write lock): no copy of a chunk-sized payload to prepend 13 bytes
    sock.sendall(_HDR.pack(kind, ident, len(payload)))
    if payload:
        sock.sendall(payload)


def _recv_exact(sock: socket.socket, n: int) -> bytearray:
    """Exactly ``n`` bytes, received in place into one buffer."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], n - got)
        if not k:
            raise ConnectionError("peer closed")
        got += k
    return buf


def _recv_frame(sock: socket.socket) -> Tuple[int, int, bytearray]:
    kind, ident, ln = _HDR.unpack(_recv_exact(sock, _HDR.size))
    return kind, ident, _recv_exact(sock, ln) if ln else bytearray()


def _close_socket(sock: socket.socket) -> None:
    """Shut both directions (which wakes a thread blocked in accept or
    recv on it), then close."""
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    try:
        sock.close()
    except OSError:
        pass


class SocketTransport(ShuffleTransport):
    """One executor's endpoint: a loopback listener + dialed-out client
    connections. Executor ids resolve to ports through a process-local
    registry (the role BlockManagerId's topology field plays for the
    reference, RapidsShuffleInternalManager.scala:157-172); multi-host
    deployments would swap the registry for the cluster's block-manager
    directory without touching the framing."""

    _registry: Dict[str, int] = {}
    _registry_lock = threading.Lock()

    def __init__(self, executor_id: str):
        self.executor_id = executor_id
        self._server = _SocketServer(self)
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind(("127.0.0.1", 0))
        self._listener.listen(16)
        self.port = self._listener.getsockname()[1]
        self._closed = False
        with SocketTransport._registry_lock:
            SocketTransport._registry[executor_id] = self.port
        # publish for executors in other processes (see lookup_port)
        import os
        reg_path = os.environ.get("SRT_SHUFFLE_REGISTRY_FILE")
        if reg_path:
            with open(reg_path, "a") as f:
                f.write(f"{executor_id} {self.port}\n")
                f.flush()
        # every thread this transport starts, joined by shutdown, and the
        # clients it made (their sockets and reader threads)
        self._threads: list = []
        self._clients: list = []
        self._threads_lock = threading.Lock()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True,
            name=f"shuffle-accept-{executor_id}")
        self._accept_thread.start()
        # fault injection: drop server->client sockets after N tagged sends
        self._fault_drop_after: Optional[int] = None
        self._tagged_sent = 0
        self._fault_lock = threading.Lock()
        # wire counters (tests assert data really crossed the socket)
        self.stats = {"tagged_frames": 0, "tagged_bytes": 0,
                      "requests": 0, "faults_fired": 0}

    # -- fault injection ---------------------------------------------------
    def fault_drop_tagged_after(self, n: Optional[int]) -> None:
        """Arm (or disarm with None) a one-shot mid-transfer drop: the
        n+1-th tagged frame hard-closes its connection instead of
        sending."""
        with self._fault_lock:
            self._fault_drop_after = n
            self._tagged_sent = 0

    def _fault_should_drop(self) -> bool:
        with self._fault_lock:
            if self._fault_drop_after is None:
                return False
            self._tagged_sent += 1
            if self._tagged_sent > self._fault_drop_after:
                self._fault_drop_after = None  # one-shot
                return True
            return False

    # -- SPI ---------------------------------------------------------------
    @classmethod
    def lookup_port(cls, executor_id: str) -> int:
        with cls._registry_lock:
            port = cls._registry.get(executor_id)
        if port is not None:
            return port
        # cross-process resolution: executors in OTHER processes publish
        # "<executor_id> <port>" lines to SRT_SHUFFLE_REGISTRY_FILE (the
        # role the cluster block-manager directory plays for the
        # reference, RapidsShuffleInternalManager.scala:157-172). Poll
        # briefly: a freshly-spawned peer may not have bound yet.
        import os
        import time
        path = os.environ.get("SRT_SHUFFLE_REGISTRY_FILE")
        if path:
            deadline = time.monotonic() + float(os.environ.get(
                "SRT_SHUFFLE_REGISTRY_WAIT_S", "10"))
            while time.monotonic() < deadline:
                try:
                    with open(path) as f:
                        for line in f:
                            parts = line.split()
                            if len(parts) == 2 and parts[0] == executor_id:
                                return int(parts[1])
                except OSError:
                    pass
                time.sleep(0.05)
        raise KeyError(executor_id)

    @classmethod
    def clear_registry(cls) -> None:
        with cls._registry_lock:
            cls._registry.clear()

    def make_client(self, peer_executor_id: str) -> "_SocketClient":
        client = _SocketClient(self, peer_executor_id)
        with self._threads_lock:
            self._clients.append(client)
        return client

    def _start_thread(self, target, args, name: str) -> None:
        t = threading.Thread(target=target, args=args, daemon=True,
                             name=name)
        with self._threads_lock:
            self._threads = [x for x in self._threads if x.is_alive()]
            self._threads.append(t)
        t.start()

    def get_server(self) -> "_SocketServer":
        return self._server

    def shutdown(self, timeout: float = 5.0) -> None:
        """Close the listener, every served connection and every client
        connection, then join the transport's threads (each within
        ``timeout`` seconds)."""
        self._closed = True
        _close_socket(self._listener)
        self._server.close_all()
        with self._threads_lock:
            clients, self._clients = self._clients, []
        for c in clients:
            c.close()
        with SocketTransport._registry_lock:
            SocketTransport._registry.pop(self.executor_id, None)
        self._accept_thread.join(timeout)
        with self._threads_lock:
            threads, self._threads = self._threads, []
        for c in clients:
            threads.extend(c.threads)
        for t in threads:
            if t is not threading.current_thread():
                t.join(timeout)

    # -- server plumbing ---------------------------------------------------
    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                conn, _addr = self._listener.accept()
            except OSError:
                return
            if self._closed:
                _close_socket(conn)
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._server.track(conn)
            self._start_thread(self._serve_conn, (conn,),
                               f"shuffle-serve-{self.executor_id}")

    def _serve_conn(self, conn: socket.socket) -> None:
        """Server side of one accepted connection. First frame is the
        peer's identity (kind=RESP, payload=executor id); afterwards
        requests are handled inline and responses/tagged sends share the
        socket under a write lock."""
        peer_id = None
        try:
            kind, _i, payload = _recv_frame(conn)
            if kind != _K_RESP:
                conn.close()
                return
            peer_id = payload.decode("utf-8")
            self._server.register_peer(peer_id, conn)
            while True:
                kind, ident, payload = _recv_frame(conn)
                if kind not in (_K_META, _K_TRANSFER):
                    continue
                rt = (RequestType.METADATA if kind == _K_META
                      else RequestType.TRANSFER)
                self.stats["requests"] += 1
                try:
                    resp = self._server.handle_request(rt, payload)
                    self._server.write_frame(conn, _K_RESP, ident, resp)
                except Exception as e:  # noqa: BLE001 — sent to peer
                    self._server.write_frame(
                        conn, _K_ERR, ident, str(e).encode("utf-8")[:1000])
        except (ConnectionError, OSError):
            pass
        finally:
            if peer_id is not None:
                self._server.unregister_peer(peer_id, conn)
            self._server.untrack(conn)
            try:
                conn.close()
            except OSError:
                pass


class _SocketServer(ServerConnection):
    def __init__(self, transport: SocketTransport):
        self.transport = transport
        self._handlers: Dict[RequestType, Callable[[bytes], bytes]] = {}
        self._peers: Dict[str, socket.socket] = {}
        self._write_locks: Dict[socket.socket, threading.Lock] = {}
        self._lock = threading.Lock()
        # every accepted connection still open (closed by close_all)
        self._conns: set = set()
        # per-peer sent-side counters, resolved once (see _SocketClient)
        self._sent_counters: Dict[str, tuple] = {}

    def _sent(self, peer_id: str) -> tuple:
        c = self._sent_counters.get(peer_id)
        if c is None:
            c = (_transport_counter("shuffle.transport.bytes",
                                    peer=peer_id, direction="sent"),
                 _transport_counter("shuffle.transport.frames",
                                    peer=peer_id, direction="sent"))
            self._sent_counters[peer_id] = c
        return c

    def register_request_handler(self, req_type: RequestType,
                                 handler: Callable[[bytes], bytes]) -> None:
        self._handlers[req_type] = handler

    def handle_request(self, req_type: RequestType, payload: bytes) -> bytes:
        handler = self._handlers.get(req_type)
        if handler is None:
            raise RuntimeError(f"no handler for {req_type}")
        return handler(payload)

    def track(self, conn: socket.socket) -> None:
        with self._lock:
            self._conns.add(conn)

    def untrack(self, conn: socket.socket) -> None:
        with self._lock:
            self._conns.discard(conn)

    def register_peer(self, peer_id: str, conn: socket.socket) -> None:
        with self._lock:
            self._peers[peer_id] = conn
            self._write_locks[conn] = threading.Lock()

    def unregister_peer(self, peer_id: str, conn: socket.socket) -> None:
        with self._lock:
            if self._peers.get(peer_id) is conn:
                del self._peers[peer_id]
            self._write_locks.pop(conn, None)

    def write_frame(self, conn: socket.socket, kind: int, ident: int,
                    payload: bytes) -> None:
        with self._lock:
            wlock = self._write_locks.get(conn)
        if wlock is None:
            raise ConnectionError("peer connection gone")
        with wlock:
            _send_frame(conn, kind, ident, payload)

    def send(self, peer_id: str, tag: int, data: bytes,
             cb: Callable[[Transaction], None]) -> Transaction:
        """Tagged chunk send to a connected peer (server->client leg)."""
        txn = Transaction()
        with self._lock:
            conn = self._peers.get(peer_id)
        if conn is None:
            txn.complete(TransactionStatus.ERROR, 0,
                         f"peer {peer_id} not connected")
            cb(txn)
            return txn
        if self.transport._fault_should_drop():
            self.transport.stats["faults_fired"] += 1
            from spark_rapids_tpu_torch.obs.trace import TRACER
            TRACER.instant("shuffle.transport.drop", peer=peer_id,
                           injected=True)
            try:
                conn.shutdown(socket.SHUT_RDWR)
                conn.close()
            except OSError:
                pass
            txn.complete(TransactionStatus.ERROR, 0,
                         "fault injection: connection dropped mid-transfer")
            cb(txn)
            return txn
        try:
            self.write_frame(conn, _K_TAGGED, tag, data)
            self.transport.stats["tagged_frames"] += 1
            self.transport.stats["tagged_bytes"] += len(data)
            cbytes, cframes = self._sent(peer_id)
            cbytes.add(len(data))
            cframes.add(1)
            txn.complete(TransactionStatus.SUCCESS, len(data))
        except (ConnectionError, OSError) as e:
            txn.complete(TransactionStatus.ERROR, 0, str(e))
        cb(txn)
        return txn

    def close_all(self) -> None:
        with self._lock:
            conns = set(self._peers.values()) | self._conns
            self._peers.clear()
            self._write_locks.clear()
            self._conns.clear()
        for c in conns:
            _close_socket(c)


class _SocketClient(ClientConnection):
    """Client leg: dials the peer's listener lazily and redials after a
    drop (each request re-checks liveness), so a stage retry lands on a
    fresh connection — the reference reconnects through
    UCX.getConnection the same way."""

    def __init__(self, transport: SocketTransport, peer_id: str):
        self.transport = transport
        self.peer_id = peer_id
        # wire counters resolved ONCE per connection (peer is fixed):
        # the registry lookup hashes labels under a process-wide lock,
        # which the per-frame reader loop must not pay
        self._bytes_recv = _transport_counter(
            "shuffle.transport.bytes", peer=peer_id, direction="received")
        self._frames_recv = _transport_counter(
            "shuffle.transport.frames", peer=peer_id,
            direction="received")
        self._rtt = _rtt_histogram(peer_id)
        self._req_counters = {
            rt: _transport_counter("shuffle.transport.requests",
                                   peer=peer_id, kind=rt.value)
            for rt in RequestType}
        self._sock: Optional[socket.socket] = None
        self._sock_lock = threading.Lock()
        self._write_lock = threading.Lock()
        self._reqs: Dict[int, Callable[[Transaction, bytes], None]] = {}
        self._recvs: Dict[int, Tuple[bytearray, Transaction,
                                     Callable[[Transaction], None]]] = {}
        self._pending_tagged: Dict[int, bytes] = {}
        self._state_lock = threading.Lock()
        self._req_seq = 0
        # reader threads started by this client (joined by the transport's
        # shutdown)
        self.threads: list = []

    def _ensure_connected(self) -> socket.socket:
        with self._sock_lock:
            if self._sock is not None:
                return self._sock
            port = SocketTransport.lookup_port(self.peer_id)
            s = socket.create_connection(("127.0.0.1", port), timeout=10)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            _send_frame(s, _K_RESP, 0,
                        self.transport.executor_id.encode("utf-8"))
            self._sock = s
            t = threading.Thread(target=self._read_loop, args=(s,),
                                 daemon=True,
                                 name=f"shuffle-client-{self.peer_id}")
            self.threads = [x for x in self.threads if x.is_alive()] + [t]
            t.start()
            return s

    def close(self) -> None:
        """Close the connection (its reader thread ends and fails whatever
        is still outstanding)."""
        with self._sock_lock:
            s, self._sock = self._sock, None
        if s is not None:
            _close_socket(s)

    def _read_loop(self, s: socket.socket) -> None:
        try:
            while True:
                kind, ident, payload = _recv_frame(s)
                if kind == _K_RESP or kind == _K_ERR:
                    with self._state_lock:
                        cb = self._reqs.pop(ident, None)
                    if cb is None:
                        continue
                    txn = Transaction()
                    if kind == _K_RESP:
                        txn.complete(TransactionStatus.SUCCESS, len(payload))
                        cb(txn, payload)
                    else:
                        txn.complete(TransactionStatus.ERROR, 0,
                                     payload.decode("utf-8", "replace"))
                        cb(txn, b"")
                elif kind == _K_TAGGED:
                    self._deliver_tagged(ident, payload)
        except (ConnectionError, OSError) as e:
            self._fail_all(f"connection lost: {e}")

    def _deliver_tagged(self, tag: int, payload: bytes) -> None:
        self._bytes_recv.add(len(payload))
        self._frames_recv.add(1)
        with self._state_lock:
            posted = self._recvs.pop(tag, None)
            if posted is None:
                # chunk arrived before the receive was posted: park it
                self._pending_tagged[tag] = payload
                return
        target, txn, cb = posted
        n = min(len(payload), len(target))
        target[:n] = payload[:n]
        txn.complete(TransactionStatus.SUCCESS, n)
        cb(txn)

    def _fail_all(self, msg: str) -> None:
        """A dead socket fails every outstanding op NOW — a dropped
        transfer must surface as ShuffleFetchFailedError immediately, not
        after per-chunk timeouts."""
        with self._sock_lock:
            if self._sock is not None:
                _close_socket(self._sock)
                self._sock = None
        with self._state_lock:
            reqs = list(self._reqs.values())
            self._reqs.clear()
            recvs = list(self._recvs.values())
            self._recvs.clear()
            self._pending_tagged.clear()
        if reqs or recvs:
            # only a drop with outstanding ops is a LOST connection; the
            # reader loop also lands here on clean transport shutdown
            from spark_rapids_tpu_torch.obs.metrics import REGISTRY
            from spark_rapids_tpu_torch.obs.trace import TRACER
            REGISTRY.counter("shuffle.transport.connectionsLost").add(1)
            TRACER.instant("shuffle.transport.connectionLost",
                           peer=self.peer_id, inflight=len(reqs) + len(recvs))
        for cb in reqs:
            txn = Transaction()
            txn.complete(TransactionStatus.ERROR, 0, msg)
            cb(txn, b"")
        for _target, txn, cb in recvs:
            txn.complete(TransactionStatus.ERROR, 0, msg)
            cb(txn)

    def request(self, req_type: RequestType, payload: bytes,
                cb: Callable[[Transaction, bytes], None]) -> Transaction:
        txn = Transaction()
        import time as _time
        self._req_counters[req_type].add(1)
        ident = None
        try:
            s = self._ensure_connected()
            # RTT clock starts AFTER the connection exists: a lazy (re)
            # connect's multi-second TCP setup is not round-trip time
            # and would dominate low-traffic peers' p99
            t0 = _time.perf_counter()

            def finish(t: Transaction, resp: bytes) -> None:
                # per-peer request round-trip time: send -> matching
                # response frame delivered by the reader loop (the one-
                # scrape socket-vs-ICI comparison the monitor exposes).
                # SUCCESS only: a failure callback's elapsed time is
                # time-to-error (_fail_all sweeps), not an RTT sample
                if t.status is TransactionStatus.SUCCESS:
                    self._rtt.observe(_time.perf_counter() - t0)
                    self._bytes_recv.add(len(resp))
                txn.complete(t.status, t.length, t.error_message)
                cb(txn, resp)

            with self._state_lock:
                self._req_seq += 1
                ident = self._req_seq
                self._reqs[ident] = finish
            with self._write_lock:
                _send_frame(s, _REQ_KIND[req_type], ident, payload)
        except (KeyError, ConnectionError, OSError) as e:
            # exactly-once completion: if the reader thread's _fail_all
            # swept this request concurrently (pop finds nothing), it
            # already completed the callback — completing here too would
            # double-drive the caller's fetch bookkeeping
            already_completed = False
            if ident is not None:
                with self._state_lock:
                    already_completed = \
                        self._reqs.pop(ident, None) is None
            if not already_completed:
                txn.complete(TransactionStatus.ERROR, 0, str(e))
                cb(txn, b"")
        return txn

    def receive(self, tag: int, target: bytearray,
                cb: Callable[[Transaction], None]) -> Transaction:
        txn = Transaction()
        try:
            self._ensure_connected()
        except (KeyError, ConnectionError, OSError) as e:
            txn.complete(TransactionStatus.ERROR, 0, str(e))
            cb(txn)
            return txn
        with self._state_lock:
            early = self._pending_tagged.pop(tag, None)
            if early is None:
                self._recvs[tag] = (target, txn, cb)
                return txn
        n = min(len(early), len(target))
        target[:n] = early[:n]
        txn.complete(TransactionStatus.SUCCESS, n)
        cb(txn)
        return txn

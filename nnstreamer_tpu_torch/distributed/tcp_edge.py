"""The raw-TCP edge transport: pub/sub with no dependency past sockets.

Port of ``nnstreamer_tpu/distributed/tcp_edge.py`` (≙ nnstreamer-edge's
plain-TCP connect type, ``gst/edge/edge_common.c:23-35``).  Subscribers
dial the publisher and name a topic; the publisher sends them every frame
published to it.  Topics match exactly.

Protocol (little-endian), the JAX package's bytes:
  subscribe:  client -> server   u32 topic_len | topic utf8
  stream:     server -> client   per frame: u32 payload_len | payload
where payload is a ``distributed/wire.py`` frame.  Publishing blocks on a
subscriber whose socket is full (for at most the send timeout, then the
subscriber is dropped); nothing is queued and nothing is dropped silently.
Payloads are bytes: callers bring card tensors to the host first.
"""

from __future__ import annotations

import socket
import struct
import threading
from typing import Dict, Iterator, List, Optional

from ..core.log import get_logger
from ..core.resilience import FAULTS

log = get_logger("tcp_edge")

_LEN = struct.Struct("<I")
_MAX_FRAME = 1 << 30  # sanity bound on a length prefix
_MAX_TOPIC = 4096


def _read_exact(sock: socket.socket, n: int) -> bytearray:
    """``n`` bytes received straight into one buffer (no copy after)."""
    buf = bytearray(n)
    view, got = memoryview(buf), 0
    while got < n:
        k = sock.recv_into(view[got:])
        if not k:
            raise ConnectionError("tcp edge peer closed")
        got += k
    return buf


def _close(sock: socket.socket) -> None:
    for op in (lambda: sock.shutdown(socket.SHUT_RDWR), sock.close):
        try:
            op()
        except OSError:
            pass


class TcpEdgeServer:
    """The publisher's endpoint: subscribers dial in, name a topic, and get
    every frame published to it until they hang up."""

    def __init__(self, host: str = "0.0.0.0", port: int = 0):
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(16)
        self.port = self._srv.getsockname()[1]
        self._lock = threading.Lock()
        self._subs: Dict[str, List[tuple]] = {}  # topic -> [(sock, write lock)]
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._accept_loop, name="tcp-edge-server",
                                        daemon=True)
        self._thread.start()

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                sock, _ = self._srv.accept()
            except OSError:
                return
            threading.Thread(target=self._register, args=(sock,), name="tcp-edge-register",
                             daemon=True).start()

    def _register(self, sock: socket.socket) -> None:
        try:
            sock.settimeout(10.0)  # a peer that never names its topic
            (tlen,) = _LEN.unpack(_read_exact(sock, _LEN.size))
            if tlen > _MAX_TOPIC:
                raise ConnectionError("absurd topic length")
            topic = _read_exact(sock, tlen).decode()
            # allow-blocking: this socket is only written to, and each send
            # is bounded by SO_SNDTIMEO below, so a wedged subscriber cannot
            # stall the publisher for good
            sock.settimeout(None)
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDTIMEO, struct.pack("ll", 5, 0))
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except (ConnectionError, OSError, UnicodeDecodeError) as e:
            log.warning("tcp edge: dropping bad subscriber: %s", e)
            _close(sock)
            return
        with self._lock:
            if self._stop.is_set():
                _close(sock)
                return
            self._subs.setdefault(topic, []).append((sock, threading.Lock()))
        log.info("tcp edge: subscriber attached to topic %r", topic)

    def publish(self, topic: str, payload) -> int:
        """Send ``payload`` (bytes, or a list of bytes-like parts sent as one
        frame) to every live subscriber of ``topic``; returns how many got
        it.  A subscriber whose send fails is dropped and closed."""
        parts = list(payload) if isinstance(payload, (list, tuple)) else [payload]
        if FAULTS.is_armed():
            # a corrupt= fault mutates the frame after its checksum; the
            # length prefix stays honest, the subscriber's verify catches it
            parts = [FAULTS.mangle("tcp_edge.publish", b"".join(bytes(p) for p in parts))]
        n = sum(memoryview(p).nbytes for p in parts)
        msg = [_LEN.pack(n)] + parts
        with self._lock:
            targets = list(self._subs.get(topic, ()))
        delivered, dead = 0, []
        for sock, wlock in targets:
            try:
                FAULTS.check("tcp_edge.publish")
                with wlock:
                    _sendall_parts(sock, msg)
                delivered += 1
            except (socket.timeout, OSError):
                dead.append((sock, wlock))
        if dead:
            with self._lock:
                subs = self._subs.get(topic, [])
                for entry in dead:
                    if entry in subs:
                        subs.remove(entry)
                    _close(entry[0])
        return delivered

    def subscriber_count(self, topic: str) -> int:
        with self._lock:
            return len(self._subs.get(topic, ()))

    def close(self) -> None:
        self._stop.set()
        _close(self._srv)
        with self._lock:
            socks = [s for subs in self._subs.values() for s, _ in subs]
            self._subs.clear()
        for s in socks:
            _close(s)
        self._thread.join(timeout=5)


def _sendall_parts(sock: socket.socket, parts: list) -> None:
    """Gather-write ``parts`` in full (``sendmsg`` may send a prefix)."""
    views = [memoryview(p).cast("B") for p in parts if memoryview(p).nbytes]
    while views:
        sent = sock.sendmsg(views)
        while views and sent >= views[0].nbytes:
            sent -= views[0].nbytes
            views.pop(0)
        if views and sent:
            views[0] = views[0][sent:]


class TcpEdgeSubscriber:
    """The subscriber's endpoint: dial, name the topic, iterate payloads."""

    def __init__(self, host: str, port: int, topic: str, timeout: float = 10.0):
        self._sock = socket.create_connection((host, port), timeout=timeout)
        t = topic.encode()
        self._sock.sendall(_LEN.pack(len(t)) + t)
        # allow-blocking: a stream may idle as long as its publisher is
        # quiet; close() shuts the socket down, so a blocked recv always ends
        self._sock.settimeout(None)
        self._closed = False

    def payloads(self, idle_timeout: Optional[float] = None) -> Iterator[bytearray]:
        """Frame payloads until the publisher hangs up (or ``idle_timeout``
        seconds pass without one); the socket is closed when the stream
        ends for any reason."""
        self._sock.settimeout(idle_timeout)
        try:
            while not self._closed:
                try:
                    (n,) = _LEN.unpack(_read_exact(self._sock, _LEN.size))
                    if n > _MAX_FRAME:
                        raise ConnectionError("absurd frame length")
                    yield _read_exact(self._sock, n)
                except (ConnectionError, OSError):
                    return
        finally:
            self.close()

    def close(self) -> None:
        self._closed = True
        _close(self._sock)

"""A small MQTT 3.1.1 transport: a client and an in-process broker (stdlib only).

Port of ``nnstreamer_tpu/distributed/mqtt.py`` (≙ the reference's
``gst/mqtt/`` on paho ``MQTTAsync``): the subset the mqtt elements and the
discovery plane need.  QoS 0 and 1 publish (PUBACK, DUP redelivery),
subscribe with ``+``/``#`` wildcards at a granted QoS, retained messages
(an empty retained payload deletes), keep-alive pings, automatic reconnect
with re-subscribe over an ordered ``brokers=`` failover list, and a
localhost :class:`MiniBroker` whose persistent sessions (``clean_session``
false) keep subscriptions and undelivered QoS-1 messages across a
subscriber's death and across a restart of the broker on the same port.

QoS 1 is at-least-once: a publish unacknowledged when the connection drops
is re-sent with DUP after reconnect, so receivers may see duplicates, never
silent loss.  On a live connection a message is re-sent only once its peer
has been silent for ``retransmit_s`` (the JAX package re-sends on the timer
alone, which duplicates messages a busy but live peer has yet to read).
Reads are buffered: one ``recv`` takes every packet that has arrived.
Bytes on the wire follow the OASIS MQTT 3.1.1 spec, so either package's
client works against the other's broker.

A reconnect counts itself (``reconnects``), re-subscribes and runs the
``on_connect`` hooks BEFORE it sets ``connected``: whoever waits on
``connected`` reads counts that are already final.  Nothing here touches
the card: payloads are bytes.
"""

from __future__ import annotations

import socket
import struct
import threading
import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from ..core.log import get_logger

log = get_logger("mqtt")

# packet types (MQTT 3.1.1 §2.2.1)
CONNECT, CONNACK = 1, 2
PUBLISH, PUBACK = 3, 4
SUBSCRIBE, SUBACK = 8, 9
UNSUBSCRIBE, UNSUBACK = 10, 11
PINGREQ, PINGRESP = 12, 13
DISCONNECT = 14

#: seconds a blocked send to one peer may last before the broker drops it
_SEND_TIMEOUT = struct.pack("ll", 5, 0)


class MqttProtocolError(ValueError):
    """A packet that does not parse."""


def _encode_len(n: int) -> bytes:
    out = b""
    while True:
        d, n = n % 128, n // 128
        out += bytes([d | (0x80 if n else 0)])
        if not n:
            return out


class _PacketReader:
    """Buffered reads from one socket: a ``recv`` takes every packet that has
    arrived, so a burst of small packets costs one system call (and one
    re-take of the interpreter lock) instead of three a packet."""

    __slots__ = ("sock", "buf")

    def __init__(self, sock: socket.socket):
        self.sock, self.buf = sock, bytearray()

    def read(self, n: int) -> bytes:
        while len(self.buf) < n:
            chunk = self.sock.recv(max(1 << 16, n - len(self.buf)))
            if not chunk:
                raise ConnectionError("MQTT peer closed")
            self.buf += chunk
        out = bytes(self.buf[:n])
        del self.buf[:n]
        return out


def _read_packet(rx: _PacketReader) -> Tuple[int, int, bytes]:
    """One packet as (type, flags, body)."""
    read = rx.read
    head = read(1)[0]
    mult, length = 1, 0
    while True:
        b = read(1)[0]
        length += (b & 0x7F) * mult
        if not b & 0x80:
            break
        mult *= 128
        if mult > 128 ** 3:
            raise ConnectionError("malformed MQTT length")
    return head >> 4, head & 0xF, read(length) if length else b""


def _mqtt_str(s: str) -> bytes:
    b = s.encode()
    return struct.pack(">H", len(b)) + b


def _parse_publish(flags: int, body: bytes) -> Tuple[str, bytes, Optional[int]]:
    """A PUBLISH body as (topic, payload, packet id or None)."""
    if len(body) < 2:
        raise MqttProtocolError("PUBLISH body too short")
    off = 2 + struct.unpack(">H", body[:2])[0]
    if off > len(body):
        raise MqttProtocolError("PUBLISH topic length exceeds body")
    try:
        topic = body[2:off].decode()
    except UnicodeDecodeError as e:
        raise MqttProtocolError(f"PUBLISH topic not UTF-8: {e}") from None
    pid = None
    if (flags >> 1) & 0x3:  # QoS > 0 carries a packet id
        if off + 2 > len(body):
            raise MqttProtocolError("PUBLISH missing packet id")
        pid = struct.unpack(">H", body[off:off + 2])[0]
        off += 2
    return topic, body[off:], pid


def _publish_packet(topic: str, payload: bytes, retain: bool = False, qos: int = 0,
                    pid: int = 0, dup: bool = False) -> bytes:
    var = _mqtt_str(topic) + (struct.pack(">H", pid) if qos else b"") + payload
    head = (PUBLISH << 4) | (1 if retain else 0) | ((qos & 0x3) << 1) | (0x8 if dup else 0)
    return bytes([head]) + _encode_len(len(var)) + var


def _puback(pid: int) -> bytes:
    return bytes([PUBACK << 4, 2]) + struct.pack(">H", pid)


def _close(sock: socket.socket) -> None:
    """shutdown, then close: shutdown wakes a thread blocked in recv or
    accept on the socket and sends the peer its FIN at once."""
    for op in (lambda: sock.shutdown(socket.SHUT_RDWR), sock.close):
        try:
            op()
        except OSError:
            pass


def topic_matches(pattern: str, topic: str) -> bool:
    """MQTT wildcard match: ``+`` one level, ``#`` the rest (spec §4.7)."""
    pp, tp = pattern.split("/"), topic.split("/")
    for i, p in enumerate(pp):
        if p == "#":
            return True
        if i >= len(tp) or (p != "+" and p != tp[i]):
            return False
    return len(pp) == len(tp)


# Persistent sessions across a broker restart on the same port, stamped
# with the time they were stored: a successor adopts only fresh ones (a
# restart follows its close within seconds; an unrelated broker reusing an
# ephemeral port much later must not inherit them).
_SESSION_STORE: Dict[int, Tuple[float, Dict[str, "_BrokerSession"]]] = {}
_SESSION_STORE_TTL_S = 300.0


def _evict_stale_sessions() -> None:
    now = time.monotonic()
    for port in [p for p, (ts, _) in _SESSION_STORE.items() if now - ts > _SESSION_STORE_TTL_S]:
        del _SESSION_STORE[port]


class _BrokerSession:
    """One client id's broker state: subscriptions (pattern -> granted QoS),
    the live socket (None while offline), QoS-1 deliveries awaiting their
    PUBACK, and the bounded queue of messages held while offline or while
    the in-flight window is full."""

    __slots__ = ("cid", "clean", "subs", "sock", "inflight", "queue", "next_pid", "dropped",
                 "last_rx")

    QUEUE_LIMIT = 1024
    INFLIGHT_LIMIT = 512

    def __init__(self, cid: str, clean: bool):
        self.cid, self.clean = cid, clean
        self.subs: Dict[str, int] = {}
        self.sock: Optional[socket.socket] = None
        self.inflight: Dict[int, list] = {}  # pid -> [topic, payload, last_sent, retain]
        self.queue: List[Tuple[str, bytes, bool]] = []
        self.next_pid = 0
        self.dropped = 0
        self.last_rx = time.monotonic()  # the last packet from the client

    def alloc_pid(self) -> int:
        """The next packet id not awaiting a PUBACK (a wrapped id must never
        overwrite an undelivered message)."""
        while True:
            self.next_pid = (self.next_pid % 0xFFFF) + 1
            if self.next_pid not in self.inflight:
                return self.next_pid


class MiniBroker:
    """A localhost MQTT broker: wildcards, retained messages, QoS 0/1 both
    ways (a QoS-1 subscription gets packet ids and, while it is silent, DUP
    retransmission until PUBACKed), persistent sessions, and restart on the
    same port with the
    persistent sessions' backlog kept (``MiniBroker(port=p)`` after
    ``close()``; retained messages are forgotten, as a broker without a
    persistence file forgets them)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0, retransmit_s: float = 1.0):
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        # REUSEADDR, not REUSEPORT: two live brokers on one port would
        # split the clients between them
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(16)
        self.host, self.port = self._srv.getsockname()[:2]
        self._lock = threading.Lock()
        self._sessions: Dict[str, _BrokerSession] = {}
        _evict_stale_sessions()
        stored = _SESSION_STORE.pop(self.port, None)
        if stored is not None:
            self._sessions.update(stored[1])
        self._by_sock: Dict[socket.socket, _BrokerSession] = {}
        # one write lock per socket: a fan-out and the subscriber's own
        # SUBACK or PINGRESP must not interleave within a sendall
        self._wlocks: Dict[socket.socket, threading.Lock] = {}
        self._retained: Dict[str, bytes] = {}
        self._retransmit_s = retransmit_s
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._accept_loop, name="torch-mqtt-broker",
                                        daemon=True)
        self._thread.start()
        self._redeliver = threading.Thread(target=self._redeliver_loop,
                                           name="torch-mqtt-broker-qos1", daemon=True)
        self._redeliver.start()

    def has_subscriber(self, topic: str) -> bool:
        """True while a connected session holds a subscription matching
        ``topic``."""
        with self._lock:
            return any(sess.sock is not None and topic_matches(pat, topic)
                       for sess in self._sessions.values() for pat in sess.subs)

    def wait_subscriber(self, topic: str, timeout_s: float = 10.0) -> bool:
        """Wait (bounded) until :meth:`has_subscriber`; True on success."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self.has_subscriber(topic):
                return True
            time.sleep(0.01)
        return False

    def close(self) -> None:
        self._stop.set()
        # store the persistent sessions BEFORE the port is free, so a
        # successor binding it cannot miss the acknowledged backlog
        with self._lock:
            keep: Dict[str, _BrokerSession] = {}
            for cid, sess in self._sessions.items():
                if sess.clean:
                    continue
                sess.sock = None
                merged = [(t, p, bool(r)) for t, p, _, r in sess.inflight.values()] + sess.queue
                sess.inflight = {}
                if len(merged) > sess.QUEUE_LIMIT:
                    sess.dropped += len(merged) - sess.QUEUE_LIMIT
                sess.queue = merged[:sess.QUEUE_LIMIT]
                keep[cid] = sess
            _evict_stale_sessions()
            if keep:
                _SESSION_STORE[self.port] = (time.monotonic(), keep)
        _close(self._srv)
        with self._lock:
            socks = list(self._by_sock)
        for s in socks:
            _close(s)
        with self._lock:
            self._by_sock.clear()
            self._wlocks.clear()
            self._sessions.clear()
        self._thread.join(timeout=5)
        self._redeliver.join(timeout=5)

    # -- internals -----------------------------------------------------------
    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                sock, _ = self._srv.accept()
            except OSError:
                return
            threading.Thread(target=self._client_loop, args=(sock,),
                             name="torch-mqtt-broker-conn", daemon=True).start()

    @staticmethod
    def _parse_connect(body: bytes) -> Tuple[str, bool]:
        """CONNECT as (client id, clean session): protocol name, level byte,
        flags byte, keep-alive u16, then the client id (§3.1)."""
        off = 2 + struct.unpack(">H", body[:2])[0]
        flags = body[off + 1]
        off += 4
        n = struct.unpack(">H", body[off:off + 2])[0]
        return body[off + 2:off + 2 + n].decode(), bool(flags & 0x02)

    def _open_session(self, sock: socket.socket, body: bytes) -> Tuple[_BrokerSession, bool]:
        cid, clean = self._parse_connect(body)
        with self._lock:
            existing = self._sessions.get(cid) if cid else None
            # a live connection under the same id is displaced (§3.1.4)
            old = existing.sock if existing is not None else None
            sess = existing if (existing is not None and not clean) else None
            present = sess is not None
            if sess is None:
                sess = _BrokerSession(cid or f"anon-{id(sock):x}", clean)
            sess.clean, sess.sock = clean, sock
            self._sessions[sess.cid] = sess
            self._by_sock[sock] = sess
            self._wlocks[sock] = threading.Lock()
        if old is not None and old is not sock:
            try:
                old.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        return sess, present

    def _client_loop(self, sock: socket.socket) -> None:
        sess = None
        try:
            # bound sends only (recv stays blocking): a wedged subscriber
            # must not stall the shared fan-out and redelivery threads
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDTIMEO, _SEND_TIMEOUT)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            sock.settimeout(10.0)  # a peer that never sends CONNECT
            rx = _PacketReader(sock)
            ptype, _, body = _read_packet(rx)
            if ptype != CONNECT:
                sock.close()
                return
            # allow-blocking: post-handshake reads are stream semantics;
            # close() shuts the socket down, so a blocked recv always ends
            sock.settimeout(None)
            sess, present = self._open_session(sock, body)
            sock.sendall(bytes([CONNACK << 4, 2, 1 if present else 0, 0]))
            if present:
                self._resume_delivery(sess)
            while not self._stop.is_set():
                ptype, flags, body = _read_packet(rx)
                sess.last_rx = time.monotonic()
                if ptype == PUBLISH:
                    self._handle_publish(sock, flags, body)
                elif ptype == PUBACK and len(body) >= 2:
                    with self._lock:
                        sess.inflight.pop(struct.unpack(">H", body[:2])[0], None)
                elif ptype == SUBSCRIBE:
                    self._handle_subscribe(sock, sess, body)
                elif ptype == UNSUBSCRIBE:
                    self._handle_unsubscribe(sock, sess, body)
                elif ptype == PINGREQ:
                    self._send(sock, bytes([PINGRESP << 4, 0]))
                elif ptype == DISCONNECT:
                    break
        except (ConnectionError, OSError):
            pass
        except (MqttProtocolError, struct.error, IndexError, UnicodeDecodeError) as e:
            log.warning("broker: dropping client on malformed packet: %s", e)
        finally:
            with self._lock:
                self._by_sock.pop(sock, None)
                self._wlocks.pop(sock, None)
                if sess is not None and sess.sock is sock:
                    sess.sock = None
                    # only OUR entry: a reconnect may have replaced the id
                    if sess.clean and self._sessions.get(sess.cid) is sess:
                        self._sessions.pop(sess.cid, None)
            try:
                sock.close()
            except OSError:
                pass

    def _resume_delivery(self, sess: _BrokerSession) -> None:
        """A persistent session reconnected: unacknowledged deliveries again
        with DUP, then the offline queue as fresh QoS-1 deliveries."""
        with self._lock:
            sock = sess.sock
            inflight = sorted(sess.inflight.items())
            queued, sess.queue = sess.queue, []
        if sock is None:
            return
        for pid, entry in inflight:
            self._send(sock, _publish_packet(entry[0], entry[1], entry[3], 1, pid, dup=True))
            entry[2] = time.monotonic()
        for topic, payload, retain in queued:
            self._deliver_qos1(sess, topic, payload, retain)

    def _deliver_qos1(self, sess: _BrokerSession, topic: str, payload: bytes,
                      retain: bool = False) -> None:
        with self._lock:
            sock = sess.sock
            # offline, or a full in-flight window: park in the bounded
            # queue; the redelivery loop promotes it as PUBACKs free room
            if sock is None or len(sess.inflight) >= sess.INFLIGHT_LIMIT:
                if len(sess.queue) < sess.QUEUE_LIMIT:
                    sess.queue.append((topic, payload, retain))
                else:
                    sess.dropped += 1
                return
            pid = sess.alloc_pid()
            sess.inflight[pid] = [topic, payload, time.monotonic(), retain]
        self._send(sock, _publish_packet(topic, payload, retain, 1, pid))

    def _redeliver_loop(self) -> None:
        """Resend with DUP the deliveries unacknowledged for ``retransmit_s``
        to a subscriber silent as long, and promote queued messages into
        freed in-flight room.  A subscriber that keeps acknowledging is
        alive and TCP brings it the backlog in order: a resend would only
        duplicate a message it has yet to read."""
        while not self._stop.wait(max(0.05, self._retransmit_s / 2)):
            now = time.monotonic()
            with self._lock:
                stale = [(sess.sock, pid, e) for sess in self._sessions.values()
                         if sess.sock and now - sess.last_rx >= self._retransmit_s
                         for pid, e in sess.inflight.items() if now - e[2] >= self._retransmit_s]
                promotable = [sess for sess in self._sessions.values()
                              if sess.sock and sess.queue
                              and len(sess.inflight) < sess.INFLIGHT_LIMIT]
            for sock, pid, entry in stale:
                entry[2] = now
                self._send(sock, _publish_packet(entry[0], entry[1], entry[3], 1, pid, dup=True))
            for sess in promotable:
                with self._lock:
                    room = sess.INFLIGHT_LIMIT - len(sess.inflight)
                    batch, sess.queue = sess.queue[:room], sess.queue[room:]
                for topic, payload, retain in batch:
                    self._deliver_qos1(sess, topic, payload, retain)

    def _handle_publish(self, sock: socket.socket, flags: int, body: bytes) -> None:
        topic, payload, pid = _parse_publish(flags, body)
        pub_qos = (flags >> 1) & 0x3
        with self._lock:
            if flags & 0x1:  # retain; an empty payload deletes (§3.3.1.3)
                if payload:
                    self._retained[topic] = payload
                else:
                    self._retained.pop(topic, None)
            # each subscriber at min(publish QoS, granted QoS) (§3.8.4)
            targets = [(sess, max((q for p, q in sess.subs.items() if topic_matches(p, topic)),
                                  default=-1)) for sess in self._sessions.values()]
        qos0 = None
        for sess, sub_qos in targets:
            if sub_qos < 0:
                continue
            if min(pub_qos, sub_qos) >= 1:
                self._deliver_qos1(sess, topic, payload)
            elif sess.sock is not None:
                qos0 = qos0 or _publish_packet(topic, payload)
                self._send(sess.sock, qos0)
        if pid is not None:
            # acknowledge only once every matching subscriber holds the
            # message: an earlier ack leaves a window where an acknowledged
            # message exists nowhere
            self._send(sock, _puback(pid))

    def _send(self, sock: socket.socket, data: bytes) -> None:
        with self._lock:
            wl = self._wlocks.get(sock)
        if wl is None:
            return
        try:
            with wl:
                sock.sendall(data)
        except socket.timeout:
            # the peer's window stayed full for the whole send timeout: take
            # it offline (its messages queue) rather than stall the others
            log.warning("broker: peer stopped reading; disconnecting it")
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        except OSError:
            pass

    def _handle_subscribe(self, sock: socket.socket, sess: _BrokerSession, body: bytes) -> None:
        pid, off, grants, new = body[:2], 2, [], []
        with self._lock:
            while off < len(body):
                n = struct.unpack(">H", body[off:off + 2])[0]
                pat = body[off + 2:off + 2 + n].decode()
                granted = min(body[off + 2 + n] & 0x3, 1)  # no QoS 2
                sess.subs[pat] = granted
                grants.append(granted)
                new.append(pat)
                off += 3 + n
            retained = [(t, p, max((sess.subs[pat] for pat in new if topic_matches(pat, t)),
                                   default=0))
                        for t, p in self._retained.items()
                        if any(topic_matches(pat, t) for pat in new)]
        self._send(sock, bytes([SUBACK << 4]) + _encode_len(2 + len(grants)) + pid
                   + bytes(grants))
        # retained messages ride at the granted QoS (§3.3.1.3)
        for t, p, q in retained:
            if q >= 1:
                self._deliver_qos1(sess, t, p, retain=True)
            else:
                self._send(sock, _publish_packet(t, p, retain=True))

    def _handle_unsubscribe(self, sock: socket.socket, sess: _BrokerSession, body: bytes) -> None:
        pid, off = body[:2], 2
        with self._lock:
            while off < len(body):
                n = struct.unpack(">H", body[off:off + 2])[0]
                sess.subs.pop(body[off + 2:off + 2 + n].decode(), None)
                off += 2 + n
        self._send(sock, bytes([UNSUBACK << 4, 2]) + pid)


class MqttClient:
    """MQTT 3.1.1 client: QoS 0/1 publish, ``subscribe(pattern, callback)``,
    automatic reconnect over the ``brokers=`` failover list with
    re-subscribe, QoS-1 redelivery and ``on_connect`` hooks.

    ≙ the reference's paho ``MQTTAsync`` usage (``mqtt_qos``,
    ``gst/mqtt/mqttsink.h:77``, and mqttsrc's reconnect-and-resume)."""

    def __init__(self, host: str, port: int, client_id: str = "", keepalive: int = 60,
                 timeout: float = 10.0, reconnect: bool = True, retransmit_s: float = 2.0,
                 reconnect_delay_s: float = 0.1, clean_session: bool = True,
                 brokers: Optional[Iterable[Tuple[str, int]]] = None):
        self._timeout = timeout
        # ordered failover list: a failed dial moves to the next broker, so
        # a dead primary costs one dial before a live standby is reached
        self._brokers: List[Tuple[str, int]] = [(host, int(port))]
        for h, p in brokers or ():
            if (h, int(p)) not in self._brokers:
                self._brokers.append((h, int(p)))
        self._broker_i = 0
        self._cid = client_id or f"nns-torch-{id(self) & 0xFFFFFF:x}"
        self._clean_session = clean_session
        self._keepalive = max(1, keepalive)
        self._reconnect_enabled = reconnect
        self._retransmit_s = retransmit_s
        # publishers should reconnect later than subscribers, so that after
        # a broker restart the subscriptions are back before redelivery
        self._reconnect_delay_s = max(0.05, reconnect_delay_s)
        self._wlock = threading.Lock()
        self._subs: Dict[str, Callable[[str, bytes], None]] = {}
        self._sub_qos: Dict[str, int] = {}
        self._stop = threading.Event()
        self._pid_lock = threading.Lock()
        self._pid = 0
        self._pending: Dict[int, list] = {}  # pid -> [topic, payload, retain, last_sent]
        self._pending_lock = threading.Lock()
        self._last_rx = time.monotonic()  # the last packet from the broker
        self.connected = threading.Event()
        #: successful reconnects, and retained QoS-1 publishes superseded
        #: by a newer one on the same topic before their PUBACK (exact)
        self.reconnects = 0
        self.coalesced = 0
        self._on_connect: List[Callable[[], None]] = []
        self._sock: Optional[socket.socket] = None
        self._rx: Optional[_PacketReader] = None  # the reader of _sock
        err: Optional[OSError] = None
        for i in range(len(self._brokers)):  # raises only when every broker refused
            self._broker_i = i
            try:
                self._connect()
                err = None
                break
            except OSError as e:
                err = e
        if err is not None:
            raise err
        self.connected.set()
        self._reader = threading.Thread(target=self._read_loop, name="torch-mqtt-client", daemon=True)
        self._reader.start()
        # keep-alive: ping within every keep-alive window; the same timer
        # retransmits unacknowledged QoS-1 publishes
        self._pinger = threading.Thread(target=self._ping_loop, name="torch-mqtt-ping", daemon=True)
        self._pinger.start()

    # -- connection -----------------------------------------------------------
    @property
    def broker(self) -> Tuple[str, int]:
        """The (host, port) this client last connected (or dialed) to."""
        return self._brokers[self._broker_i]

    def on_connect(self, cb: Callable[[], None]) -> None:
        """Run ``cb`` (on the reader thread) after every RE-connect, once
        the session is resumed and before ``connected`` is set: the hook an
        announcement uses to re-publish its retained state into a restarted
        or failed-over broker."""
        self._on_connect.append(cb)

    def _connect(self) -> None:
        host, port = self._brokers[self._broker_i]
        sock = socket.create_connection((host, port), timeout=self._timeout)
        # small packets (PUBACKs, pings, label frames) leave at once
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        var = (_mqtt_str("MQTT") + bytes([4])  # protocol level 4 = 3.1.1
               + bytes([0x02 if self._clean_session else 0x00])
               + struct.pack(">H", self._keepalive) + _mqtt_str(self._cid))
        rx = _PacketReader(sock)  # a resumed session's queue follows the CONNACK
        try:
            sock.sendall(bytes([CONNECT << 4]) + _encode_len(len(var)) + var)
            ptype, _, body = _read_packet(rx)
        except OSError:
            sock.close()
            raise
        if ptype != CONNACK or len(body) < 2 or body[1] != 0:
            sock.close()
            raise ConnectionError(f"MQTT connect refused: {body!r}")
        # a silent link for 1.5x keep-alive means the broker is gone (the
        # pinger elicits a PINGRESP well inside that window)
        sock.settimeout(max(1.0, self._keepalive * 1.5))
        with self._wlock:
            if self._stop.is_set():  # close() ran during the dial
                sock.close()
                raise OSError("mqtt client closed")
            self._sock, self._rx = sock, rx

    def _resume_session(self) -> None:
        """After a reconnect: re-subscribe every pattern and re-send the
        unacknowledged QoS-1 publishes with DUP."""
        for pattern in list(self._subs):
            try:
                self._send_subscribe(pattern)
            except OSError:
                return
        with self._pending_lock:
            pending = sorted(self._pending.items())
        for pid, entry in pending:
            try:
                self._send(_publish_packet(entry[0], entry[1], entry[2], 1, pid, dup=True))
                entry[3] = time.monotonic()
            except OSError:
                return

    def _reconnect_loop(self) -> None:
        backoff = self._reconnect_delay_s
        self._stop.wait(backoff)
        while not self._stop.is_set():
            try:
                self._connect()
            except OSError:
                # the next broker of the list at once; back off only after
                # a whole cycle of the list refused
                self._broker_i = (self._broker_i + 1) % len(self._brokers)
                if self._broker_i == 0:
                    self._stop.wait(backoff)
                    backoff = min(backoff * 2, 2.0)
                continue
            log.info("mqtt client reconnected to %s:%d", *self.broker)
            # count, resume and run the hooks BEFORE signalling: a waiter on
            # `connected` must read final counts
            self.reconnects += 1
            self._resume_session()
            for cb in list(self._on_connect):
                try:
                    cb()
                except Exception:  # a hook's bug must not kill the reader
                    log.exception("mqtt on_connect hook failed")
            self.connected.set()
            return

    # -- io -------------------------------------------------------------------
    def _send(self, data: bytes) -> None:
        with self._wlock:
            if self._sock is None:
                raise OSError("mqtt client not connected")
            self._sock.sendall(data)

    def _ping_loop(self) -> None:
        interval = min(self._keepalive / 2.0, max(self._retransmit_s, 0.2))
        while not self._stop.wait(interval):
            now = time.monotonic()
            with self._pending_lock:
                # a broker still answering (PUBACKs, PINGRESPs) has the
                # publishes in order on the connection: resend only to one
                # silent for retransmit_s
                stale = [] if now - self._last_rx < self._retransmit_s else [
                    (pid, e) for pid, e in sorted(self._pending.items())
                    if now - e[3] >= self._retransmit_s]
            for pid, entry in stale:
                try:
                    self._send(_publish_packet(entry[0], entry[1], entry[2], 1, pid, dup=True))
                    entry[3] = now
                except OSError:
                    break
            try:
                self.ping()
            except OSError:
                continue  # the reader notices and reconnects

    def _next_pid(self) -> int:
        with self._pid_lock:
            self._pid = (self._pid % 0xFFFF) + 1
            return self._pid

    # -- API ------------------------------------------------------------------
    def publish(self, topic: str, payload: bytes, retain: bool = False, qos: int = 0) -> None:
        if qos not in (0, 1):
            raise ValueError("only QoS 0/1 supported")
        if qos == 1:
            pid = self._next_pid()
            with self._pending_lock:
                if retain:
                    # last writer wins: a newer retained publish supersedes an
                    # unacknowledged one on the same topic, so an outage
                    # backlog holds one entry per retained topic
                    for old in [p for p, e in self._pending.items() if e[2] and e[0] == topic]:
                        del self._pending[old]
                        self.coalesced += 1
                self._pending[pid] = [topic, payload, retain, time.monotonic()]
            try:
                self._send(_publish_packet(topic, payload, retain, 1, pid))
            except OSError:
                if not self._reconnect_enabled:
                    with self._pending_lock:
                        self._pending.pop(pid, None)
                    raise
                # stays pending: redelivered after the reconnect
            return
        try:
            self._send(_publish_packet(topic, payload, retain))
        except OSError:
            if not self._reconnect_enabled:
                raise
            log.debug("QoS-0 publish dropped while reconnecting")

    def unacked(self) -> int:
        """Outstanding QoS-1 publishes (0 = everything acknowledged)."""
        with self._pending_lock:
            return len(self._pending)

    def drain(self, timeout_s: float = 5.0) -> int:
        """Wait up to ``timeout_s`` for every QoS-1 publish's PUBACK; returns
        how many are still unacknowledged (0 = clean)."""
        deadline = time.monotonic() + timeout_s
        while self.unacked() and time.monotonic() < deadline:
            time.sleep(0.005)
        return self.unacked()

    def _send_subscribe(self, pattern: str) -> None:
        var = (struct.pack(">H", self._next_pid()) + _mqtt_str(pattern)
               + bytes([self._sub_qos.get(pattern, 0)]))
        self._send(bytes([(SUBSCRIBE << 4) | 0x2]) + _encode_len(len(var)) + var)

    def subscribe(self, pattern: str, callback: Callable[[str, bytes], None],
                  qos: int = 0) -> None:
        if qos not in (0, 1):
            raise ValueError("only QoS 0/1 supported")
        self._subs[pattern] = callback
        self._sub_qos[pattern] = qos
        try:
            self._send_subscribe(pattern)
        except OSError:
            if not self._reconnect_enabled:
                raise
            # recorded: re-sent by _resume_session after the reconnect

    def ping(self) -> None:
        self._send(bytes([PINGREQ << 4, 0]))

    def close(self) -> None:
        self._stop.set()
        try:
            self._send(bytes([DISCONNECT << 4, 0]))
        except OSError:
            pass
        with self._wlock:
            sock, self._sock = self._sock, None
        if sock is not None:
            _close(sock)
        for t in (self._reader, self._pinger):
            if t is not threading.current_thread():
                t.join(timeout=5)

    # -- reader ---------------------------------------------------------------
    def _read_loop(self) -> None:
        while not self._stop.is_set():
            sock, rx = self._sock, self._rx  # replaced only by this thread's reconnect
            if sock is None:
                return
            try:
                ptype, flags, body = _read_packet(rx)
                self._last_rx = time.monotonic()
            except (ConnectionError, OSError):
                self.connected.clear()
                try:  # release the dead fd
                    sock.close()
                except OSError:
                    pass
                if self._stop.is_set() or not self._reconnect_enabled:
                    return
                self._reconnect_loop()
                continue
            if ptype == PUBACK and len(body) >= 2:
                with self._pending_lock:
                    self._pending.pop(struct.unpack(">H", body[:2])[0], None)
                continue
            if ptype != PUBLISH or not self._subs:
                continue
            try:
                topic, payload, pid = _parse_publish(flags, body)
            except MqttProtocolError as e:
                log.warning("client: dropping malformed PUBLISH: %s", e)
                continue
            if pid is not None:  # QoS-1 inbound: acknowledge
                try:
                    self._send(_puback(pid))
                except OSError:
                    pass
            for pattern, cb in list(self._subs.items()):
                if topic_matches(pattern, topic):
                    try:
                        cb(topic, payload)
                    except Exception:  # a subscriber's bug must not kill the reader
                        log.exception("mqtt subscribe callback failed")

"""Raw-TCP query transport: the copy-free data plane of tensor_query.

Port of ``nnstreamer_tpu/distributed/tcp_query.py``, byte for byte on the
wire (≙ the reference's nns-edge TCP framing, ``tensor_query_client.c``).
The gRPC transport (:mod:`.service`) stays the default for interop; this
one needs only ``socket`` and ``struct``.

* **TX is copy-free**: requests are gather-sent with ``socket.sendmsg``
  over the parts of :func:`.wire.encode_frame_parts`: payloads go to the
  kernel straight from the host arrays.
* **RX is one copy**: a fresh ``bytearray`` per message filled by
  ``recv_into``; :func:`.wire.decode_frame` then builds read-only numpy
  views into it.
* **A socket pool per client** (``nconns``): each in-flight request owns
  one socket for its round trip.

No thread of this module touches the card: the serversink brings answers
to the host before they reach a connection thread.

Socket protocol (little-endian):
  v1 framing: 1-byte type | u64 body_len | f64 deadline_s | body
  v2 framing: 1-byte type | u64 body_len | f64 deadline_s | u32 crc | body
              (crc = CRC-32 over the header with the crc field zeroed,
              then the body — message-level integrity, on top of the
              per-frame NNSQ v2 checksums inside 'Q' bodies)
  'H' handshake: body = caps utf-8; reply 'H' caps or 'E' error utf-8
  'Q' query:     body = NNSQ frame or NNSB/NNSC batch; reply 'Q' or 'E'
  'V' version:   body = ascii max version the sender speaks.  A v2
                 server replies 'V' with the AGREED version
                 (min of both maxes) and switches THAT connection to it
                 for all subsequent messages; a v1 peer answers 'E'
                 unknown-message-type, so the client stays on v1 —
                 zero-config interop both ways.
  'C' corrupt:   the request failed integrity verification (checksum
                 mismatch / malformed envelope).  The request provably
                 never executed, so clients treat it as a resend-safe
                 transient; the server connection stays alive.
  'G' goaway:    the server is DRAINING (rolling restart) and refused the
                 request before ingest; body = error text.  Provably
                 never executed — clients fail over to another host
                 immediately (no pacing, no breaker event).
``deadline_s`` carries the client's remaining timeout so the server-side
pipeline wait honors it (the gRPC transport gets the same via
``context.time_remaining()``); 0 on replies.
"""

from __future__ import annotations

import select
import socket
import struct
import threading
import time
import zlib
from typing import Dict, List, Optional, Tuple

from ..core.buffer import TensorFrame
from ..core.lifecycle import ServerGoawayError
from ..core.liveness import ServerBusyError
from ..core.log import get_logger
from ..core.resilience import FAULTS, RemoteApplicationError
from .wire import (
    V1,
    V2,
    WireCorruptionError,
    WireError,
    WireTruncationError,
    decode_frame,
    decode_frames,
    encode_frame_parts,
    encode_frames_parts,
    is_batch_payload,
    parts_nbytes,
)

log = get_logger("tcp_query")

#: highest message framing / envelope version this build speaks
WIRE_VERSION = V2

_HDR = struct.Struct("<BQd")     # v1 framing
_HDR2 = struct.Struct("<BQdI")   # v2: + u32 crc (header w/ crc zeroed + body)
_T_HANDSHAKE = ord("H")
_T_QUERY = ord("Q")
_T_ERROR = ord("E")
# admission control: the server REFUSED the request before ingest (load
# shed); body = ascii retry-after seconds.  Clients treat it as transient
# backpressure (ServerBusyError), never as remote ill-health.
_T_BUSY = ord("B")
# the server PIPELINE produced no answer in time.  Distinct from 'E' app
# errors because it IS a health signal: the client raises TimeoutError so
# breakers/cooldowns count it — the same classification this condition
# gets over gRPC (DEADLINE_EXCEEDED).
_T_TIMEOUT = ord("T")
# wire-version negotiation (see module docstring)
_T_VERSION = ord("V")
# rolling restart: the server is DRAINING and refused the request before
# ingest (core/lifecycle.py).  Provably never executed -> immediate
# resend-safe failover; unlike 'B' there is no pacing to honor and the
# reply is health (never a breaker event): the host is leaving, not sick.
_T_GOAWAY = ord("G")
# integrity: the request failed checksum/envelope verification before any
# execution — resend-safe; body = error text
_T_CORRUPT = ord("C")
# server-streaming invoke (continuous batching / tensor_generator): ONE
# request frame in, a sequence of 'S' replies out — each body one NNSQ
# answer frame — until a reply's meta carries ``final`` True (or no
# ``final`` key: a plain 1:1 graph answers once).  Errors keep their
# usual types ('B'/'G'/'C' before the first chunk, 'T' on a silent
# pipeline, 'E' app errors); the connection is HELD by the stream for
# its whole life (the client pool provides concurrency across streams).
_T_STREAM = ord("S")

# liveness bound for the server reader: a peer that begins a message and
# then stalls (no bytes) this long is dropped instead of wedging the
# connection thread until process exit
_MID_MSG_STALL_S = 30.0
# reply sends get a long-but-bounded timeout (big payloads on a slow
# link), distinct from the short recv poll used for idle detection
_SEND_TIMEOUT_S = 30.0

# one gather-send syscall tops out at IOV_MAX buffers; chunk above it
_IOV_MAX = 512

# refuse absurd peer-declared body lengths before allocating (matches the
# gRPC transport's 512 MB max_receive_message_length)
_MAX_BODY = 512 * 1024 * 1024


def _sendmsg_all(sock: socket.socket, parts: List) -> None:
    """Gather-send every buffer, handling partial sends without copying:
    a short write re-enters with the same memoryviews sliced forward."""
    bufs = [memoryview(p).cast("B") for p in parts if len(memoryview(p))]
    while bufs:
        sent = sock.sendmsg(bufs[:_IOV_MAX])
        if sent <= 0:
            raise ConnectionError("socket closed mid-send")
        # drop fully-sent buffers, slice the partially-sent one
        i = 0
        while i < len(bufs) and sent >= bufs[i].nbytes:
            sent -= bufs[i].nbytes
            i += 1
        bufs = bufs[i:]
        if sent and bufs:
            bufs[0] = bufs[0][sent:]


def _peer_closed(sock: socket.socket) -> bool:
    """True when an idle client socket has something to read: between
    replies that is only the peer's EOF or reset (or bytes of no request,
    which desync the framing), so the socket must not carry a request."""
    try:
        poller = select.poll()  # no fd ceiling, unlike select.select
        poller.register(sock, select.POLLIN)
        return bool(poller.poll(0))
    except (OSError, ValueError):  # closed: no fd left to poll
        return True


def _recv_exact(sock: socket.socket, n: int) -> memoryview:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:], n - got)
        if r == 0:
            raise ConnectionError("socket closed mid-receive")
        got += r
    return memoryview(buf)


def _await_readable(sock: socket.socket, wait_s: float, interrupted, addr: str) -> None:
    """Wait up to `wait_s` for `sock` to turn readable, polling
    `interrupted` first and then every 0.1 s; raises ``ConnectionError``
    once it is true."""
    until = time.monotonic() + wait_s
    while True:
        if interrupted():
            raise ConnectionError(f"stream to {addr} interrupted: the client is stopping")
        if select.select([sock], [], [], 0.1)[0] or time.monotonic() >= until:
            return


def _hdr_struct(version: int) -> struct.Struct:
    return _HDR2 if version >= V2 else _HDR


def _msg_crc(mtype: int, blen: int, deadline_s: float, parts: List) -> int:
    """v2 message checksum: header with the crc field zeroed, then every
    body part — one streaming pass, no copies."""
    crc = zlib.crc32(_HDR2.pack(mtype, blen, deadline_s, 0))
    for p in parts:
        crc = zlib.crc32(memoryview(p), crc)
    return crc


def _send_msg(sock: socket.socket, mtype: int, parts: List,
              deadline_s: float = 0.0, version: int = V1) -> None:
    n = parts_nbytes(parts)
    if version >= V2:
        head = _HDR2.pack(mtype, n, deadline_s,
                          _msg_crc(mtype, n, deadline_s, parts))
    else:
        head = _HDR.pack(mtype, n, deadline_s)
    _sendmsg_all(sock, [head] + parts)


def _parse_head(head, version: int) -> Tuple[int, int, float, Optional[int]]:
    """Unpack + bounds-check one message header (both framings); the
    declared body length is validated BEFORE any allocation."""
    if version >= V2:
        mtype, blen, deadline_s, crc = _HDR2.unpack(head)
    else:
        mtype, blen, deadline_s = _HDR.unpack(head)
        crc = None
    if blen > _MAX_BODY:
        raise WireCorruptionError(
            f"declared body length {blen} exceeds {_MAX_BODY}")
    return mtype, blen, deadline_s, crc


def _verify_msg(mtype: int, blen: int, deadline_s: float,
                crc: Optional[int], body) -> None:
    if crc is None:
        return
    actual = _msg_crc(mtype, blen, deadline_s, [body])
    if actual != crc:
        raise WireCorruptionError(
            f"message checksum mismatch (crc32 {actual:#010x} != "
            f"declared {crc:#010x})"
        )


def encode_msg(mtype: int, body: bytes, deadline_s: float = 0.0,
               version: int = V1) -> bytes:
    """One complete message as bytes."""
    n = len(body)
    if version >= V2:
        return _HDR2.pack(mtype, n, deadline_s,
                          _msg_crc(mtype, n, deadline_s, [body])) + body
    return _HDR.pack(mtype, n, deadline_s) + body


def parse_msg(data, version: int = V1,
              verify: bool = True) -> Tuple[int, memoryview, float]:
    """Pure-bytes inverse of :func:`encode_msg`: parse ONE complete
    message from a byte string with the same typed-error bounds contract
    as the socket readers."""
    mv = memoryview(data)
    hs = _hdr_struct(version)
    if len(mv) < hs.size:
        raise WireTruncationError(
            f"truncated message header: {len(mv)}/{hs.size} bytes")
    mtype, blen, deadline_s, crc = _parse_head(bytes(mv[:hs.size]), version)
    body = mv[hs.size:]
    if len(body) != blen:
        raise WireTruncationError(
            f"message body {len(body)}B != declared {blen}B")
    if verify:
        _verify_msg(mtype, blen, deadline_s, crc, body)
    return mtype, body, deadline_s


def _recv_msg(sock: socket.socket, version: int = V1,
              verify: bool = True) -> Tuple[int, memoryview, float]:
    head = _recv_exact(sock, _hdr_struct(version).size)
    mtype, blen, deadline_s, crc = _parse_head(head, version)
    body = _recv_exact(sock, blen)
    if verify:
        _verify_msg(mtype, blen, deadline_s, crc, body)
    return mtype, body, deadline_s


def _recv_exact_bounded(sock: socket.socket, n: int, stop: threading.Event,
                        idle_ok: bool = False) -> memoryview:
    """``_recv_exact`` for the server reader thread: the socket carries a
    short poll timeout, so idle waits stay responsive to `stop`, and a
    peer that goes silent MID-read for ``_MID_MSG_STALL_S`` is treated
    as broken (no unbounded blocking in the reader).  ``idle_ok`` = message-boundary
    read: the stall bound only starts once the first byte arrives (an
    idle connection may legitimately wait forever, polling `stop`)."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    last_progress = None if idle_ok else time.monotonic()
    while got < n:
        try:
            r = sock.recv_into(view[got:], n - got)
        except socket.timeout:
            if stop.is_set():
                raise ConnectionError("server stopping") from None
            if (last_progress is not None
                    and time.monotonic() - last_progress >= _MID_MSG_STALL_S):
                raise ConnectionError(
                    f"peer stalled mid-message ({got}/{n} bytes)"
                ) from None
            continue
        if r == 0:
            raise ConnectionError("socket closed mid-receive")
        got += r
        last_progress = time.monotonic()
    return memoryview(buf)


def _recv_msg_bounded(sock: socket.socket, stop: threading.Event,
                      version: int = V1,
                      verify: bool = True) -> Tuple[int, memoryview, float]:
    """Server-side ``_recv_msg`` with liveness bounds: blocks
    indefinitely only BETWEEN messages (polling `stop`); within one it
    inherits the mid-message stall bound."""
    head = _recv_exact_bounded(
        sock, _hdr_struct(version).size, stop, idle_ok=True)
    mtype, blen, deadline_s, crc = _parse_head(head, version)
    body = _recv_exact_bounded(sock, blen, stop)
    if verify:
        _verify_msg(mtype, blen, deadline_s, crc, body)
    return mtype, body, deadline_s


class TcpQueryConnection:
    """Client side: a pool of persistent sockets to one server.

    API-compatible with :class:`.service.QueryConnection` (handshake /
    invoke / invoke_batch / close / addr), so the query client element
    swaps transports by construction only.
    """

    def __init__(self, host: str, port: int, timeout: float = 10.0,
                 nconns: int = 4, wire_version: int = WIRE_VERSION,
                 verify_checksum: bool = True):
        self.addr = f"{host}:{port}"
        self._host, self._port = host, port
        self._timeout = timeout
        self._nconns = max(1, nconns)
        self._free: List[socket.socket] = []
        self._live = 0
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._closed = False
        # integrity / negotiation state: every fresh socket that may
        # speak v2 sends a 'V' probe at dial time; a v1 peer's 'E' reply
        # latches _peer_v1 so later dials skip the probe round trip.
        # _sock_ver maps each pooled socket to ITS negotiated framing
        # (single dict ops — GIL-atomic, no extra lock needed).
        self._wire_version = V2 if int(wire_version) >= V2 else V1
        self._verify = bool(verify_checksum)
        self._peer_v1 = self._wire_version == V1
        self._sock_ver: Dict[socket.socket, int] = {}
        # sockets currently checked out to callers: close() force-closes
        # them too, so an in-flight STREAM dies with its client element
        # (the server sees the break and cancels the generation) instead
        # of outliving it until the consumer generator is collected
        self._held: set = set()

    # -- socket pool --------------------------------------------------------
    def _negotiate(self, sock: socket.socket) -> int:
        """Upgrade one fresh socket to v2 framing: 'V' probe sent in v1
        framing.  A v2 server replies 'V' and switches that connection;
        a v1 peer replies 'E' unknown-message-type — stay on v1."""
        _send_msg(sock, _T_VERSION, [str(WIRE_VERSION).encode()], version=V1)
        rtype, body, _ = _recv_msg(sock, version=V1)
        if rtype != _T_VERSION:
            return V1
        try:
            peer = int(bytes(body) or b"1")
        except ValueError:
            return V1
        return V2 if peer >= V2 else V1

    def _connect(self) -> socket.socket:
        sock = socket.create_connection(
            (self._host, self._port), timeout=self._timeout)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        ver = V1
        if self._wire_version >= V2 and not self._peer_v1:
            try:
                ver = self._negotiate(sock)
            except (ConnectionError, OSError):
                try:
                    sock.close()
                except OSError:
                    pass
                raise
            if ver == V1:
                # benign race between concurrent dialers: worst case a
                # few extra probes before everyone learns the peer is v1
                self._peer_v1 = True
        self._sock_ver[sock] = ver
        return sock

    def _checkout(self, timeout: float,
                  fresh: bool = False) -> Tuple[socket.socket, bool]:
        """Returns ``(sock, reused)`` — `reused` means the socket came
        from the idle pool and may have gone stale while parked (the
        peer can close an idle connection at any time); `_roundtrip`
        uses it to decide whether a send-phase failure merits one
        fresh-dial retry.  ``fresh=True`` (the retry) guarantees a NEW
        dial: the idle pool is drained and closed first — a send failure
        on one parked socket means the peer restarted, so every other
        parked socket is equally suspect."""
        with self._cv:
            while True:
                if self._closed:
                    raise ConnectionError("connection closed")
                if fresh:
                    while self._free:
                        stale = self._free.pop()
                        self._live -= 1
                        self._sock_ver.pop(stale, None)
                        try:
                            stale.close()
                        except OSError:
                            pass
                elif self._free:
                    sock = self._free.pop()
                    if _peer_closed(sock):
                        # the server closed it while parked (stopped after
                        # a drain): a request sent on it would reach no
                        # server, so dial afresh, where a stopped server
                        # refuses before anything is sent
                        self._live -= 1
                        self._sock_ver.pop(sock, None)
                        try:
                            sock.close()
                        except OSError:
                            pass
                        continue
                    self._held.add(sock)
                    return sock, True
                if self._live < self._nconns:
                    self._live += 1
                    break
                if not self._cv.wait(timeout):
                    raise TimeoutError(
                        f"no free connection to {self.addr} in {timeout}s")
        try:
            sock = self._connect()
        except Exception:
            with self._cv:
                self._live -= 1
                self._cv.notify()
            raise
        with self._cv:
            if self._closed:
                # close() ran while we dialed: don't leak a live socket
                self._live -= 1
                self._sock_ver.pop(sock, None)
                try:
                    sock.close()
                except OSError:
                    pass
                self._cv.notify()
                raise ConnectionError("connection closed")
            self._held.add(sock)
        return sock, False

    def _checkin(self, sock: socket.socket, broken: bool) -> None:
        with self._cv:
            self._held.discard(sock)
            if broken or self._closed:
                self._live -= 1
                self._sock_ver.pop(sock, None)
                try:
                    sock.close()
                except OSError:
                    pass
            else:
                self._free.append(sock)
            self._cv.notify()

    def _roundtrip(self, mtype: int, make_parts,
                   timeout: Optional[float]) -> Tuple[int, memoryview]:
        """One request/response exchange.  ``make_parts(version)`` builds
        the body parts for the framing the checked-out socket negotiated
        (a v1 peer must receive v1-encoded frames).

        Failure contract: a socket that raised during send OR recv is closed and evicted
        from the pool (``broken=True`` checkin), never handed to the
        next caller.  A send-phase failure on a REUSED socket gets one
        retry on a fresh dial: an idle pooled connection the peer
        half-closed fails exactly there, and an incompletely-sent
        request provably never executed server-side, so the resend is
        safe even at-most-once.  Recv-phase failures are never retried
        here — the server may already have processed the request; the
        caller's retry policy owns that decision."""
        timeout = self._timeout if timeout is None else timeout
        for attempt in (0, 1):
            sock, reused = self._checkout(timeout, fresh=(attempt == 1))
            ver = self._sock_ver.get(sock, V1)
            broken = True
            sent = False
            try:
                sock.settimeout(timeout)
                FAULTS.check("tcp_query.send")
                send_parts = make_parts(ver)
                if FAULTS.is_armed():
                    # corrupt= faults mutate the encoded request AFTER its
                    # checksums were computed (wire-corruption simulation:
                    # the server's verify-on-decode must catch it)
                    send_parts = FAULTS.mangle_parts(
                        "tcp_query.send", send_parts)
                _send_msg(sock, mtype, send_parts,
                          deadline_s=timeout, version=ver)
                sent = True
                FAULTS.check("tcp_query.recv")
                rtype, body, _ = _recv_msg(sock, version=ver,
                                           verify=self._verify)
                if FAULTS.is_armed():
                    # reply-path corruption lands AFTER the message-level
                    # check — the frame-level checksum inside the body is
                    # what must catch it at decode
                    body = FAULTS.mangle("tcp_query.recv", body)
                # a 'C' reply to a corrupt MESSAGE comes from a server that
                # then drops the connection (its framing may be lost), so
                # the socket is not pooled: the resend dials afresh instead
                # of failing on a closed socket
                broken = rtype == _T_CORRUPT
                return rtype, body
            except (ConnectionError, OSError) as e:
                if (attempt == 0 and reused and not sent
                        and not isinstance(e, TimeoutError)):
                    log.debug(
                        "stale pooled socket to %s (%s); retrying on a "
                        "fresh connection", self.addr, e)
                    continue
                raise
            finally:
                self._checkin(sock, broken)
        raise AssertionError("unreachable")  # loop always returns/raises

    # -- public API ---------------------------------------------------------
    @staticmethod
    def _check_reply(rtype: int, body: memoryview) -> None:
        if rtype == _T_GOAWAY:
            # the server is draining (rolling restart): the request
            # provably never executed — the client fails over to another
            # host immediately, with no pacing and no breaker event
            raise ServerGoawayError(bytes(body).decode() or
                                    "server draining (goaway)")
        if rtype == _T_CORRUPT:
            # the server refused a request that failed integrity checks:
            # provably never executed, so resend-safe — the query client
            # retries it on its corrupt-retries budget and counts it
            raise WireCorruptionError(bytes(body).decode())
        if rtype == _T_BUSY:
            # admission shed: provably never executed, safe to re-send
            try:
                retry_after = float(bytes(body).decode() or 0.05)
            except ValueError:
                retry_after = 0.05
            raise ServerBusyError(retry_after=retry_after)
        if rtype == _T_TIMEOUT:
            # server pipeline timeout: ill-health, NOT an app reply —
            # must reach breakers/cooldowns (gRPC parity:
            # DEADLINE_EXCEEDED)
            raise TimeoutError(bytes(body).decode())
        if rtype == _T_ERROR:
            # RemoteApplicationError (a RuntimeError): the server is UP
            # and answered — health machinery must not count this
            raise RemoteApplicationError(bytes(body).decode())

    def handshake(self, caps: str) -> str:
        rtype, body = self._roundtrip(
            _T_HANDSHAKE, lambda ver: [caps.encode()], None)
        self._check_reply(rtype, body)
        return bytes(body).decode()

    def invoke(self, frame: TensorFrame,
               timeout: Optional[float] = None) -> TensorFrame:
        rtype, body = self._roundtrip(
            _T_QUERY,
            lambda ver: encode_frame_parts(frame, version=ver),
            timeout)
        self._check_reply(rtype, body)
        return decode_frame(body, verify=self._verify)

    def invoke_batch(self, frames: List[TensorFrame],
                     timeout: Optional[float] = None) -> List[TensorFrame]:
        rtype, body = self._roundtrip(
            _T_QUERY,
            lambda ver: encode_frames_parts(frames, version=ver),
            timeout)
        self._check_reply(rtype, body)
        return decode_frames(body, verify=self._verify)

    def invoke_stream(self, frame: TensorFrame,
                      timeout: Optional[float] = None, interrupted=None):
        """Server-streaming invoke over raw TCP ('S' message): yields
        answer frames as they arrive until one is final-flagged (or has
        no ``final`` meta).  ``timeout`` bounds the WHOLE stream; one
        pooled socket is held for its duration (API parity with
        :meth:`.service.QueryConnection.invoke_stream`).

        Failure contract: a send-phase failure on a REUSED socket gets
        one fresh-dial retry (the request provably never executed);
        anything after the send follows the stream rules — typed refusal
        replies ('B'/'G'/'C'/'T'/'E') leave the socket aligned and
        poolable, a transport break or an abandoned stream evicts it.

        ``interrupted`` (a callable) is polled every 0.1 s while a chunk is
        awaited: when it turns true (the client element is stopping) the
        stream ends with ``ConnectionError`` and its socket is closed, so
        the server sees the client gone at its next chunk."""
        timeout = self._timeout if timeout is None else timeout
        for attempt in (0, 1):
            sock, reused = self._checkout(timeout, fresh=(attempt == 1))
            ver = self._sock_ver.get(sock, V1)
            broken = True
            sent = False
            try:
                sock.settimeout(timeout)
                FAULTS.check("tcp_query.send")
                parts = encode_frame_parts(frame, version=ver)
                if FAULTS.is_armed():
                    parts = FAULTS.mangle_parts("tcp_query.send", parts)
                _send_msg(sock, _T_STREAM, parts,
                          deadline_s=timeout, version=ver)
                sent = True
                FAULTS.check("tcp_query.recv")
                deadline = time.monotonic() + timeout
                while True:
                    # the WHOLE-stream budget is a hard bound (gRPC
                    # parity: the RPC deadline kills the stream): a
                    # server still producing chunks past it must not
                    # keep the stream alive through per-recv grace
                    if time.monotonic() >= deadline:
                        raise TimeoutError(
                            f"stream to {self.addr} exceeded its "
                            f"{timeout}s budget")
                    if interrupted is not None:
                        _await_readable(sock, max(0.05, deadline - time.monotonic()),
                                        interrupted, self.addr)
                    # each chunk wait is carved from the stream budget
                    sock.settimeout(
                        max(0.05, deadline - time.monotonic()))
                    try:
                        rtype, body, _ = _recv_msg(
                            sock, version=ver, verify=self._verify)
                    except socket.timeout:
                        raise TimeoutError(
                            f"stream to {self.addr}: no (further) answer "
                            f"within the {timeout}s budget") from None
                    if FAULTS.is_armed():
                        body = FAULTS.mangle("tcp_query.recv", body)
                    if rtype != _T_STREAM:
                        # typed refusal/timeout reply: the framing is
                        # intact — socket back to the pool (but for 'C',
                        # see _roundtrip), error raised
                        broken = rtype == _T_CORRUPT
                        self._check_reply(rtype, body)
                        raise RemoteApplicationError(
                            f"unexpected stream reply type {rtype}")
                    ans = decode_frame(body, verify=self._verify)
                    if ans.meta.get("final", True):
                        broken = False  # clean completion
                        yield ans
                        return
                    yield ans
            except (ConnectionError, OSError) as e:
                if (attempt == 0 and reused and not sent
                        and not isinstance(e, TimeoutError)):
                    log.debug(
                        "stale pooled socket to %s (%s); retrying stream "
                        "on a fresh connection", self.addr, e)
                    continue
                raise
            finally:
                self._checkin(sock, broken)
            return

    def close(self) -> None:
        with self._cv:
            self._closed = True
            socks, self._free = self._free, []
            # force-close HELD sockets too: the caller blocked on them
            # gets a prompt OSError (its checkin then evicts the entry),
            # and a server streaming into one sees the break and cancels
            # the generation — a stopped client must look dead, not idle
            socks.extend(self._held)
            self._sock_ver.clear()
            self._cv.notify_all()
        for s in socks:
            try:
                s.close()
            except OSError:
                pass


class TcpQueryServer:
    """Server side: accept loop + one reader thread per connection, all
    funnelling into the shared :class:`.service.QueryServerCore` (same
    ingress queue / pending table / caps logic as the gRPC transport)."""

    def __init__(self, core, host: str = "", port: int = 0,
                 wire_version: int = WIRE_VERSION,
                 verify_checksum: bool = True):
        self._core = core
        self._host = host or "0.0.0.0"
        self.port = port
        self._listener: Optional[socket.socket] = None
        self._accept_thread: Optional[threading.Thread] = None
        self._conn_threads: List[threading.Thread] = []
        self._conns: List[socket.socket] = []
        self._conns_lock = threading.Lock()
        self._stop = threading.Event()
        # wire_version=1 pins LEGACY behavior (pre-checksum framing, 'V'
        # probes answered 'E') — the stand-in for a v1 peer in interop
        # tests and the rollback knob in mixed fleets
        self._wire_version = V2 if int(wire_version) >= V2 else V1
        self._verify = bool(verify_checksum)
        #: corrupt requests answered with 'C' (the server stayed alive)
        self.corruption_detected = 0

    def _note_corrupt(self, err: WireError) -> None:
        self.corruption_detected += 1
        if hasattr(self._core, "corrupt_requests"):
            self._core.corrupt_requests += 1
        log.warning("corrupt request refused ('C' reply): %s", err)

    def start(self) -> None:
        if self._listener is not None:
            return
        ls = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        ls.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        ls.bind((self._host, self.port))
        ls.listen(64)
        ls.settimeout(0.2)
        self.port = ls.getsockname()[1]
        self._listener = ls
        self._stop.clear()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="tcpq-accept", daemon=True)
        self._accept_thread.start()
        log.info("tcp query server on :%d", self.port)

    def close_listener(self) -> None:
        """Rolling-restart drain: stop ACCEPTING (listener closed, accept
        thread joined) while existing connection readers keep serving —
        a drained server must never cut a final in-flight reply mid-send.
        ``start()`` re-binds the same port afterwards."""
        ls = self._listener
        if ls is not None:
            try:
                ls.close()
            except OSError:
                pass
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=2)
            self._accept_thread = None
        self._listener = None
        log.info("tcp query server :%d stopped accepting (drained)",
                 self.port)

    def stop(self) -> None:
        self._stop.set()
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
            self._listener = None
        with self._conns_lock:
            conns, self._conns = self._conns, []
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=2)
            self._accept_thread = None
        for t in self._conn_threads:
            t.join(timeout=2)
        self._conn_threads = []

    # -- internals ----------------------------------------------------------
    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _addr = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return  # listener closed
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            # short poll timeout: the reader thread must never block
            # unbounded (idle waits poll the stop flag; mid-message
            # stalls are bounded by _recv_msg_bounded)
            conn.settimeout(0.5)
            with self._conns_lock:
                self._conns.append(conn)
            # prune finished handler threads (connection churn must not
            # accumulate dead Thread objects for the server's lifetime)
            self._conn_threads = [t for t in self._conn_threads
                                  if t.is_alive()]
            t = threading.Thread(
                target=self._serve_conn, args=(conn,),
                name="tcpq-conn", daemon=True)
            t.start()
            self._conn_threads.append(t)

    def _reply(self, conn: socket.socket, mtype: int, parts: List,
               version: int = V1) -> None:
        """Send one reply under the send timeout, then restore the short
        recv-poll timeout (settimeout governs BOTH directions)."""
        conn.settimeout(_SEND_TIMEOUT_S)
        try:
            _send_msg(conn, mtype, parts, version=version)
        finally:
            conn.settimeout(0.5)

    def _serve_conn(self, conn: socket.socket) -> None:
        # every connection starts in v1 framing; a 'V' message upgrades
        # it (and the frames inside replies) for the rest of its life
        conn_ver = V1
        try:
            while not self._stop.is_set():
                try:
                    mtype, body, deadline_s = _recv_msg_bounded(
                        conn, self._stop, version=conn_ver,
                        verify=self._verify)
                except WireCorruptionError as e:
                    # message-level corruption: the declared length was
                    # honored so WE survived, but a corrupted header may
                    # have desynced the stream — tell the peer ('C',
                    # resend-safe) and drop this connection only
                    self._note_corrupt(e)
                    try:
                        self._reply(conn, _T_CORRUPT, [str(e).encode()],
                                    conn_ver)
                    except OSError:
                        pass
                    return
                except WireError as e:
                    # unparseable/oversized header: tell the peer and drop
                    # the connection (framing is lost at this point)
                    try:
                        self._reply(conn, _T_ERROR, [str(e).encode()],
                                    conn_ver)
                    except OSError:
                        pass
                    return
                except (ConnectionError, OSError):
                    return
                try:
                    if mtype == _T_VERSION and self._wire_version >= V2:
                        # negotiate: answer in the CURRENT framing, then
                        # upgrade to min(peer max, our max) — a peer that
                        # advertises only v1 stays on v1 framing (a
                        # v1-pinned SERVER falls through to
                        # unknown-message-type below, exactly like a
                        # true legacy peer)
                        try:
                            peer = int(bytes(body) or b"1")
                        except ValueError:
                            peer = V1
                        agreed = V2 if peer >= V2 else V1
                        self._reply(
                            conn, _T_VERSION,
                            [str(agreed).encode()], conn_ver)
                        conn_ver = agreed
                    elif mtype == _T_HANDSHAKE:
                        try:
                            caps = self._core.check_caps(bytes(body).decode())
                            self._reply(conn, _T_HANDSHAKE, [caps.encode()],
                                        conn_ver)
                        except ValueError as e:
                            self._reply(conn, _T_ERROR, [str(e).encode()],
                                        conn_ver)
                    elif mtype == _T_QUERY:
                        batched = is_batch_payload(body)
                        try:
                            frames = (
                                decode_frames(body, verify=self._verify)
                                if batched
                                else [decode_frame(body, verify=self._verify)]
                            )
                        except WireError as e:
                            # frame-level corruption/truncation: the
                            # request never executed — answer 'C' and KEEP
                            # SERVING (framing is intact; hostile or
                            # corrupted payloads must not kill the reader)
                            self._note_corrupt(e)
                            self._reply(conn, _T_CORRUPT, [str(e).encode()],
                                        conn_ver)
                            continue
                        try:
                            answers = self._core.process(
                                frames,
                                deadline_s if deadline_s > 0 else 30.0)
                        except TimeoutError as e:
                            # caught HERE, not at the message boundary:
                            # socket.timeout from the reply sends below is
                            # the same class and must stay an OSError-path
                            # connection drop, not a 'T' reply
                            self._reply(conn, _T_TIMEOUT, [str(e).encode()],
                                        conn_ver)
                            continue
                        parts = (
                            encode_frames_parts(answers, version=conn_ver)
                            if batched
                            else encode_frame_parts(answers[0],
                                                    version=conn_ver)
                        )
                        self._reply(conn, _T_QUERY, parts, conn_ver)
                    elif mtype == _T_STREAM:
                        try:
                            frame = decode_frame(body, verify=self._verify)
                        except WireError as e:
                            self._note_corrupt(e)
                            self._reply(conn, _T_CORRUPT, [str(e).encode()],
                                        conn_ver)
                            continue
                        gen = self._core.process_stream(
                            frame, deadline_s if deadline_s > 0 else 30.0)
                        try:
                            while True:
                                try:
                                    ans = next(gen)
                                except StopIteration:
                                    break
                                except TimeoutError as e:
                                    # scoped to the GENERATOR only: a
                                    # socket.timeout from the chunk
                                    # sends below is a TimeoutError too
                                    # and must stay an OSError-path
                                    # connection drop, not a 'T' reply
                                    # on a wedged socket (same contract
                                    # as the unary handler)
                                    self._reply(conn, _T_TIMEOUT,
                                                [str(e).encode()],
                                                conn_ver)
                                    break
                                self._reply(
                                    conn, _T_STREAM,
                                    encode_frame_parts(ans,
                                                       version=conn_ver),
                                    conn_ver)
                        finally:
                            # a peer that died mid-stream breaks the
                            # reply send (OSError path below): closing
                            # the generator HERE frees the pending slot
                            # + admission deterministically, so the next
                            # chunk delivery sees client-gone and the
                            # generation stream is cancelled upstream
                            gen.close()
                    else:
                        self._reply(
                            conn, _T_ERROR,
                            [f"unknown message type {mtype}".encode()],
                            conn_ver)
                except ServerGoawayError as e:
                    # rolling restart: draining — refuse before ingest;
                    # the connection stays alive so in-flight replies on
                    # it still complete
                    try:
                        self._reply(conn, _T_GOAWAY, [str(e).encode()],
                                    conn_ver)
                    except OSError:
                        return
                except ServerBusyError as e:
                    # admission shed: the cheapest possible reply — the
                    # request never touched the pipeline
                    try:
                        self._reply(conn, _T_BUSY,
                                    [f"{e.retry_after:.6f}".encode()],
                                    conn_ver)
                    except OSError:
                        return
                except OSError:
                    return  # peer gone mid-reply
                except Exception as e:  # noqa: BLE001 — transport boundary:
                    # any pipeline-side failure (timeout, full ingress,
                    # malformed frame) becomes a protocol error reply; the
                    # connection and its socket survive
                    try:
                        self._reply(conn, _T_ERROR, [str(e).encode()],
                                    conn_ver)
                    except OSError:
                        return
        finally:
            with self._conns_lock:
                if conn in self._conns:
                    self._conns.remove(conn)
            try:
                conn.close()
            except OSError:
                pass

"""Port parity for the raw-TCP query transport (``distributed/tcp_query.py``)
and the wire's multi-frame envelope (``distributed/wire.py``).

Byte parity with the JAX package for the same frames and messages; typed
truth tables at every field boundary (truncation, oversize and
contradicting lengths, checksums); the 'V' negotiation matrix across
versions and across the two packages; hostile input that the server
survives; corrupt faults at ``tcp_query.send``/``recv`` counted exactly.
Mirrors the contracts of the JAX ``tests/test_wire_integrity.py`` and
``tests/test_distributed.py::TestTcpQueryTransport``.  Every server binds
port 0 on 127.0.0.1 and stops in a ``finally``; the module's census
checks that no thread or socket outlives it.
"""

import socket
import struct
import threading
import time

import numpy as np
import pytest
import torch

from nnstreamer_tpu.core.buffer import TensorFrame as JFrame
from nnstreamer_tpu.distributed import tcp_query as jtq
from nnstreamer_tpu.distributed import wire as jwire
from nnstreamer_tpu_torch.core.buffer import TensorFrame
from nnstreamer_tpu_torch.core.resilience import FAULTS, is_transient
from nnstreamer_tpu_torch.distributed import tcp_query as tq
from nnstreamer_tpu_torch.distributed import wire
from nnstreamer_tpu_torch.distributed.wire import (
    WireCorruptionError,
    WireError,
    WireTruncationError,
)
from nnstreamer_tpu_torch.pipeline import parse_pipeline
from torch_census import module_leak_check  # noqa: F401

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _reset_faults():
    FAULTS.reset()
    yield
    FAULTS.reset()


def frame(v=1.0, n=4, cls=TensorFrame, seq=7):
    f = cls([np.full((n,), v, np.float32)], pts=0.5, meta={"tag": "t"})
    f.seq = seq
    return f


def frames_pair(k=3):
    """The same k frames (payload, pts, meta, seq) in both packages."""
    rng = np.random.default_rng(5)
    out = []
    for i in range(k):
        arrs = [rng.standard_normal((2, i + 1)).astype(np.float32),
                rng.integers(0, 255, (3,), dtype=np.uint8)]
        pair = []
        for cls in (TensorFrame, JFrame):
            f = cls(list(arrs), pts=None if i == 1 else float(i), meta={"i": i, "s": "x" * i})
            f.seq = 100 + i
            pair.append(f)
        out.append(pair)
    return [p[0] for p in out], [p[1] for p in out]


# -- the envelope: bytes, parts, truth tables ----------------------------------
@pytest.mark.parametrize("version", [1, 2])
def test_batch_envelope_bytes_equal_jax(version):
    port, jax = frames_pair(3)
    got = wire.encode_frames(port, version=version)
    assert got == jwire.encode_frames(jax, version=version)
    parts = wire.encode_frames_parts(port, version=version)
    assert b"".join(bytes(p) for p in parts) == got
    assert wire.parts_nbytes(parts) == len(got)
    assert wire.is_batch_payload(got) and not wire.is_batch_payload(wire.encode_frame(port[0]))
    back = wire.decode_frames(got)
    jback = jwire.decode_frames(got)
    assert len(back) == 3
    for b, j, f in zip(back, jback, port):
        assert (b.pts, b.meta, b.seq) == (j.pts, j.meta, j.seq) == (f.pts, f.meta, f.seq)
        for x, y in zip(b.tensors, f.tensors):
            np.testing.assert_array_equal(x, y)
            assert not x.flags.writeable


@pytest.mark.parametrize("version", [1, 2])
def test_frame_parts_are_views_not_copies(version):
    f = frame(3.0, n=1024)
    parts = wire.encode_frame_parts(f, version=version)
    assert b"".join(bytes(p) for p in parts) == wire.encode_frame(f, version=version)
    assert wire.encode_frame(f, version=version) == jwire.encode_frame(
        frame(3.0, n=1024, cls=JFrame), version=version)
    payload = [p for p in parts if isinstance(p, memoryview)]
    assert len(payload) == 1 and payload[0].obj is not None
    assert np.shares_memory(np.frombuffer(payload[0], np.float32), f.tensors[0])


def test_bad_version_refused():
    with pytest.raises(WireError, match="cannot encode wire version"):
        wire.encode_frames_parts([frame()], version=3)


def test_empty_batch_roundtrip():
    for v in (1, 2):
        buf = wire.encode_frames([], version=v)
        assert buf == jwire.encode_frames([], version=v)
        assert wire.decode_frames(buf) == []


def _skeleton_offsets(buf):
    """Byte offsets of the v2 envelope's skeleton (header and length
    prefixes), which the batch CRC covers."""
    count = struct.unpack_from("<H", buf, 4)[0]
    offs = list(range(10))
    o = 10
    for _ in range(count):
        offs += range(o, o + 8)
        o += 8 + struct.unpack_from("<Q", buf, o)[0]
    return offs


def _same_error(fn_port, fn_jax):
    """Both packages raise the same typed error class and message."""
    with pytest.raises(WireError) as ep:
        fn_port()
    with pytest.raises(jwire.WireError) as ej:
        fn_jax()
    assert type(ep.value).__name__ == type(ej.value).__name__
    assert str(ep.value) == str(ej.value)
    assert is_transient(ep.value)
    return ep.value


def test_batch_skeleton_crc_every_byte():
    port, _ = frames_pair(2)
    buf = wire.encode_frames(port, version=2)
    for off in _skeleton_offsets(buf):
        bad = bytearray(buf)
        bad[off] ^= 0x10
        _same_error(lambda: wire.decode_frames(bytes(bad)), lambda: jwire.decode_frames(bytes(bad)))
    # a payload bit inside a frame: its own v2 checksum catches it
    bad = bytearray(buf)
    bad[-1] ^= 1
    err = _same_error(lambda: wire.decode_frames(bytes(bad)), lambda: jwire.decode_frames(bytes(bad)))
    assert isinstance(err, WireCorruptionError)


@pytest.mark.parametrize("version", [1, 2])
def test_batch_truncation_at_every_skeleton_boundary(version):
    port, _ = frames_pair(2)
    buf = wire.encode_frames(port, version=version)
    head = 6 if version == 1 else 10
    first = struct.unpack_from("<Q", buf, head)[0]
    cuts = [0, 3, 4, head - 1, head, head + 7, head + 8, head + 8 + first - 1,
            head + 8 + first, head + 8 + first + 7, len(buf) - 1]
    for cut in cuts:
        err = _same_error(lambda: wire.decode_frames(buf[:cut]),
                          lambda: jwire.decode_frames(buf[:cut]))
        assert isinstance(err, (WireTruncationError, WireCorruptionError))


def test_batch_truth_table():
    port, _ = frames_pair(2)
    v1 = bytes(wire.encode_frames(port, version=1))
    cases = {
        "magic": b"XXXX" + v1[4:],
        "count": struct.pack("<IH", 0x4E4E5342, 3) + v1[6:],
        "cap": v1[:6] + struct.pack("<Q", wire.MAX_BODY + 1) + v1[14:],
        "beyond": v1[:6] + struct.pack("<Q", len(v1)) + v1[14:],
        "trailing": v1 + b"\x00",
    }
    want = {"magic": WireCorruptionError, "count": WireTruncationError,
            "cap": WireCorruptionError, "beyond": WireTruncationError,
            "trailing": WireCorruptionError}
    for name, buf in cases.items():
        err = _same_error(lambda: wire.decode_frames(buf), lambda: jwire.decode_frames(buf))
        assert isinstance(err, want[name]), name
    # verify off: a v2 skeleton flip is read structurally
    v2 = bytearray(wire.encode_frames(port, version=2))
    v2[6] ^= 1  # inside the crc field
    assert len(wire.decode_frames(bytes(v2), verify=False)) == 2


# -- message framing -----------------------------------------------------------
MSGS = [(ord("Q"), b"", 0.0), (ord("H"), b"other/tensors", 2.5),
        (ord("S"), bytes(range(200)), 1e-3), (ord("V"), b"2", 0.0)]


@pytest.mark.parametrize("version", [1, 2])
@pytest.mark.parametrize("msg", range(len(MSGS)))
def test_msg_bytes_equal_jax_and_roundtrip(version, msg):
    mtype, body, dl = MSGS[msg]
    got = tq.encode_msg(mtype, body, dl, version=version)
    assert got == jtq.encode_msg(mtype, body, dl, version=version)
    t, b, d = tq.parse_msg(got, version=version)
    assert (t, bytes(b), d) == (mtype, body, dl)


@pytest.mark.parametrize("version", [1, 2])
def test_msg_truncation_at_every_byte(version):
    msg = tq.encode_msg(ord("Q"), b"abcdef", 1.0, version=version)
    for cut in range(len(msg)):
        err = _same_error(lambda: tq.parse_msg(msg[:cut], version=version),
                          lambda: jtq.parse_msg(msg[:cut], version=version))
        assert isinstance(err, WireTruncationError)


def test_msg_crc_every_byte_and_oversize():
    msg = tq.encode_msg(ord("Q"), b"abcdef", 2.0, version=2)
    for off in range(len(msg)):
        bad = bytearray(msg)
        bad[off] ^= 0x01
        if off in range(1, 9):  # body_len: the length check speaks first
            with pytest.raises(WireError):
                tq.parse_msg(bytes(bad), version=2)
            continue
        _same_error(lambda: tq.parse_msg(bytes(bad), version=2),
                    lambda: jtq.parse_msg(bytes(bad), version=2))
    bad = bytearray(msg)
    bad[-1] ^= 1
    assert bytes(tq.parse_msg(bytes(bad), version=2, verify=False)[1]) == b"abcdeg"
    head = struct.pack("<BQd", ord("Q"), wire.MAX_BODY + 1, 0.0)
    err = _same_error(lambda: tq.parse_msg(head, version=1), lambda: jtq.parse_msg(head, version=1))
    assert isinstance(err, WireCorruptionError) and "exceeds" in str(err)


def test_sendmsg_all_handles_partial_sends():
    a, b = socket.socketpair()
    try:
        a.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 4096)
        parts = [b"", bytes(range(256)) * 64, memoryview(np.arange(60000, dtype=np.uint8)),
                 b"tail"] + [b"x"] * 600  # more parts than one sendmsg takes
        want = b"".join(bytes(p) for p in parts)
        got = bytearray()

        def reader():
            while len(got) < len(want):
                got.extend(b.recv(65536))

        t = threading.Thread(target=reader, name="tcpq-test-reader")
        t.start()
        tq._sendmsg_all(a, parts)
        t.join(timeout=10)
        assert bytes(got) == want
    finally:
        a.close()
        b.close()


# -- transport round trips ------------------------------------------------------
class EchoCore:
    """A stand-in core: doubles every tensor."""

    corrupt_requests = 0

    def check_caps(self, caps):
        return caps

    def process(self, frames, timeout):
        return [TensorFrame([np.asarray(t) * 2 for t in f.tensors]) for f in frames]

    def process_stream(self, frame, timeout):
        for i in range(3):
            out = TensorFrame([np.asarray(frame.tensors[0]) + i], meta={"final": i == 2})
            yield out


class JEchoCore(EchoCore):
    def process(self, frames, timeout):
        return [JFrame([np.asarray(t) * 2 for t in f.tensors]) for f in frames]


SERVERS = {"port": (tq.TcpQueryServer, EchoCore), "jax": (jtq.TcpQueryServer, JEchoCore)}
CLIENTS = {"port": (tq.TcpQueryConnection, TensorFrame), "jax": (jtq.TcpQueryConnection, JFrame)}


@pytest.mark.parametrize("server,client", [("port", "port"), ("port", "jax"), ("jax", "port")])
@pytest.mark.parametrize("sv", [1, 2])
@pytest.mark.parametrize("cv", [1, 2])
def test_negotiation_matrix(server, client, sv, cv):
    """Every pairing of versions and packages (a port end on at least one
    side) agrees on min(cv, sv) and round-trips frames and batches."""
    scls, core = SERVERS[server]
    ccls, fcls = CLIENTS[client]
    srv = scls(core(), host="127.0.0.1", port=0, wire_version=sv)
    srv.start()
    try:
        conn = ccls("127.0.0.1", srv.port, timeout=5, wire_version=cv)
        try:
            out = conn.invoke(frame(3.0, cls=fcls))
            assert float(out.tensors[0][0]) == 6.0
            outs = conn.invoke_batch([frame(1.0, cls=fcls), frame(2.0, cls=fcls)])
            assert [float(o.tensors[0][0]) for o in outs] == [2.0, 4.0]
            assert set(conn._sock_ver.values()) == {min(sv, cv)}
            assert conn._peer_v1 == (min(sv, cv) == 1)
        finally:
            conn.close()
    finally:
        srv.stop()


def test_server_honors_peer_advertised_max_v1():
    srv = tq.TcpQueryServer(EchoCore(), host="127.0.0.1", port=0)
    srv.start()
    try:
        s = socket.create_connection(("127.0.0.1", srv.port), timeout=5)
        try:
            tq._send_msg(s, ord("V"), [b"1"], version=1)
            rtype, body, _ = tq._recv_msg(s, version=1)
            assert (rtype, bytes(body)) == (ord("V"), b"1")
            tq._send_msg(s, ord("Q"), [wire.encode_frame(frame(4.0), version=1)], version=1)
            rtype, body, _ = tq._recv_msg(s, version=1)
            assert rtype == ord("Q") and float(wire.decode_frame(body).tensors[0][0]) == 8.0
        finally:
            s.close()
    finally:
        srv.stop()


def test_stream_message_yields_until_final():
    srv = tq.TcpQueryServer(EchoCore(), host="127.0.0.1", port=0)
    srv.start()
    try:
        conn = tq.TcpQueryConnection("127.0.0.1", srv.port, timeout=5)
        try:
            outs = list(conn.invoke_stream(frame(1.0)))
            assert [float(o.tensors[0][0]) for o in outs] == [1.0, 2.0, 3.0]
            assert [o.meta["final"] for o in outs] == [False, False, True]
            assert len(conn._free) == 1  # clean completion: the socket is pooled
        finally:
            conn.close()
    finally:
        srv.stop()


def test_socket_pool_parallel_invokes():
    srv = tq.TcpQueryServer(EchoCore(), host="127.0.0.1", port=0)
    srv.start()
    try:
        conn = tq.TcpQueryConnection("127.0.0.1", srv.port, timeout=10, nconns=4)
        errs, results = [], {}

        def worker(i):
            try:
                results[i] = float(conn.invoke(frame(float(i))).tensors[0][0])
            except Exception as e:  # noqa: BLE001
                errs.append(e)

        threads = [threading.Thread(target=worker, args=(i,), name=f"tcpq-test-{i}")
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=20)
        assert conn._live <= 4 and not conn._held  # at most nconns sockets, all returned
        conn.close()
        assert not errs and results == {i: i * 2.0 for i in range(8)}
    finally:
        srv.stop()


def test_dead_server_raises_promptly():
    conn = tq.TcpQueryConnection("127.0.0.1", 1, timeout=2)
    try:
        t0 = time.monotonic()
        with pytest.raises((ConnectionError, OSError)):
            conn.invoke(frame())
        assert time.monotonic() - t0 < 2.0
    finally:
        conn.close()


def test_stale_pooled_socket_is_evicted():
    """A pooled socket the server closed while parked either fails at send
    (one retry on a fresh dial: the request never executed) or at the
    reply (never retried here: it may have executed); either way it is
    evicted, and the next request dials afresh."""
    srv = tq.TcpQueryServer(EchoCore(), host="127.0.0.1", port=0)
    srv.start()
    port = srv.port
    conn = tq.TcpQueryConnection("127.0.0.1", port, timeout=5, nconns=1)
    try:
        assert float(conn.invoke(frame(1.0)).tensors[0][0]) == 2.0
        srv.stop()  # closes every server-side connection
        srv = tq.TcpQueryServer(EchoCore(), host="127.0.0.1", port=port)
        srv.start()
        try:
            assert float(conn.invoke(frame(2.0)).tensors[0][0]) == 4.0
        except ConnectionError:
            assert conn._live == 0 and not conn._free  # evicted, not pooled
        assert float(conn.invoke(frame(3.0)).tensors[0][0]) == 6.0
    finally:
        conn.close()
        srv.stop()


def test_typed_replies_map_to_client_errors():
    from nnstreamer_tpu_torch.core.lifecycle import ServerGoawayError
    from nnstreamer_tpu_torch.core.liveness import ServerBusyError
    from nnstreamer_tpu_torch.core.resilience import RemoteApplicationError

    for code, body, exc in ((tq._T_GOAWAY, b"", ServerGoawayError),
                            (tq._T_CORRUPT, b"bad", WireCorruptionError),
                            (tq._T_BUSY, b"0.250000", ServerBusyError),
                            (tq._T_TIMEOUT, b"late", TimeoutError),
                            (tq._T_ERROR, b"boom", RemoteApplicationError)):
        with pytest.raises(exc) as ei:
            tq.TcpQueryConnection._check_reply(code, memoryview(body))
        if exc is ServerBusyError:
            assert ei.value.retry_after == 0.25
    tq.TcpQueryConnection._check_reply(tq._T_QUERY, memoryview(b""))


# -- hostile input: the server survives ------------------------------------------
def _server(sid, extra=""):
    pipe = parse_pipeline(
        f"tensor_query_serversrc name=ssrc id={sid} host=127.0.0.1 port=0 connect-type=tcp "
        f"{extra} ! tensor_filter framework=scaler custom=factor:2 accelerator=cpu ! "
        f"tensor_query_serversink id={sid}")
    pipe.start()
    return pipe, pipe["ssrc"].props["port"]


def _recv_reply(s, version=1):
    hs = 17 if version == 1 else 21
    head = b""
    while len(head) < hs:
        chunk = s.recv(hs - len(head))
        assert chunk, "server hung up before its reply"
        head += chunk
    mtype, blen = struct.unpack_from("<BQ", head)
    body = b""
    while len(body) < blen:
        chunk = s.recv(blen - len(body))
        assert chunk, "server hung up mid-reply"
        body += chunk
    return mtype, body


def test_corrupt_query_gets_C_and_connection_survives():
    pipe, port = _server(1801)
    try:
        with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
            bad = bytearray(wire.encode_frame(frame(3.0)))
            bad[-1] ^= 1
            s.sendall(tq.encode_msg(ord("Q"), bytes(bad), 10.0))
            mtype, body = _recv_reply(s)
            assert mtype == ord("C") and b"checksum" in body
            s.sendall(tq.encode_msg(ord("Q"), wire.encode_frame(frame(3.0), version=1), 10.0))
            mtype, body = _recv_reply(s)
            assert mtype == ord("Q") and float(wire.decode_frame(body).tensors[0][0]) == 6.0
            # a corrupt batch envelope too, and an unknown message type
            bad = bytearray(wire.encode_frames([frame(), frame()], version=2))
            bad[5] ^= 1
            s.sendall(tq.encode_msg(ord("Q"), bytes(bad), 10.0))
            assert _recv_reply(s)[0] == ord("C")
            s.sendall(tq.encode_msg(ord("Z"), b"", 0.0))
            mtype, body = _recv_reply(s)
            assert mtype == ord("E") and b"unknown message type" in body
        assert pipe.health()["ssrc"]["corrupt_requests"] == 2
    finally:
        pipe.stop()


@pytest.mark.parametrize("hostile", ["oversize", "v2crc", "truncated", "garbage"])
def test_hostile_bytes_do_not_kill_server(hostile):
    pipe, port = _server(1802)
    try:
        s = socket.create_connection(("127.0.0.1", port), timeout=10)
        try:
            if hostile == "oversize":
                s.sendall(struct.pack("<BQd", ord("Q"), wire.MAX_BODY + 1, 0.0))
                assert _recv_reply(s)[0] in (ord("C"), ord("E"))
            elif hostile == "v2crc":
                tq._send_msg(s, ord("V"), [b"2"], version=1)
                assert _recv_reply(s)[0] == ord("V")
                msg = bytearray(tq.encode_msg(ord("Q"), wire.encode_frame(frame()), 5.0, 2))
                msg[30] ^= 4
                s.sendall(bytes(msg))
                mtype, body = _recv_reply(s, version=2)
                assert mtype == ord("C") and b"message checksum" in body
            elif hostile == "truncated":
                s.sendall(tq.encode_msg(ord("Q"), wire.encode_frame(frame()), 5.0)[:30])
            else:
                s.sendall(bytes(np.random.default_rng(1).integers(0, 256, 4096, dtype=np.uint8)))
        finally:
            s.close()
        conn = tq.TcpQueryConnection("127.0.0.1", port, timeout=10)
        try:
            assert float(conn.invoke(frame(4.0)).tensors[0][0]) == 8.0
        finally:
            conn.close()
    finally:
        pipe.stop()


def test_caps_handshake_mismatch_fails():
    pipe, port = _server(1803, "caps=other/tensors,num_tensors=1,dimensions=2,types=float32")
    try:
        conn = tq.TcpQueryConnection("127.0.0.1", port, timeout=5)
        try:
            with pytest.raises(RuntimeError, match="caps mismatch"):
                conn.handshake("other/tensors,num_tensors=1,dimensions=7,types=uint8")
            assert "float32" in conn.handshake(
                "other/tensors,num_tensors=1,dimensions=2,types=float32")
        finally:
            conn.close()
    finally:
        pipe.stop()


# -- corrupt faults, counted exactly --------------------------------------------
def _corrupt_run(site, sid, n=24):
    server, port = _server(sid)
    client = parse_pipeline(
        "appsrc name=src ! tensor_query_client name=q connect-type=tcp "
        f"host=127.0.0.1 port={port} retries=2 retry-backoff=0.01 corrupt-retries=3 "
        "breaker-threshold=0 degrade=skip timeout=10 max-in-flight=2 ! tensor_sink name=out")
    client.start()
    FAULTS.arm(site, corrupt="bitflip", every=3, seed=11)  # after the handshake
    try:
        for i in range(n):
            client["src"].push(np.float32([i]))
        client["src"].end_of_stream()
        client.wait(timeout=60)
        fired = FAULTS.stats(site)["fired"]
        vals = sorted(float(f.tensors[0][0]) for f in client["out"].frames)
        return fired, client.health()["q"], vals, server.health()["ssrc"]
    finally:
        FAULTS.reset()
        client.stop()
        server.stop()


@pytest.mark.parametrize("site", ["tcp_query.send", "tcp_query.recv"])
def test_corruption_exact_accounting(site):
    n = 24
    fired, h, vals, srv = _corrupt_run(site, 1804 if site.endswith("send") else 1805, n)
    assert fired > 0
    assert h["corruption_detected"] == fired  # every corruption detected
    assert h["delivered"] + h["degraded_frames"] == n
    assert len(vals) + h["degraded_frames"] == n and len(set(vals)) == len(vals)
    assert set(vals) <= {2.0 * i for i in range(n)}
    assert h["degraded_frames"] <= 2
    assert srv["corrupt_requests"] == (fired if site.endswith("send") else 0)


def test_single_corruption_retried_sustained_trips_breaker():
    from nnstreamer_tpu_torch.elements.query import TensorQueryClient, _PoolState

    class Flaky:
        addr = "fake:1"

        def __init__(self, bad):
            self.bad = bad

        def invoke(self, f, timeout):
            if self.bad:
                self.bad -= 1
                raise WireCorruptionError("frame checksum mismatch")
            return f

    q = TensorQueryClient("q")
    for k, v in {"corrupt-retries": 2, "breaker-threshold": 3, "retry-backoff": 0.0}.items():
        q.set_property(k, v)
    q._pstate = _PoolState((Flaky(1),), (("fake", 1),))
    q._stopped = False
    f = frame(7.0)
    assert q._invoke_failover(f, 0) is f
    h = q.health_info()
    assert (h["corruption_detected"], h["retried"], h["delivered"]) == (1, 1, 1)
    assert h["breakers"]["fake:1"] == {"state": "closed", "recent_failures": 0, "trips": 0}
    q._pstate = _PoolState((Flaky(10),), (("fake", 1),))
    with pytest.raises(WireCorruptionError):
        q._invoke_failover(frame(), 0)
    h = q.health_info()
    assert h["corruption_detected"] == 4 and h["breakers"]["fake:1"]["trips"] >= 1


def test_message_level_corruption_evicts_the_socket():
    """A corrupt MESSAGE gets 'C' and the server drops that connection: the
    client does not pool the socket, so the resend (retries=0 suffices)
    dials afresh instead of failing on a closed socket."""
    srv = tq.TcpQueryServer(EchoCore(), host="127.0.0.1", port=0)
    srv.start()
    conn = tq.TcpQueryConnection("127.0.0.1", srv.port, timeout=5, nconns=1)
    try:
        assert float(conn.invoke(frame(1.0)).tensors[0][0]) == 2.0
        FAULTS.arm("tcp_query.send", corrupt="bitflip", every=1, times=1, seed=3)
        with pytest.raises(WireCorruptionError):
            conn.invoke(frame(2.0))
        assert not conn._free and conn._live == 0  # evicted, not pooled
        for v in (3.0, 4.0):
            assert float(conn.invoke(frame(v)).tensors[0][0]) == 2 * v
        assert srv.corruption_detected == 1
    finally:
        conn.close()
        srv.stop()

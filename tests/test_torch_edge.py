"""The port's edgesink/edgesrc and raw-TCP edge transport, and the JAX package's.

Mirrors the contracts of ``tests/test_distributed.py``'s ``TestEdgePubSub``,
``TestEdgeTcp`` and ``TestEdgeHybrid``, ``tests/test_resilience.py``'s
edgesrc failover dial and ``tests/test_wire_integrity.py``'s corrupt tcp
frames: publish and subscribe over every connect type, topic isolation, a
subscriber that speaks only sockets, a dead subscriber dropped, discovery
of the data endpoint over MQTT and its timeout, ``dest-hosts`` failover,
a re-dial after the publisher restarts (``max-reconnects``), corrupt frames
dropped and counted.  Across the packages: each edgesink's frames
byte-equal to the other's on the wire and read by the other's edgesrc.  A
micro-batch of tensors reaches the host in one copy per tensor.  The gRPC
connect types run where ``grpc`` imports.  Every wait is bounded; the
module's census checks that no thread or socket outlives it.
"""

import importlib.util
import socket
import struct
import time

import numpy as np
import pytest
import torch

from nnstreamer_tpu_torch.core import buffer as tbuffer
from nnstreamer_tpu_torch.core.buffer import TensorFrame
from nnstreamer_tpu_torch.core.resilience import FAULTS
from nnstreamer_tpu_torch.distributed.mqtt import MiniBroker
from nnstreamer_tpu_torch.distributed.tcp_edge import TcpEdgeServer, TcpEdgeSubscriber
from nnstreamer_tpu_torch.distributed.wire import decode_frame
from nnstreamer_tpu_torch.pipeline import ElementError, parse_pipeline
from torch_census import module_leak_check  # noqa: F401

torch.set_num_threads(2)

needs_grpc = pytest.mark.skipif(importlib.util.find_spec("grpc") is None,
                                reason="grpc is not installed")


def wait_until(pred, timeout=5.0, step=0.01) -> bool:
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            return False
        time.sleep(step)
    return True


def sender(extra: str, parse=parse_pipeline):
    tx = parse(f"appsrc name=src ! edgesink name=es {extra}")
    tx.start()
    return tx


def finish(tx) -> None:
    tx["src"].end_of_stream()
    tx.wait(timeout=10)
    tx.stop()


def values(pipe) -> list:
    return [float(np.asarray(f.tensors[0]).reshape(-1)[0]) for f in pipe["out"].frames]


class TestEdgeTcp:
    def test_tcp_publish_subscribe(self):
        tx = sender("connect-type=tcp host=127.0.0.1 port=0 topic=tv")
        port = tx["es"].props["port"]
        rx = parse_pipeline(f"edgesrc connect-type=tcp dest-host=127.0.0.1 dest-port={port} "
                            "topic=tv rebase-pts=false ! tensor_sink name=out")
        try:
            rx.start()
            assert wait_until(lambda: tx["es"]._tcp.subscriber_count("tv") == 1)
            for i in range(3):
                tx["src"].push(np.int32([i]), pts=i * 0.1)
            assert wait_until(lambda: len(rx["out"].frames) == 3, 10)
            assert values(rx) == [0, 1, 2]
            assert [f.pts for f in rx["out"].frames] == [0.0, 0.1, 0.2]
        finally:
            rx.stop()
            finish(tx)

    def test_rebased_pts_keep_their_spacing(self):
        tx = sender("connect-type=tcp host=127.0.0.1 port=0 topic=rb")
        port = tx["es"].props["port"]
        rx = parse_pipeline(f"edgesrc connect-type=tcp dest-host=127.0.0.1 dest-port={port} "
                            "topic=rb ! tensor_sink name=out")
        try:
            rx.start()
            assert wait_until(lambda: tx["es"]._tcp.subscriber_count("rb") == 1)
            for i in range(2):
                tx["src"].push(np.int32([i]), pts=i * 0.25)
            assert wait_until(lambda: len(rx["out"].frames) == 2, 10)
            a, b = (f.pts for f in rx["out"].frames)
            assert b - a == pytest.approx(0.25, abs=1e-6) and abs(a) < 5.0
        finally:
            rx.stop()
            finish(tx)

    def test_topic_isolation(self):
        tx = sender("connect-type=tcp host=127.0.0.1 port=0 topic=a")
        port = tx["es"].props["port"]
        other = parse_pipeline(f"edgesrc connect-type=tcp dest-host=127.0.0.1 dest-port={port} "
                               "topic=b ! tensor_sink name=out")
        try:
            other.start()
            assert wait_until(lambda: tx["es"]._tcp.subscriber_count("b") == 1)
            tx["src"].push(np.int32([1]))
            time.sleep(0.2)
            assert other["out"].frames == []
        finally:
            other.stop()
            finish(tx)

    def test_sockets_only_external_subscriber(self):
        """A peer with only sockets and the public framing (u32 topic in,
        u32 length-prefixed wire frames out) reads the stream."""
        tx = sender("connect-type=tcp host=127.0.0.1 port=0 topic=raw")
        port = tx["es"].props["port"]
        s = socket.create_connection(("127.0.0.1", port), timeout=5)
        try:
            s.sendall(struct.pack("<I", 3) + b"raw")
            assert wait_until(lambda: tx["es"]._tcp.subscriber_count("raw") == 1)
            tx["src"].push(np.float32([1.5, 2.5]))
            (n,) = struct.unpack("<I", s.recv(4, socket.MSG_WAITALL))
            frame = decode_frame(s.recv(n, socket.MSG_WAITALL))
            np.testing.assert_allclose(np.asarray(frame.tensors[0]), [1.5, 2.5])
        finally:
            s.close()
            finish(tx)

    def test_dead_subscriber_dropped_not_fatal(self):
        srv = TcpEdgeServer(host="127.0.0.1")
        try:
            sub = TcpEdgeSubscriber("127.0.0.1", srv.port, "t")
            assert wait_until(lambda: srv.subscriber_count("t") == 1)
            assert srv.publish("t", b"x" * 64) == 1
            sub.close()
            assert wait_until(lambda: (srv.publish("t", b"y" * 64), srv.subscriber_count("t"))[1]
                              == 0)
            sub2 = TcpEdgeSubscriber("127.0.0.1", srv.port, "t")
            assert wait_until(lambda: srv.subscriber_count("t") == 1)
            assert srv.publish("t", [b"z", memoryview(b"zz")]) == 1  # gathered parts
            assert next(sub2.payloads(idle_timeout=5)) == b"zzz"
            sub2.close()
        finally:
            srv.close()

    def test_dest_hosts_failover_dial_and_bad_lists(self):
        srv = TcpEdgeServer(host="127.0.0.1")
        dead = socket.socket()
        dead.bind(("127.0.0.1", 0))
        dead_port = dead.getsockname()[1]
        dead.close()
        rx = parse_pipeline(f"edgesrc connect-type=tcp topic=tv "
                            f"dest-hosts=127.0.0.1:{dead_port},127.0.0.1:{srv.port} ! "
                            "tensor_sink name=out")
        try:
            rx.start()
            assert wait_until(lambda: srv.subscriber_count("tv") == 1)
        finally:
            rx.stop()
            srv.close()
        bad = parse_pipeline("edgesrc connect-type=tcp dest-hosts=nonsense ! tensor_sink")
        with pytest.raises(ElementError, match="dest-hosts"):
            bad.start()
        bad.stop()
        with pytest.raises(ValueError, match="connect-type"):
            parse_pipeline("appsrc ! edgesink connect-type=udp")

    def test_redial_after_the_publisher_restarts(self):
        srv = TcpEdgeServer(host="127.0.0.1")
        port = srv.port
        rx = parse_pipeline(f"edgesrc connect-type=tcp dest-host=127.0.0.1 dest-port={port} "
                            "topic=rd max-reconnects=20 reconnect-backoff=0.05 ! "
                            "tensor_sink name=out")
        from nnstreamer_tpu_torch.distributed.wire import encode_frame

        try:
            rx.start()
            assert wait_until(lambda: srv.subscriber_count("rd") == 1)
            srv.publish("rd", encode_frame(TensorFrame([np.float32([1])])))
            assert wait_until(lambda: len(rx["out"].frames) == 1)
            srv.close()  # the publisher dies...
            srv = TcpEdgeServer(host="127.0.0.1", port=port)  # ...and comes back
            assert wait_until(lambda: srv.subscriber_count("rd") == 1, 10)
            srv.publish("rd", encode_frame(TensorFrame([np.float32([2])])))
            assert wait_until(lambda: len(rx["out"].frames) == 2)
            assert values(rx) == [1.0, 2.0]
        finally:
            rx.stop()
            srv.close()

    def test_a_hang_up_behind_a_full_queue_still_ends_the_stream(self):
        """The publisher pushes more than the source's queues hold and hangs
        up while they are full: every frame arrives and the stream still
        ends (EOS)."""
        import threading

        tx = sender("connect-type=tcp host=127.0.0.1 port=0 topic=full")
        port = tx["es"].props["port"]
        rx = parse_pipeline(f"edgesrc name=e connect-type=tcp dest-host=127.0.0.1 "
                            f"dest-port={port} topic=full ! queue max-buffers=1 ! "
                            "tensor_sink name=out")
        gate = threading.Event()
        # a slow consumer: the source's queue stays full to the end
        rx["out"].connect_new_data(lambda f: (gate.wait(5), time.sleep(0.005)))
        try:
            rx.start()
            assert wait_until(lambda: tx["es"]._tcp.subscriber_count("full") == 1)
            for i in range(100):
                tx["src"].push(np.float32([i]))
            tx["src"].end_of_stream()
            tx.wait(timeout=10)
            tx.stop()  # hang up while the source's queues are full
            gate.set()
            rx.wait(timeout=10)
            assert values(rx) == list(range(100))
        finally:
            gate.set()
            rx.stop()
            tx.stop()

    def test_corrupt_frames_dropped_and_counted(self):
        tx = sender("connect-type=tcp host=127.0.0.1 port=0 topic=integ")
        port = tx["es"].props["port"]
        rx = parse_pipeline(f"edgesrc name=e connect-type=tcp dest-host=127.0.0.1 "
                            f"dest-port={port} topic=integ ! tensor_sink name=out")
        try:
            rx.start()
            assert wait_until(lambda: tx["es"]._tcp.subscriber_count("integ") == 1)
            FAULTS.arm("tcp_edge.publish", corrupt="bitflip", every=2, seed=2)
            for i in range(6):
                tx["src"].push(np.float32([i]))
            assert wait_until(lambda: len(rx["out"].frames) == 3, 10)
            assert FAULTS.stats("tcp_edge.publish")["fired"] == 3
            assert values(rx) == [1.0, 3.0, 5.0]
            assert wait_until(lambda: rx.health()["e"]["corrupt_dropped"] == 3)
        finally:
            FAULTS.reset()
            rx.stop()
            finish(tx)

    def test_a_micro_batch_reaches_the_host_once_per_tensor(self, monkeypatch):
        calls = []
        inner = tbuffer.to_numpy
        monkeypatch.setattr(tbuffer, "to_numpy", lambda t: (calls.append(tuple(t.shape)),
                                                            inner(t))[1])
        tx = sender("connect-type=tcp host=127.0.0.1 port=0 topic=mb")
        port = tx["es"].props["port"]
        rx = parse_pipeline(f"edgesrc connect-type=tcp dest-host=127.0.0.1 dest-port={port} "
                            "topic=mb ! tensor_sink name=out")
        try:
            rx.start()
            assert wait_until(lambda: tx["es"]._tcp.subscriber_count("mb") == 1)
            for b in range(2):
                tx["src"].push_block([torch.arange(8.0).reshape(4, 2) + 10 * b,
                                      torch.ones(4, 3)], pts=[float(4 * b + k) for k in range(4)])
            assert wait_until(lambda: len(rx["out"].frames) == 8, 10)
        finally:
            rx.stop()
            finish(tx)
        assert sorted(calls) == [(4, 2), (4, 2), (4, 3), (4, 3)]  # per tensor per block
        assert [len(f.tensors) for f in rx["out"].frames] == [2] * 8


def test_the_grpc_edge_broker_counts_frames_a_full_subscriber_missed(monkeypatch):
    """The gRPC broker of edgesink's server and hybrid modes drops a frame
    for a subscriber whose queue is full (the JAX package's pub/sub
    semantics) and counts it in ``dropped_full``."""
    import threading

    from nnstreamer_tpu_torch.distributed.service import EdgeBroker

    class Call:  # a live server-streaming call
        active = True

        def is_active(self):
            return self.active

    monkeypatch.setattr(EdgeBroker, "QUEUE_DEPTH", 2)
    broker, call, got = EdgeBroker(0), Call(), []
    stream = broker._subscribe(b"t", call)
    reader = threading.Thread(target=lambda: got.append(next(stream)), name="edge-test-reader")
    reader.start()
    try:
        assert wait_until(lambda: broker.subscriber_count("t") == 1)
        assert broker.publish_local("t", b"0") == 1
        reader.join(timeout=5)
        for i in range(1, 6):  # nobody reads: the queue holds 2, 3 are missed
            broker.publish_local("t", b"%d" % i)
        assert got == [b"0"] and broker.dropped_full == 3
        assert [next(stream), next(stream)] == [b"1", b"2"]
    finally:
        call.active = False
        stream.close()
    assert broker.subscriber_count("t") == 0


@needs_grpc
class TestEdgeGrpc:
    def test_server_mode_publish_subscribe_and_topic_isolation(self):
        tx = sender("port=0 topic=video")
        port = tx["es"].props["port"]
        rx = parse_pipeline(f"edgesrc dest-host=127.0.0.1 dest-port={port} topic=video "
                            "rebase-pts=false ! tensor_sink name=out")
        other = parse_pipeline(f"edgesrc dest-host=127.0.0.1 dest-port={port} topic=b ! "
                               "tensor_sink name=out")
        try:
            rx.start()
            other.start()
            broker = tx["es"]._broker
            assert wait_until(lambda: broker.subscriber_count("video") == 1
                              and broker.subscriber_count("b") == 1)
            for i in range(3):
                tx["src"].push(np.int32([i]), pts=i * 0.1)
            assert wait_until(lambda: len(rx["out"].frames) == 3, 10)
            assert values(rx) == [0, 1, 2] and other["out"].frames == []
        finally:
            rx.stop()
            other.stop()
            finish(tx)

    def test_client_mode_publishes_into_a_remote_broker(self):
        host = sender("port=0 topic=hub")  # hosts the broker, publishes nothing
        port = host["es"].props["port"]
        rx = parse_pipeline(f"edgesrc dest-host=127.0.0.1 dest-port={port} topic=cl ! "
                            "tensor_sink name=out")
        tx = sender(f"connect-type=client dest-host=127.0.0.1 dest-port={port} topic=cl")
        try:
            rx.start()
            assert wait_until(lambda: host["es"]._broker.subscriber_count("cl") == 1)
            for i in range(2):
                tx["src"].push(np.int32([i]))
            assert wait_until(lambda: len(rx["out"].frames) == 2, 10)
            assert values(rx) == [0, 1]
        finally:
            rx.stop()
            finish(tx)
            finish(host)

    def test_hybrid_discovery_and_stream(self):
        mqtt = MiniBroker()
        tx = sender(f"topic=hy connect-type=hybrid dest-host=127.0.0.1 dest-port={mqtt.port} "
                    "port=0")
        rx = parse_pipeline(f"edgesrc topic=hy connect-type=hybrid dest-host=127.0.0.1 "
                            f"dest-port={mqtt.port} ! tensor_sink name=out")
        try:
            rx.start()
            assert wait_until(lambda: tx["es"]._broker.subscriber_count("hy") == 1)
            for i in range(3):
                tx["src"].push(np.int32([i]), pts=float(i))
            assert wait_until(lambda: len(rx["out"].frames) == 3, 10)
            assert values(rx) == [0, 1, 2]
        finally:
            rx.stop()
            finish(tx)
            mqtt.close()

    def test_direct_dead_targets_fail_loudly(self):
        rx = parse_pipeline("edgesrc connect-type=direct dest-hosts=127.0.0.1:1,127.0.0.1:2 ! "
                            "tensor_sink")
        with pytest.raises(ConnectionError):
            rx.start()
        rx.stop()


def test_hybrid_discovery_timeout():
    mqtt = MiniBroker()  # nobody announces here
    rx = parse_pipeline(f"edgesrc topic=ghost connect-type=hybrid dest-host=127.0.0.1 "
                        f"dest-port={mqtt.port} discovery-timeout=0.3 ! tensor_sink name=out")
    try:
        expect = "no edge announce" if importlib.util.find_spec("grpc") else "grpc package"
        with pytest.raises(Exception, match=expect):
            rx.start()
    finally:
        rx.stop()
        mqtt.close()


def read_frames(port: int, topic: str, n: int) -> list:
    """``n`` raw wire frames of ``topic`` from a tcp edgesink, read with
    sockets only."""
    sub = TcpEdgeSubscriber("127.0.0.1", port, topic)
    try:
        it = sub.payloads(idle_timeout=10)
        return [next(it) for _ in range(n)]
    finally:
        sub.close()


@pytest.mark.parametrize("sink_pkg", ["jax", "torch"])
def test_edge_frames_byte_equal_across_packages(sink_pkg):
    """The same frames (seq and wall_base fixed) through both packages'
    tcp edgesinks are byte-equal on the wire, and the other package's
    edgesrc reads them."""
    import threading

    from nnstreamer_tpu.core.buffer import TensorFrame as JaxFrame
    from nnstreamer_tpu.pipeline import parse_pipeline as jax_parse

    parse = {"jax": jax_parse, "torch": parse_pipeline}
    frame_type = {"jax": JaxFrame, "torch": TensorFrame}
    frames = [np.arange(6, dtype=np.float32).reshape(2, 3) * k for k in range(3)]
    wire = {}
    for pkg in ("jax", "torch"):
        tx = sender("connect-type=tcp host=127.0.0.1 port=0 topic=bx", parse[pkg])
        try:
            tx["es"]._wall_base = 100.0
            got = {}
            t = threading.Thread(target=lambda: got.update(
                f=read_frames(tx["es"].props["port"], "bx", 3)))
            t.start()
            assert wait_until(lambda: tx["es"]._tcp.subscriber_count("bx") == 1)
            for k, f in enumerate(frames):
                tx["src"].push(frame_type[pkg]([f], pts=0.5 * k, seq=k))
            t.join(timeout=15)
            wire[pkg] = got["f"]
        finally:
            finish(tx)
    assert wire["jax"] == wire["torch"]
    other = "torch" if sink_pkg == "jax" else "jax"
    tx = sender("connect-type=tcp host=127.0.0.1 port=0 topic=cx", parse[sink_pkg])
    rx = parse[other](f"edgesrc connect-type=tcp dest-host=127.0.0.1 "
                      f"dest-port={tx['es'].props['port']} topic=cx rebase-pts=false ! "
                      "tensor_sink name=out")
    try:
        rx.start()
        assert wait_until(lambda: tx["es"]._tcp.subscriber_count("cx") == 1)
        for k, f in enumerate(frames):
            tx["src"].push(f, pts=0.5 * k)
        assert wait_until(lambda: len(rx["out"].frames) == 3, 10)
        got = [np.asarray(f.tensors[0]) for f in rx["out"].frames]
        assert all(np.array_equal(g, w) for g, w in zip(got, frames))
        assert [f.pts for f in rx["out"].frames] == [0.0, 0.5, 1.0]
    finally:
        rx.stop()
        finish(tx)

"""The port's MQTT transport and mqttsink/mqttsrc against the JAX package's.

Mirrors the contracts of ``tests/test_mqtt.py`` (wildcards, retained
messages, QoS 0/1 both ways, DUP retransmission, a slow acker's overflow,
persistent sessions across a subscriber's death and a broker's restart,
the elements' pub/sub, timeouts and restart survival) and of
``tests/test_control_plane.py::TestBrokerFailover`` (failover past a dead
broker, the reconnect count, retained coalescing).  The reconnect count is
held steady over repeated broker deaths: the port counts before it signals
``connected``.  Across the packages: either client against the other's
broker, and each mqttsink's messages byte-equal to the other's (the epochs
cut out) and decoded by the other's mqttsrc.  A micro-batch of tensors
reaches the host in one copy per tensor.  Every wait is bounded; the
module's census checks that no thread or socket outlives it.
"""

import socket
import struct
import threading
import time

import numpy as np
import pytest
import torch

from nnstreamer_tpu_torch.core import buffer as tbuffer
from nnstreamer_tpu_torch.distributed import mqtt as tm
from nnstreamer_tpu_torch.distributed.mqtt import MiniBroker, MqttClient, topic_matches
from nnstreamer_tpu_torch.pipeline import make_element, parse_pipeline
from torch_census import module_leak_check  # noqa: F401

torch.set_num_threads(2)


def wait_until(pred, timeout=5.0, step=0.01) -> bool:
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            return False
        time.sleep(step)
    return True


@pytest.fixture
def broker():
    b = MiniBroker()
    yield b
    b.close()


def restart_broker(port, timeout=8.0, **kw):
    """Rebind the broker port, retrying while old sockets drain."""
    deadline = time.monotonic() + timeout
    while True:
        try:
            return MiniBroker(port=port, **kw)
        except OSError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.05)


def dead_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port  # nothing listens: a dial is refused


@pytest.mark.parametrize("pattern,topic", [
    ("a/b", "a/b"), ("a/b", "a/c"), ("a/+", "a/b"), ("a/+", "a/b/c"), ("a/#", "a/b/c"),
    ("#", "anything/at/all"), ("a/b/c", "a/b"), ("+/+", "a/b"), ("a/+/c", "a/x/c")])
def test_topic_matches_the_jax_package(pattern, topic):
    from nnstreamer_tpu.distributed.mqtt import topic_matches as jax_matches

    assert topic_matches(pattern, topic) == jax_matches(pattern, topic)


class TestClientBroker:
    def test_pub_sub_roundtrip(self, broker):
        got, ev = [], threading.Event()
        sub = MqttClient(broker.host, broker.port)
        pub = MqttClient(broker.host, broker.port)
        try:
            sub.subscribe("nns/#", lambda t, p: (got.append((t, p)), ev.set()))
            assert broker.wait_subscriber("nns/test", 5)
            pub.publish("nns/test", b"hello")
            assert ev.wait(5)
            assert got == [("nns/test", b"hello")]
        finally:
            pub.close()
            sub.close()

    def test_retained_message_and_its_deletion(self, broker):
        pub = MqttClient(broker.host, broker.port)
        try:
            pub.publish("cfg/x", b"state", retain=True, qos=1)
            assert pub.drain(5) == 0
            got, ev = [], threading.Event()
            sub = MqttClient(broker.host, broker.port)
            sub.subscribe("cfg/+", lambda t, p: (got.append(p), ev.set()))
            assert ev.wait(5)
            sub.close()
            assert got == [b"state"]
            pub.publish("cfg/x", b"", retain=True, qos=1)  # an empty retained payload deletes
            assert pub.drain(5) == 0
            late = []
            sub = MqttClient(broker.host, broker.port)
            sub.subscribe("cfg/+", lambda t, p: late.append(p))
            assert broker.wait_subscriber("cfg/x", 5)
            sub.ping()
            time.sleep(0.1)
            sub.close()
            assert late == []
        finally:
            pub.close()

    def test_ping(self, broker):
        c = MqttClient(broker.host, broker.port)
        try:
            c.ping()  # must not raise or kill the connection
            c.publish("t", b"x", qos=1)
            assert c.drain(5) == 0
        finally:
            c.close()


class TestQos1:
    def test_puback_drains_pending(self, broker):
        got = []
        rx = MqttClient(broker.host, broker.port)
        tx = MqttClient(broker.host, broker.port)
        try:
            rx.subscribe("q/1", lambda t, p: got.append(p))
            assert broker.wait_subscriber("q/1", 5)
            tx.publish("q/1", b"hello", qos=1)
            assert wait_until(lambda: not tx.unacked() and got)
            assert got == [b"hello"]
        finally:
            tx.close()
            rx.close()

    def test_qos0_unaffected_and_qos2_refused(self, broker):
        tx = MqttClient(broker.host, broker.port)
        try:
            tx.publish("q/0", b"x", qos=0)
            assert tx.unacked() == 0
            with pytest.raises(ValueError, match="QoS"):
                tx.publish("q/2", b"x", qos=2)
        finally:
            tx.close()


class TestSubscriberQos1:
    @staticmethod
    def raw_connect(broker, cid, clean=True):
        """A plain socket speaking MQTT, and the packet reader on it."""
        s = socket.create_connection((broker.host, broker.port), timeout=5)
        rx = tm._PacketReader(s)
        var = (tm._mqtt_str("MQTT") + bytes([4]) + bytes([0x02 if clean else 0x00])
               + struct.pack(">H", 60) + tm._mqtt_str(cid))
        s.sendall(bytes([tm.CONNECT << 4]) + tm._encode_len(len(var)) + var)
        ptype, _, _ = tm._read_packet(rx)
        assert ptype == tm.CONNACK
        return s, rx

    @staticmethod
    def raw_subscribe(s, rx, pattern, qos):
        var = struct.pack(">H", 7) + tm._mqtt_str(pattern) + bytes([qos])
        s.sendall(bytes([(tm.SUBSCRIBE << 4) | 0x2]) + tm._encode_len(len(var)) + var)
        ptype, _, body = tm._read_packet(rx)
        assert ptype == tm.SUBACK
        return body[2:]

    def test_suback_grants_requested_qos(self, broker):
        s, rx = self.raw_connect(broker, "raw-grant")
        try:
            assert self.raw_subscribe(s, rx, "g/1", 1) == bytes([1])
            assert self.raw_subscribe(s, rx, "g/0", 0) == bytes([0])
            assert self.raw_subscribe(s, rx, "g/2", 2) == bytes([1])  # capped
        finally:
            s.close()

    def test_delivery_has_packet_id_and_dup_retransmit(self):
        broker = MiniBroker(retransmit_s=0.2)
        s, rx = self.raw_connect(broker, "raw-sub")
        tx = MqttClient(broker.host, broker.port)
        try:
            self.raw_subscribe(s, rx, "d/t", 1)
            tx.publish("d/t", b"payload", qos=1)
            ptype, flags, body = tm._read_packet(rx)
            assert ptype == tm.PUBLISH and (flags >> 1) & 0x3 == 1 and not flags & 0x8
            topic, payload, pid = tm._parse_publish(flags, body)
            assert (topic, payload) == ("d/t", b"payload") and pid is not None
            ptype, flags, body = tm._read_packet(rx)  # no PUBACK: DUP, same id
            assert ptype == tm.PUBLISH and flags & 0x8
            assert tm._parse_publish(flags, body)[2] == pid
            s.sendall(tm._puback(pid))
            s.settimeout(0.6)
            with pytest.raises(OSError):
                tm._read_packet(rx)  # the redelivery went quiet
        finally:
            tx.close()
            s.close()
            broker.close()

    def test_a_slow_but_acknowledging_subscriber_gets_no_duplicates(self):
        """Messages wait longer than ``retransmit_s`` for a subscriber that
        reads slowly but keeps acknowledging: it is alive, so nothing is
        re-sent (the JAX package's broker would re-send on the timer)."""
        broker = MiniBroker(retransmit_s=0.2)
        s, rx = self.raw_connect(broker, "slow-reader")
        tx = MqttClient(broker.host, broker.port)
        try:
            self.raw_subscribe(s, rx, "sr/t", 1)
            n = 16
            for i in range(n):
                tx.publish("sr/t", f"m{i}".encode(), qos=1)
            assert tx.drain(5) == 0
            s.settimeout(5.0)
            got = []
            while len(got) < n:
                ptype, flags, body = tm._read_packet(rx)
                assert ptype == tm.PUBLISH and not flags & 0x8, "a DUP re-send"
                _, payload, pid = tm._parse_publish(flags, body)
                got.append(payload)
                time.sleep(0.05)  # the last one waits ~0.8 s, acks keep coming
                s.sendall(tm._puback(pid))
            assert got == [f"m{i}".encode() for i in range(n)]
            s.settimeout(0.5)
            with pytest.raises(OSError):
                tm._read_packet(rx)  # nothing more, no late DUPs
        finally:
            tx.close()
            s.close()
            broker.close()

    def test_qos0_subscription_downgrades_delivery(self, broker):
        s, rx = self.raw_connect(broker, "raw-q0")
        tx = MqttClient(broker.host, broker.port)
        try:
            self.raw_subscribe(s, rx, "q0/t", 0)
            tx.publish("q0/t", b"x", qos=1)  # min(1, 0) = QoS 0 out
            ptype, flags, body = tm._read_packet(rx)
            assert ptype == tm.PUBLISH and (flags >> 1) & 0x3 == 0
            assert tm._parse_publish(flags, body)[2] is None
        finally:
            tx.close()
            s.close()

    def test_slow_acker_overflow_queues_then_promotes(self, monkeypatch):
        monkeypatch.setattr(tm._BrokerSession, "INFLIGHT_LIMIT", 3)
        broker = MiniBroker(retransmit_s=0.2)
        s, rx = self.raw_connect(broker, "slow-acker")
        tx = MqttClient(broker.host, broker.port)
        try:
            self.raw_subscribe(s, rx, "o/t", 1)
            n = 10
            for i in range(n):
                tx.publish("o/t", f"p{i}".encode(), qos=1)
            assert tx.drain(5) == 0
            with broker._lock:
                assert len(broker._sessions["slow-acker"].inflight) <= 3
            got = set()
            s.settimeout(5.0)
            deadline = time.monotonic() + 10
            while len(got) < n and time.monotonic() < deadline:
                ptype, flags, body = tm._read_packet(rx)
                if ptype != tm.PUBLISH:
                    continue
                _, payload, pid = tm._parse_publish(flags, body)
                got.add(payload)
                if pid is not None:
                    s.sendall(tm._puback(pid))
            assert got == {f"p{i}".encode() for i in range(n)}
        finally:
            tx.close()
            s.close()
            broker.close()

    def test_killed_subscriber_reconnects_without_loss(self):
        broker = MiniBroker(retransmit_s=0.2)
        got = []
        sub = MqttClient(broker.host, broker.port, client_id="persist-sub",
                         clean_session=False, reconnect=False)
        tx = MqttClient(broker.host, broker.port, client_id="pub")
        sub2 = None
        try:
            sub.subscribe("k/t", lambda t, p: got.append(p), qos=1)
            assert broker.wait_subscriber("k/t", 5)
            tx.publish("k/t", b"m0", qos=1)
            assert wait_until(lambda: got == [b"m0"])
            sub._sock.shutdown(socket.SHUT_RDWR)  # killed: no DISCONNECT
            assert wait_until(lambda: not broker.has_subscriber("k/t"))
            for i in range(1, 6):
                tx.publish("k/t", f"m{i}".encode(), qos=1)
            assert tx.drain(5) == 0
            sub2 = MqttClient(broker.host, broker.port, client_id="persist-sub",
                              clean_session=False)
            sub2.subscribe("k/t", lambda t, p: got.append(p), qos=1)
            want = {f"m{i}".encode() for i in range(6)}
            assert wait_until(lambda: want <= set(got), 10), f"lost: {want - set(got)}"
            tx.publish("k/t", b"m6", qos=1)
            assert wait_until(lambda: b"m6" in got)
        finally:
            tx.close()
            sub.close()
            if sub2 is not None:
                sub2.close()
            broker.close()


class TestBrokerRestart:
    def test_reconnect_resubscribe_and_redeliver(self):
        b1 = MiniBroker()
        port = b1.port
        got = []
        rx = MqttClient(b1.host, port, client_id="rx", reconnect_delay_s=0.05)
        tx = MqttClient(b1.host, port, client_id="tx", retransmit_s=0.3,
                        reconnect_delay_s=0.3)  # the publisher lags the subscriber
        b2 = None
        try:
            rx.subscribe("s/#", lambda t, p: got.append(p))
            assert b1.wait_subscriber("s/a", 5)
            tx.publish("s/a", b"before", qos=1)
            assert wait_until(lambda: got == [b"before"])
            b1.close()
            assert wait_until(lambda: not tx.connected.is_set())
            tx.publish("s/a", b"during", qos=1)  # parked unacknowledged
            assert tx.unacked() >= 1
            b2 = restart_broker(port)
            assert wait_until(lambda: not tx.unacked() and b"during" in got, 10)
            tx.publish("s/a", b"after", qos=1)
            assert wait_until(lambda: b"after" in got)
        finally:
            tx.close()
            rx.close()
            (b2 or b1).close()

    def test_element_stream_survives_restart(self):
        b1 = MiniBroker()
        port = b1.port
        rx = parse_pipeline(
            f"mqttsrc host=127.0.0.1 port={port} sub-topic=el/t sub-timeout=8000 num-buffers=3 "
            "reconnect-delay=0.05 ! tensor_sink name=out")
        tx = parse_pipeline(f"appsrc name=src ! mqttsink name=ms host=127.0.0.1 port={port} "
                            "pub-topic=el/t qos=1 reconnect-delay=0.2")
        b2 = None
        try:
            rx.start()
            tx.start()
            assert b1.wait_subscriber("el/t", 5)
            tx["src"].push(np.int32([1]))
            assert wait_until(lambda: len(rx["out"].frames) == 1)
            b1.close()
            tx["src"].push(np.int32([2]))  # parked unacknowledged
            b2 = restart_broker(port)
            assert b2.wait_subscriber("el/t", 5)
            tx["src"].push(np.int32([3]))
            rx.wait(timeout=15)
            vals = [int(np.asarray(f.tensors[0])[0]) for f in rx["out"].frames]
            assert 2 in vals and 3 in vals  # at least once, every frame decoded
        finally:
            rx.stop()
            tx["src"].end_of_stream()
            tx.wait(timeout=10)
            tx.stop()
            (b2 or b1).close()

    def test_restart_preserves_acked_undelivered(self):
        b1 = MiniBroker(retransmit_s=0.2)
        port = b1.port
        got = []
        sub = MqttClient("127.0.0.1", port, client_id="persist-sub", clean_session=False)
        sub.subscribe("p/t", lambda t, m: got.append(bytes(m)), qos=1)
        assert b1.wait_subscriber("p/t", 5)
        sub.close()
        assert wait_until(lambda: not b1.has_subscriber("p/t"))
        pub = MqttClient("127.0.0.1", port, client_id="persist-pub")
        for i in range(5):
            pub.publish("p/t", f"m{i}".encode(), qos=1)
        assert pub.drain(5.0) == 0  # acknowledged, held for the offline session
        pub.close()
        b1.close()
        b2 = restart_broker(port, retransmit_s=0.2)
        sub2 = MqttClient("127.0.0.1", port, client_id="persist-sub", clean_session=False)
        try:
            sub2.subscribe("p/t", lambda t, m: got.append(bytes(m)), qos=1)
            assert wait_until(lambda: len(set(got)) >= 5, 10)
        finally:
            sub2.close()
            b2.close()
        assert sorted(set(got)) == [f"m{i}".encode() for i in range(5)], got


class TestBrokerFailover:
    def test_failover_dials_past_dead_broker(self, broker):
        dead = dead_port()
        c = MqttClient("127.0.0.1", dead, brokers=[("127.0.0.1", dead),
                                                   ("127.0.0.1", broker.port)])
        try:
            assert c.connected.is_set() and c.broker == ("127.0.0.1", broker.port)
            got = threading.Event()
            c.subscribe("fo/t", lambda t, p: got.set(), qos=1)
            c.publish("fo/t", b"x", qos=1)
            assert got.wait(5.0)
        finally:
            c.close()

    def test_failover_to_standby_after_primary_dies(self):
        primary, standby = MiniBroker(), MiniBroker()
        c = MqttClient("127.0.0.1", primary.port, brokers=[("127.0.0.1", standby.port)],
                       reconnect_delay_s=0.05)
        try:
            seen = []
            c.subscribe("sb/t", lambda t, p: seen.append(p), qos=1)
            primary.close()
            assert wait_until(lambda: c.connected.is_set() and c.reconnects == 1, 5)
            assert c.broker == ("127.0.0.1", standby.port)
            assert standby.wait_subscriber("sb/t", 5)  # re-subscribed on the standby
            c.publish("sb/t", b"via standby", qos=1)
            assert wait_until(lambda: seen == [b"via standby"])
        finally:
            c.close()
            standby.close()

    def test_reconnect_count_is_final_when_connected_is_set(self):
        """The count is steady: over five broker deaths, the moment
        ``connected`` is set again the count already holds that reconnect
        and the subscription is back."""
        broker = MiniBroker()
        port = broker.port
        c = MqttClient("127.0.0.1", port, reconnect_delay_s=0.05)
        try:
            seen = []
            c.subscribe("rc/t", lambda t, p: seen.append(p), qos=1)
            for k in range(1, 6):
                broker.close()
                assert wait_until(lambda: not c.connected.is_set())
                broker = restart_broker(port)
                assert c.connected.wait(5.0)
                assert c.reconnects == k  # read at once, no settling wait
                assert broker.wait_subscriber("rc/t", 5)
            c2 = MqttClient("127.0.0.1", port)
            try:
                c2.publish("rc/t", b"after", qos=1)
                assert wait_until(lambda: seen == [b"after"])
            finally:
                c2.close()
        finally:
            c.close()
            broker.close()

    def test_retained_coalescing_bounds_outage_backlog(self):
        broker = MiniBroker()
        c = MqttClient("127.0.0.1", broker.port, reconnect_delay_s=0.05)
        try:
            broker.close()
            assert wait_until(lambda: not c.connected.is_set())
            for i in range(5):
                c.publish("co/t", b"v%d" % i, retain=True, qos=1)
            assert c.coalesced == 4 and c.unacked() == 1
        finally:
            c.close()


class TestMqttElements:
    def test_pipeline_pubsub(self, broker):
        rx = parse_pipeline(f"mqttsrc host={broker.host} port={broker.port} sub-topic=nns/stream "
                            "num-buffers=3 sub-timeout=8000 ! tensor_sink name=out")
        tx = parse_pipeline(f"appsrc name=src ! mqttsink host={broker.host} port={broker.port} "
                            "pub-topic=nns/stream")
        try:
            rx.start()
            assert broker.wait_subscriber("nns/stream", 5)
            tx.start()
            for i in range(3):
                tx["src"].push(np.full((4,), i, np.float32), pts=i * 0.1)
            tx["src"].end_of_stream()
            tx.wait(timeout=10)
            rx.wait(timeout=10)
        finally:
            tx.stop()
            rx.stop()
        frames = rx["out"].frames
        assert len(frames) == 3
        np.testing.assert_allclose(frames[1].tensors[0], np.full((4,), 1.0))
        # the sender's clock mapped into the receiver's: spacing kept
        assert frames[1].pts - frames[0].pts == pytest.approx(0.1, abs=0.02)
        assert "mqtt-latency-s" in frames[0].meta

    def test_src_timeout_eos(self, broker):
        rx = parse_pipeline(f"mqttsrc host={broker.host} port={broker.port} "
                            "sub-topic=never/published sub-timeout=300 ! tensor_sink name=out")
        try:
            rx.start()
            rx.wait(timeout=10)
        finally:
            rx.stop()
        assert rx["out"].frames == []

    @pytest.mark.parametrize("props", [
        "idl=protobuf", "idl=flatbuf", "mqtt-qos=1", "qos=1 cleansession=false client-id=cs1",
        "ntp-sync=false"])
    def test_properties_round_trip(self, broker, props):
        src_props = props.replace("ntp-sync=false", "").replace("client-id=cs1", "client-id=cs2")
        rx = parse_pipeline(f"mqttsrc host={broker.host} port={broker.port} sub-topic=pr/t "
                            f"num-buffers=2 sub-timeout=8000 {src_props} ! tensor_sink name=out")
        tx = parse_pipeline(f"appsrc name=src ! mqttsink name=ms host={broker.host} "
                            f"port={broker.port} pub-topic=pr/t {props}")
        try:
            rx.start()
            assert broker.wait_subscriber("pr/t", 5)
            tx.start()
            for i in range(2):
                tx["src"].push(np.arange(6, dtype=np.float32).reshape(2, 3) + i, pts=5.0 + i)
            tx["src"].end_of_stream()
            tx.wait(timeout=10)
            rx.wait(timeout=10)
        finally:
            tx.stop()
            rx.stop()
        frames = rx["out"].frames
        assert [float(np.asarray(f.tensors[0])[0, 0]) for f in frames] == [0.0, 1.0]
        if "ntp-sync=false" in props:
            assert [f.pts for f in frames] == [5.0, 6.0]  # no shared epoch: pts kept

    def test_max_buffer_size_drops_and_corrupt_messages_are_counted(self, broker):
        rx = parse_pipeline(f"mqttsrc name=ms host={broker.host} port={broker.port} "
                            "sub-topic=mb/t num-buffers=1 sub-timeout=5000 ! tensor_sink name=out")
        tx = parse_pipeline(f"appsrc name=src ! mqttsink host={broker.host} port={broker.port} "
                            "pub-topic=mb/t max-buffer-size=200 qos=1")
        raw = MqttClient(broker.host, broker.port)
        try:
            rx.start()
            assert broker.wait_subscriber("mb/t", 5)
            raw.publish("mb/t", b"not an mqtt frame", qos=1)
            raw.publish("mb/t", b"NNSMQTT1" + bytes(16) + b"garbage", qos=1)
            assert raw.drain(5) == 0
            tx.start()
            tx["src"].push(np.zeros(1000, np.float32))  # over max-buffer-size: dropped
            tx["src"].push(np.ones(4, np.float32))
            tx["src"].end_of_stream()
            tx.wait(timeout=10)
            rx.wait(timeout=10)
            assert rx.health()["ms"]["corrupt_dropped"] == 2
        finally:
            raw.close()
            tx.stop()
            rx.stop()
        assert [np.asarray(f.tensors[0]).tolist() for f in rx["out"].frames] == [[1, 1, 1, 1]]

    def test_a_full_receive_queue_counts_its_drops(self, broker):
        """A message the client acknowledged but the full receive queue
        could not take within 1 s is dropped and counted in ``dropped_full``
        (a loss even at qos=1)."""
        src = make_element("mqttsrc", **{"host": broker.host, "port": broker.port,
                                         "sub-topic": "full/t", "qos": 1,
                                         "max-msg-buf-size": 1})
        tx = parse_pipeline(f"appsrc name=src ! mqttsink host={broker.host} port={broker.port} "
                            "pub-topic=full/t qos=1")
        src.start()
        try:
            assert broker.wait_subscriber("full/t", 5)
            tx.start()
            for i in range(2):  # nothing reads: the second finds the queue full
                tx["src"].push(np.float32([i]))
            assert wait_until(lambda: src.health_info()["dropped_full"] == 1, 5)
            assert src.health_info() == {"corrupt_dropped": 0, "dropped_full": 1}
            frame = next(iter(src.frames()))
            assert np.asarray(frame.tensors[0]).tolist() == [0.0]
        finally:
            tx.stop()
            src.stop()

    def test_a_batch_through_stream_reaches_the_host_once_per_tensor(self, broker, monkeypatch):
        """A batch-through filter hands mqttsink BatchFrames of torch
        tensors: each micro-batch comes to the host in one copy per tensor
        (counted at ``buffer.to_numpy``, which ``materialize`` calls for a
        torch tensor), not one per frame."""
        from nnstreamer_tpu_torch.backends.torch_cuda import (
            register_torch_model,
            unregister_torch_model,
        )

        class Double(torch.nn.Module):
            def forward(self, x):
                return x * 2

        calls = []
        inner = tbuffer.to_numpy
        monkeypatch.setattr(tbuffer, "to_numpy", lambda t: (calls.append(tuple(t.shape)),
                                                            inner(t))[1])
        n, batch = 16, 8
        register_torch_model("mqtt_batch_through_double", Double())
        rx = parse_pipeline(f"mqttsrc host={broker.host} port={broker.port} sub-topic=bt/t "
                            f"num-buffers={n} sub-timeout=8000 ! tensor_sink name=out")
        tx = parse_pipeline(
            f"appsrc name=src ! tensor_filter name=f framework=torch-cuda "
            f"model=mqtt_batch_through_double accelerator=cpu max-batch={batch} "
            f"batch-timeout=2000 batch-through=true ! "
            f"mqttsink host={broker.host} port={broker.port} pub-topic=bt/t qos=1")
        try:
            rx.start()
            assert broker.wait_subscriber("bt/t", 5)
            tx.start()
            for i in range(n):
                tx["src"].push(torch.full((3,), float(i)), pts=float(i))
            tx["src"].end_of_stream()
            tx.wait(timeout=10)
            rx.wait(timeout=10)
        finally:
            tx.stop()
            rx.stop()
            unregister_torch_model("mqtt_batch_through_double")
        assert sorted(float(np.asarray(f.tensors[0])[0]) for f in rx["out"].frames) == \
            [2.0 * i for i in range(n)]
        assert calls and all(shape[0] > 1 for shape in calls)  # whole micro-batches
        assert sum(shape[0] for shape in calls) == n and len(calls) < n


@pytest.mark.parametrize("client_pkg,broker_pkg", [("torch", "jax"), ("jax", "torch")])
def test_either_client_against_the_other_broker(client_pkg, broker_pkg):
    """QoS 1 both ways, retained state and a wildcard across the packages."""
    from nnstreamer_tpu.distributed import mqtt as jm

    mods = {"torch": tm, "jax": jm}
    b = mods[broker_pkg].MiniBroker()
    Client = mods[client_pkg].MqttClient
    pub = Client(b.host, b.port)
    sub = None
    try:
        pub.publish("x/state", b"retained", retain=True, qos=1)
        assert pub.drain(5) == 0
        got = []
        sub = Client(b.host, b.port)
        sub.subscribe("x/#", lambda t, p: got.append((t, p)), qos=1)
        assert wait_until(lambda: got == [("x/state", b"retained")])
        pub.publish("x/live", b"hello", qos=1)
        assert pub.drain(5) == 0
        assert wait_until(lambda: ("x/live", b"hello") in got)
    finally:
        pub.close()
        if sub is not None:
            sub.close()
        b.close()


def raw_payloads(broker, topic: str, n: int, run) -> list:
    """The payloads of the first ``n`` messages on ``topic`` while ``run()``
    publishes them, read by a plain MQTT client."""
    got = []
    c = MqttClient(broker.host, broker.port)
    try:
        c.subscribe(topic, lambda t, p: got.append(p), qos=1)
        assert broker.wait_subscriber(topic, 5)
        run()
        assert wait_until(lambda: len(got) >= n, 10)
    finally:
        c.close()
    return got[:n]


def test_mqttsink_payloads_byte_equal_across_packages(broker):
    """The same frames through each package's mqttsink: the messages are
    byte-equal once the two f64 epochs of the header are cut out, and each
    package's mqttsrc decodes the other's."""
    from nnstreamer_tpu.core.buffer import TensorFrame as JaxFrame
    from nnstreamer_tpu.pipeline import parse_pipeline as jax_parse
    from nnstreamer_tpu_torch.core.buffer import TensorFrame

    frames = [np.arange(12, dtype=np.float32).reshape(3, 4) * k for k in range(3)]
    frame_type = {parse_pipeline: TensorFrame, jax_parse: JaxFrame}

    def send(parse, name):
        def run():
            p = parse(f"appsrc name=src ! mqttsink host={broker.host} port={broker.port} "
                      f"pub-topic=bx/{name} qos=1")
            p.start()
            try:
                for k, f in enumerate(frames):  # the frame's seq rides the wire
                    p["src"].push(frame_type[parse]([f], pts=0.5 * k, seq=k))
                p["src"].end_of_stream()
                p.wait(timeout=10)
            finally:
                p.stop()
        return run

    port_msgs = raw_payloads(broker, "bx/torch", 3, send(parse_pipeline, "torch"))
    jax_msgs = raw_payloads(broker, "bx/jax", 3, send(jax_parse, "jax"))
    for a, b in zip(port_msgs, jax_msgs):
        assert a[:8] == b[:8] == b"NNSMQTT1"
        assert a[24:] == b[24:]
    # each package's mqttsrc decodes the other's messages
    for src_parse, sink_parse, name in ((parse_pipeline, jax_parse, "j2t"),
                                        (jax_parse, parse_pipeline, "t2j")):
        rx = src_parse(f"mqttsrc host={broker.host} port={broker.port} sub-topic=bx/{name} "
                       f"num-buffers=3 sub-timeout=8000 ! tensor_sink name=out")
        rx.start()
        try:
            assert broker.wait_subscriber(f"bx/{name}", 5)
            send(sink_parse, name)()
            rx.wait(timeout=10)
        finally:
            rx.stop()
        got = [np.asarray(f.tensors[0]) for f in rx["out"].frames]
        assert len(got) == 3 and all(np.array_equal(g, w) for g, w in zip(got, frames))

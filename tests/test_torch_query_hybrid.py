"""Hybrid discovery of the port's tensor_query servers, and the JAX package's.

Mirrors the contracts of ``tests/test_query_hybrid.py`` (a client resolves
its servers from retained announces and round-robins them; a stopped
server deletes its announce; discovery times out; a crashed server's stale
announce is probed and skipped; a replaced pod is rediscovered mid-stream;
announces of another transport are skipped) and of
``tests/test_control_plane.py``'s ``TestReannounce`` and broker failover:
an announce published again into an amnesiac or standby broker, counted
exactly (``reannounces``, ``plane_reconnects``).  The announced state
becomes routing tiers: a draining server ranks ``TIER_DRAINING``, a server
told ``Pipeline.degraded_feedback`` ranks ``TIER_DEGRADED``, hints age out
and probes run concurrently.  Across the packages: each client discovers
the other's servers through either package's broker, and on a narrow
MobileNet-v2 the labels served by either package equal the JAX package's
local pipeline.  Every wait is bounded; the module's census checks that no
thread, socket or retained announce outlives it.
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

from nnstreamer_tpu_torch.core import fleet
from nnstreamer_tpu_torch.core.routing import TIER_DEGRADED, TIER_DRAINING, TIER_OK
from nnstreamer_tpu_torch.distributed import hybrid
from nnstreamer_tpu_torch.distributed.hybrid import Announcement
from nnstreamer_tpu_torch.distributed.mqtt import MiniBroker, MqttClient
from nnstreamer_tpu_torch.pipeline import ElementError, make_element, parse_pipeline
from torch_census import module_leak_check  # noqa: F401

torch.set_num_threads(2)

SCALER = {"torch": "framework=scaler custom=factor:2 accelerator=cpu",
          "jax": "framework=scaler custom=factor:2"}


def wait_until(pred, timeout=5.0, step=0.01) -> bool:
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            return False
        time.sleep(step)
    return True


def parser(pkg):
    if pkg == "jax":
        from nnstreamer_tpu.pipeline import parse_pipeline as jax_parse

        return jax_parse
    return parse_pipeline


@pytest.fixture
def broker():
    b = MiniBroker()
    yield b
    b.close()


def retained(broker_port: int, topic_filter: str, settle: float = 0.2) -> dict:
    """The retained announces under ``topic_filter``, decoded."""
    got = {}
    c = MqttClient("127.0.0.1", broker_port)
    try:
        c.subscribe(topic_filter, lambda t, p: got.__setitem__(t, json.loads(p) if p else None))
        time.sleep(settle)
    finally:
        c.close()
    return {t: v for t, v in got.items() if v is not None}


def server(broker_port, i, topic="pods", extra="", pkg="torch", fw=None):
    sp = parser(pkg)(
        f"tensor_query_serversrc name=src id={40 + i} host=127.0.0.1 port=0 connect-type=tcp "
        f"topic={topic} dest-host=127.0.0.1 dest-port={broker_port} {extra} ! "
        f"tensor_filter {fw or SCALER[pkg]} ! tensor_query_serversink id={40 + i}",
        name=f"qh-server-{i}")
    sp.start()
    return sp


def client_text(broker_port, topic, extra=""):
    return (f"appsrc name=a ! tensor_query_client name=q topic={topic} dest-host=127.0.0.1 "
            f"dest-port={broker_port} discovery-timeout=5 connect-type=tcp timeout=10 {extra} ! "
            "tensor_sink name=out")


def run_client(text, arrays, parse=parse_pipeline, keep=None):
    cl = parse(text, name="qh-client")
    cl.start()
    try:
        kept = keep(cl) if keep is not None else None
        for i, a in enumerate(arrays):
            cl["a"].push(a, pts=float(i))
        cl["a"].end_of_stream()
        cl.wait(timeout=30)
        return list(cl["out"].frames), cl.health()["q"], kept
    finally:
        cl.stop()


class TestHybridDiscovery:
    def test_client_discovers_and_round_robins_two_servers(self, broker):
        servers = [server(broker.port, i) for i in range(2)]
        try:
            out, health, n_conns = run_client(
                client_text(broker.port, "pods"),
                [np.full((4,), float(i), np.float32) for i in range(8)],
                keep=lambda cl: len(cl["q"]._conns))
            admitted = [s.health()["src"]["admitted"] for s in servers]
        finally:
            for s in servers:
                s.stop()
        assert n_conns == 2
        assert [float(np.asarray(f.tensors[0])[0]) for f in out] == [2.0 * i for i in range(8)]
        assert admitted == [4, 4] and health["delivered"] == 8
        assert retained(broker.port, "nns/query/pods/#") == {}  # stop deleted the announces

    def test_stopped_server_clears_retained_announce(self, broker):
        sp = server(broker.port, 7, topic="ephemeral")
        assert len(retained(broker.port, "nns/query/ephemeral/#")) == 1
        sp.stop()
        el = make_element("tensor_query_client", **{
            "topic": "ephemeral", "dest-host": "127.0.0.1", "dest-port": broker.port,
            "discovery-timeout": 0.5, "connect-type": "tcp"})
        with pytest.raises(ElementError, match="server announced"):
            el.start()

    def test_discovery_timeout_without_announces(self, broker):
        el = make_element("tensor_query_client", **{
            "topic": "nobody-home", "dest-host": "127.0.0.1", "dest-port": broker.port,
            "discovery-timeout": 0.3})
        t0 = time.monotonic()
        with pytest.raises(ElementError, match="server announced"):
            el.start()
        assert time.monotonic() - t0 < 3.0

    def test_stale_announce_from_crashed_server_skipped(self, broker):
        c = MqttClient("127.0.0.1", broker.port)
        sp = None
        try:
            c.publish("nns/query/mixed/crashed-1", json.dumps(
                {"host": "127.0.0.1", "port": 1, "connect_type": "tcp"}).encode(),
                retain=True, qos=1)
            assert c.drain(5.0) == 0
            sp = server(broker.port, 5, topic="mixed")
            el = make_element("tensor_query_client", **{
                "topic": "mixed", "dest-host": "127.0.0.1", "dest-port": broker.port,
                "discovery-timeout": 5.0, "connect-type": "tcp"})
            el.start()
            try:
                assert el._pstate.targets == (("127.0.0.1", sp["src"].props["port"]),)
            finally:
                el.stop()
        finally:
            c.publish("nns/query/mixed/crashed-1", b"", retain=True, qos=1)
            c.drain(5.0)
            c.close()
            if sp is not None:
                sp.stop()

    def test_stale_announces_are_probed_concurrently(self, broker, monkeypatch):
        """N stale announces cost one probe timeout, not N."""
        c = MqttClient("127.0.0.1", broker.port)
        sp = server(broker.port, 6, topic="many")
        inner = hybrid.probe_endpoint

        def slow_probe(host, port, timeout_s=0.5):
            if port < 100:
                time.sleep(0.4)  # stands in for a dial that times out
                return False
            return inner(host, port, timeout_s)

        monkeypatch.setattr(hybrid, "probe_endpoint", slow_probe)
        try:
            for k in range(1, 7):
                c.publish(f"nns/query/many/crashed-{k}", json.dumps(
                    {"host": "127.0.0.1", "port": k, "connect_type": "tcp"}).encode(),
                    retain=True, qos=1)
            assert c.drain(5.0) == 0
            el = make_element("tensor_query_client", **{
                "topic": "many", "dest-host": "127.0.0.1", "dest-port": broker.port,
                "discovery-timeout": 5.0, "connect-type": "tcp"})
            t0 = time.monotonic()
            el.start()
            probe_s = time.monotonic() - t0
            try:
                assert len(el._pstate.targets) == 1
            finally:
                el.stop()
            assert probe_s < 6 * 0.4  # concurrent: one 0.4 s wait, plus discovery's settle
        finally:
            for k in range(1, 7):
                c.publish(f"nns/query/many/crashed-{k}", b"", retain=True, qos=1)
            c.drain(5.0)
            c.close()
            sp.stop()

    def test_elastic_rediscovery_after_pod_replacement(self, broker):
        old = server(broker.port, 30, topic="elastic")
        new = None
        cl = parse_pipeline(client_text(broker.port, "elastic", "retries=1 timeout=5"),
                            name="qh-elastic")
        try:
            cl.start()
            cl["a"].push(np.full((4,), 1.0, np.float32))
            assert wait_until(lambda: len(cl["out"].frames) == 1, 10)
            old.stop()  # the pod is replaced: the old announce deleted, a new one published
            old = None
            new = server(broker.port, 31, topic="elastic")
            cl["a"].push(np.full((4,), 3.0, np.float32))
            cl["a"].end_of_stream()
            cl.wait(timeout=30)
            got = [np.asarray(f.tensors[0]) for f in cl["out"].frames]
            assert len(got) == 2 and np.allclose(got[1], 6.0)
            assert cl["q"]._pstate.targets == (("127.0.0.1", new["src"].props["port"]),)
        finally:
            cl.stop()
            for sp in (old, new):
                if sp is not None:
                    sp.stop()

    def test_connect_type_mismatch_announces_skipped(self, broker):
        sp = server(broker.port, 3, topic="tcponly")  # announces tcp
        try:
            el = make_element("tensor_query_client", **{
                "topic": "tcponly", "dest-host": "127.0.0.1", "dest-port": broker.port,
                "discovery-timeout": 0.5, "connect-type": "grpc"})
            with pytest.raises((ElementError, RuntimeError), match="server announced|grpc"):
                el.start()
        finally:
            sp.stop()


class TestAnnouncedState:
    def test_a_draining_server_announces_it_and_ranks_draining(self, broker):
        """A request held in flight keeps the draining server's listener open;
        meanwhile its announce says draining, and a client discovering then
        ranks it TIER_DRAINING and sends everything to the other server."""
        from nnstreamer_tpu_torch.core.buffer import TensorFrame
        from nnstreamer_tpu_torch.core.resilience import FAULTS
        from nnstreamer_tpu_torch.distributed.tcp_query import TcpQueryConnection

        servers = [server(broker.port, 50, topic="drain", fw="name=slow " + SCALER["torch"]),
                   server(broker.port, 51, topic="drain")]
        FAULTS.arm("element.slow.handle_frame", delay=1.5, times=1)
        port0 = servers[0]["src"].props["port"]
        conn = TcpQueryConnection("127.0.0.1", port0, 10.0)
        held = threading.Thread(target=lambda: conn.invoke(TensorFrame([np.float32([7])]), 10.0),
                                name="qh-held-request")
        cl = parse_pipeline(client_text(broker.port, "drain"), name="qh-drain")
        try:
            held.start()
            assert wait_until(lambda: servers[0]["src"].health_info()["inflight"] == 1)
            servers[0]["src"].request_drain()
            assert wait_until(lambda: any(
                v["draining"] for v in retained(broker.port, "nns/query/drain/#", 0.05).values()))
            cl.start()  # discovery sees draining:true while the listener is open
            q = cl["q"]
            assert q.health_info()["endpoint_hints"] == {
                f"127.0.0.1:{port0}": {"draining": True, "degraded": False}}
            ps = q._pstate
            tiers, _, _ = q._tiers_and_signals(ps, len(ps.conns), "rotate", time.monotonic())
            assert tiers[ps.targets.index(("127.0.0.1", port0))] == TIER_DRAINING
            assert sorted(tiers.values()) == [TIER_OK, TIER_DRAINING]
            for i in range(6):
                cl["a"].push(np.float32([i]))
            cl["a"].end_of_stream()
            cl.wait(timeout=20)
            assert [float(f.tensors[0][0]) for f in cl["out"].frames] == [2.0 * i for i in range(6)]
            assert servers[1]["src"].health_info()["admitted"] == 6
            assert cl.health()["q"]["goaway_replies"] == 0  # ranked away, never refused
            # the hints age out as one generation
            q._hints_ts -= q._HINT_TTL_S
            tiers, _, _ = q._tiers_and_signals(ps, len(ps.conns), "rotate", time.monotonic())
            assert sorted(tiers.values()) == [TIER_OK, TIER_OK]
        finally:
            cl.stop()
            held.join(timeout=10)
            FAULTS.reset()
            conn.close()
            for s in servers:
                s.stop()

    def test_degraded_feedback_announces_degraded(self, broker):
        sp = server(broker.port, 60, topic="deg")
        msgs = []
        sp.add_bus_watcher(msgs.append)
        try:
            sp.degraded_feedback("f", "lost gpu.1")
            sp.degraded_feedback("f", "again")  # the announce changes once
            assert wait_until(lambda: [v["degraded"] for v in retained(
                broker.port, "nns/query/deg/#", 0.05).values()] == [True])
            assert sp.health()["src"]["degraded"] == 1
            el = make_element("tensor_query_client", **{
                "topic": "deg", "dest-host": "127.0.0.1", "dest-port": broker.port,
                "connect-type": "tcp"})
            el.start()
            try:
                tiers, _, _ = el._tiers_and_signals(el._pstate, 1, "rotate", time.monotonic())
                assert tiers == {0: TIER_DEGRADED}
            finally:
                el.stop()
        finally:
            sp.stop()
        assert [(m.kind, m.source, m.data) for m in msgs if m.source == "f"] == [
            ("warning", "f", {"degraded": "lost gpu.1"}), ("warning", "f", {"degraded": "again"})]

    @pytest.mark.parametrize("info", [
        {"host": "h", "port": 1},
        {"host": "h", "port": 1, "draining": True},
        {"host": "h", "port": 1, "degraded": True, "digest": {"seq": 3}},
        {"host": "h", "port": 1, "draining": True, "digest": {"draining": False, "degraded": True}},
        {"host": "h", "port": 1, "digest": "not a dict", "degraded": 1}])
    def test_hint_from_announce_reads_as_the_jax_package(self, info):
        from nnstreamer_tpu.core.fleet import DIGEST_KEY, hint_from_announce

        assert fleet.DIGEST_KEY == DIGEST_KEY
        assert fleet.hint_from_announce(info) == hint_from_announce(info)


class TestBrokerFailover:
    def test_announce_survives_broker_amnesia(self):
        broker = MiniBroker()
        port = broker.port
        ann = sub = None
        try:
            ann = Announcement("127.0.0.1", port, "nns/query/ra/s0",
                               {"host": "h", "port": 1, "seq": 1})
            assert ann.connected and ann.reannounces == 0
            broker.close()  # the retained store dies with it
            assert wait_until(lambda: not ann.connected)
            ann.update({"seq": 2}, wait_ack=False)  # merged while dark
            with pytest.raises(ConnectionError):
                ann.update({"seq": 2}, wait_ack=False, require_connected=True)
            broker = MiniBroker(port=port)
            assert wait_until(lambda: ann.connected, 10)
            assert ann.reconnects == 1 and ann.reannounces == 1  # final when connected
            got, done = [], threading.Event()
            sub = MqttClient("127.0.0.1", port)
            sub.subscribe("nns/query/ra/#",
                          lambda t, p: (got.append(json.loads(p.decode())), done.set()), qos=1)
            assert done.wait(5.0)
            assert got[0]["seq"] == 2  # the current merged announce
        finally:
            if sub is not None:
                sub.close()
            if ann is not None:
                ann.clear()
            broker.close()

    def test_servers_fail_over_and_a_fresh_client_discovers_through_the_standby(self):
        primary, standby = MiniBroker(), MiniBroker()
        extra = f"dest-brokers=127.0.0.1:{standby.port}"
        servers = [server(primary.port, 70 + i, topic="fo", extra=extra) for i in range(2)]
        try:
            h = [s.health()["src"] for s in servers]
            assert [(x["reannounces"], x["plane_reconnects"]) for x in h] == [(0, 0), (0, 0)]
            primary.close()
            assert wait_until(lambda: len(retained(standby.port, "nns/query/fo/#", 0.05)) == 2,
                              10)
            h = [s.health()["src"] for s in servers]
            assert [(x["reannounces"], x["plane_reconnects"]) for x in h] == [(1, 1), (1, 1)]
            out, health, n = run_client(
                client_text(primary.port, "fo", extra),
                [np.float32([i]) for i in range(6)], keep=lambda cl: len(cl["q"]._conns))
            assert n == 2 and health["delivered"] == 6
            assert [float(f.tensors[0][0]) for f in out] == [2.0 * i for i in range(6)]
            names = {s.name for s in servers[0].metrics_snapshot().samples}
            assert {"nns.query.reannounces", "nns.query.plane_reconnects"} <= names
        finally:
            for s in servers:
                s.stop()
            standby.close()


    def test_a_client_fails_over_when_its_broker_dies_during_discovery(self):
        """The client's broker accepts the subscription and then dies before
        any announce came: discovery moves on to the ``dest-brokers``
        standby, where the servers announce, within one discovery timeout."""
        primary, standby = MiniBroker(), MiniBroker()
        servers = [server(standby.port, 75 + i, topic="dd") for i in range(2)]
        killer = threading.Thread(
            target=lambda: primary.wait_subscriber("nns/query/dd/x", 5.0) and primary.close(),
            name="qh-broker-killer")
        try:
            killer.start()
            t0 = time.monotonic()
            out, health, n = run_client(
                client_text(primary.port, "dd", f"dest-brokers=127.0.0.1:{standby.port}"),
                [np.float32([i]) for i in range(4)], keep=lambda cl: len(cl["q"]._conns))
            assert time.monotonic() - t0 < 5.0
            assert not primary.has_subscriber("nns/query/dd/x")
            assert n == 2 and health["delivered"] == 4
            assert [float(f.tensors[0][0]) for f in out] == [2.0 * i for i in range(4)]
        finally:
            killer.join(timeout=10)
            for s in servers:
                s.stop()
            primary.close()
            standby.close()


@pytest.mark.parametrize("server_pkg,broker_pkg", [
    ("torch", "torch"), ("torch", "jax"), ("jax", "torch"), ("jax", "jax")])
def test_discovery_across_packages(server_pkg, broker_pkg):
    """A client of one package discovers servers of the other through
    either package's broker, and the answers come back in order."""
    from nnstreamer_tpu.distributed import mqtt as jm

    client_pkg = "jax" if server_pkg == "torch" else "torch"
    b = (jm.MiniBroker if broker_pkg == "jax" else MiniBroker)()
    servers = [server(b.port, 80 + i, topic="xp", pkg=server_pkg) for i in range(2)]
    try:
        out, health, n = run_client(client_text(b.port, "xp"),
                                    [np.float32([i, -i]) for i in range(6)],
                                    parse=parser(client_pkg),
                                    keep=lambda cl: len(cl["q"]._conns))
    finally:
        for s in servers:
            s.stop()
        b.close()
    assert n == 2 and health["delivered"] == 6
    assert [np.asarray(f.tensors[0]).tolist() for f in out] == [[2.0 * i, -2.0 * i]
                                                                for i in range(6)]


MODEL, SIZE = "torch_query_hybrid_mobilenet", 32
_PROPS = {"dtype": "float32", "classes": "10", "width": "0.35", "size": str(SIZE)}
MOBILENET = {
    "jax": f"framework=jax-xla model={MODEL} max-batch=4 batch-timeout=200",
    "torch": f"framework=torch-cuda model={MODEL} accelerator=cpu max-batch=4 batch-timeout=200",
}


@pytest.fixture(scope="module")
def mobilenet():
    from nnstreamer_tpu.backends.jax_xla import register_jax_model, unregister_jax_model
    from nnstreamer_tpu.models import build as jax_build
    from nnstreamer_tpu_torch.backends.torch_cuda import (
        register_torch_model,
        unregister_torch_model,
    )
    from nnstreamer_tpu_torch.models import build as torch_build
    from nnstreamer_tpu_torch.models.mobilenet_v2 import state_dict_from_flax
    from torch_parity import randomized_batchnorm

    fn, variables, in_spec, out_spec = jax_build("mobilenet_v2", dict(_PROPS, pallas="1"))
    variables = randomized_batchnorm(variables)
    register_jax_model(MODEL, fn, variables, in_spec, out_spec)
    module, t_in, t_out = torch_build("mobilenet_v2", _PROPS)
    module.load_state_dict(state_dict_from_flax(variables), strict=True)
    register_torch_model(MODEL, module, t_in, t_out)
    yield
    unregister_jax_model(MODEL)
    unregister_torch_model(MODEL)


@pytest.fixture(scope="module")
def jax_labels(mobilenet):
    """The frames of the labeling test and the JAX package's own pipeline's
    labels for them."""
    frames = list(np.random.default_rng(7).integers(0, 256, (8, SIZE, SIZE, 3), dtype=np.uint8))
    local = parser("jax")(f"appsrc name=a ! tensor_filter {MOBILENET['jax']} ! "
                          "tensor_decoder mode=image_labeling ! tensor_sink name=out")
    local.start()
    try:
        for i, f in enumerate(frames):
            local["a"].push(f, pts=float(i))
        local["a"].end_of_stream()
        local.wait(timeout=60)
        want = [f.meta["label_index"] for f in local["out"].frames]
    finally:
        local.stop()
    assert len(want) == len(frames)
    return frames, want


@pytest.mark.parametrize("server_pkg", ["torch", "jax"])
def test_discovered_labels_equal_the_jax_pipeline(jax_labels, server_pkg):
    """A narrow MobileNet-v2 served by one package and discovered by the
    other's client: the labels equal the JAX package's local pipeline on
    the same frames and weights."""
    frames, want = jax_labels
    client_pkg = "jax" if server_pkg == "torch" else "torch"
    b = MiniBroker()
    fw = MOBILENET[server_pkg] + " ! tensor_decoder mode=image_labeling"
    sp = server(b.port, 90, topic="mn", pkg=server_pkg, fw=fw)
    try:
        out, health, _ = run_client(client_text(b.port, "mn", "timeout=60"), frames,
                                    parse=parser(client_pkg))
    finally:
        sp.stop()
        b.close()
    assert [f.meta["label_index"] for f in out] == want and health["delivered"] == 8

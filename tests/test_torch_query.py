"""The port's tensor_query elements end to end over 127.0.0.1.

Mirrors the contracts of the JAX package's ``tests/test_distributed.py``
(``TestQueryRoundTrip``, ``TestTcpQueryTransport``),
``tests/test_query_blocks.py``, ``tests/test_fleet.py::TestTenantAdmission*``
and ``tests/test_continuous_batching.py``'s TCP stream tests: ordered round
trips, wire micro-batches and block ingress, a live stream answered without
EOS, BUSY admission and tenant quotas counted exactly, a GOAWAY drain with
failover and nothing lost, deadline expiry, generation streams (tokens
equal to the slot model's oracle, a dead client's slot freed, the typed
expiry), span segments that add up to their total, the ``nns.query.*``
series in a scrape, and the properties that once raised naming their slice
(telemetry digests, stream resume, the fenced drain) taking effect.  The
gRPC cases run where ``grpc`` imports.  Servers bind port 0 and stop in a
``finally``; the module's census checks that nothing outlives it.
"""

import threading
import time

import numpy as np
import pytest
import torch

from nnstreamer_tpu_torch.core.buffer import TensorFrame
from nnstreamer_tpu_torch.core.liveness import DEADLINE_META
from nnstreamer_tpu_torch.core.telemetry import SPAN_META
from nnstreamer_tpu_torch.pipeline import ElementError, parse_pipeline
from torch_census import module_leak_check  # noqa: F401

torch.set_num_threads(2)

CTS = ["tcp", pytest.param("grpc", marks=pytest.mark.skipif(
    __import__("importlib").util.find_spec("grpc") is None, reason="grpc is not installed"))]


def server(sid, ct="tcp", extra="", mid="", fw="framework=scaler custom=factor:2"):
    pipe = parse_pipeline(
        f"tensor_query_serversrc name=ssrc id={sid} host=127.0.0.1 port=0 connect-type={ct} "
        f"{extra} ! {mid}tensor_filter name=f {fw} accelerator=cpu ! "
        f"tensor_query_serversink id={sid}", name=f"srv{sid}")
    pipe.start()
    return pipe, pipe["ssrc"].props["port"]


def client(port, ct="tcp", extra="", name="cli"):
    pipe = parse_pipeline(
        f"appsrc name=src ! tensor_query_client name=q host=127.0.0.1 port={port} "
        f"connect-type={ct} {extra} ! tensor_sink name=out", name=name)
    pipe.start()
    return pipe


def run_client(port, pushes, ct="tcp", extra="", timeout=30):
    cl = client(port, ct, extra)
    try:
        for p in pushes:
            cl["src"].push(p)
        cl["src"].end_of_stream()
        cl.wait(timeout=timeout)
        return cl["out"].frames, cl.health()["q"]
    finally:
        cl.stop()


def vals(frames):
    return [float(f.tensors[0][0]) for f in frames]


@pytest.mark.parametrize("ct", CTS)
def test_offload_roundtrip_ordered(ct):
    srv, port = server(1810 if ct == "tcp" else 1811, ct)
    try:
        frames, h = run_client(port, [np.float32([i]) for i in range(8)], ct, "max-in-flight=4")
        assert vals(frames) == [2.0 * i for i in range(8)]
        assert all(f.meta.get("client_id") is not None for f in frames)
        assert h["delivered"] == 8 and h["retried"] == 0
    finally:
        srv.stop()


@pytest.mark.parametrize("ct", CTS)
@pytest.mark.parametrize("version", [1, 2])
def test_wire_batch_ordered(ct, version):
    srv, port = server(1812, ct, f"wire-version={version}")
    try:
        frames, h = run_client(port, [np.float32([i]) for i in range(11)], ct,
                               f"wire-batch=4 max-in-flight=4 wire-version={version}")
        assert vals(frames) == [2.0 * i for i in range(11)]
        assert h["delivered"] == 11
    finally:
        srv.stop()


def test_live_stream_emits_without_eos():
    srv, port = server(1813)
    cl = client(port, extra="max-in-flight=8")
    try:
        for i in range(2):  # fewer than the window: the idle hook releases them
            cl["src"].push(np.float32([i]))
        deadline = time.monotonic() + 10
        while len(cl["out"].frames) < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert vals(cl["out"].frames) == [0.0, 2.0]
        cl["src"].end_of_stream()
        cl.wait(timeout=10)
    finally:
        cl.stop()
        srv.stop()


def test_large_payload_intact():
    srv, port = server(1814, fw="framework=scaler custom=factor:1")
    try:
        rng = np.random.default_rng(0)
        payloads = [rng.integers(0, 255, (224, 224, 3)).astype(np.uint8) for _ in range(4)]
        frames, _ = run_client(port, payloads, extra="wire-batch=2")
        assert len(frames) == 4
        for got, want in zip(frames, payloads):
            np.testing.assert_array_equal(np.asarray(got.tensors[0]), want * 1)
    finally:
        srv.stop()


def test_blocks_map_to_wire_batches_and_block_ingress_batches_the_server():
    """push_block upstream of the client rides one request per block; with
    block-ingress=true the server's filter invokes whole wire batches."""
    srv, port = server(1815, extra="block-ingress=true",
                       fw="framework=scaler custom=factor:2 max-batch=8")
    try:
        cl = client(port, extra="wire-batch=8 max-in-flight=1")
        try:
            for b in range(3):
                cl["src"].push_block(np.arange(b * 8, b * 8 + 8, dtype=np.float32)[:, None],
                                     pts=[0.1 * i for i in range(b * 8, b * 8 + 8)])
            cl["src"].end_of_stream()
            cl.wait(timeout=30)
            frames = cl["out"].frames
        finally:
            cl.stop()
        assert vals(frames) == [2.0 * i for i in range(24)]
        assert [fr.pts for fr in frames] == [0.1 * i for i in range(24)]
        f = srv["f"]
        assert (f.invokes, f._invoked_frames) == (3, 24)  # one invoke per wire batch
    finally:
        srv.stop()


@pytest.mark.parametrize("case", ["dtype", "shape"])
def test_block_ingress_nonuniform_falls_back(case):
    srv, port = server(1816, extra="block-ingress=true",
                       fw="framework=scaler custom=factor:2 max-batch=1")
    try:
        pushes = ([np.float32([1.0]), np.int32([2])] if case == "dtype"
                  else [np.float32([1.0]), np.float32([1.0, 2.0]), np.float32([3.0])])
        frames, _ = run_client(port, pushes, extra="wire-batch=4")
        assert len(frames) == len(pushes)
        for got, want in zip(frames, pushes):
            assert got.tensors[0].dtype == want.dtype
            np.testing.assert_array_equal(got.tensors[0], want * 2)
    finally:
        srv.stop()


def test_fanout_two_servers_ordered_and_failover_no_loss():
    s1, p1 = server(1817)
    s2, p2 = server(1818)
    try:
        frames, h = run_client(p1, [np.float32([i]) for i in range(12)],
                               extra=f"hosts=127.0.0.1:{p1},127.0.0.1:{p2} max-in-flight=4")
        assert vals(frames) == [2.0 * i for i in range(12)]
        assert sorted(h["remotes"]) == sorted([f"127.0.0.1:{p1}", f"127.0.0.1:{p2}"])
        cl = client(p1, extra=f"hosts=127.0.0.1:{p1},127.0.0.1:{p2} wire-batch=4 "
                    "max-in-flight=2 retries=2 timeout=5")
        try:
            for i in range(24):
                cl["src"].push(np.float32([i]))
                if i == 8:
                    s1.stop()  # one server dies mid-stream
                time.sleep(0.01)
            cl["src"].end_of_stream()
            cl.wait(timeout=30)
            got = {int(v // 2) for v in vals(cl["out"].frames)}
        finally:
            cl.stop()
        assert got == set(range(24))
    finally:
        s1.stop()
        s2.stop()


def test_unreachable_server_fails_and_degrade_modes():
    for mode, want in (("passthrough", [1.0]), ("skip", [])):
        frames, h = run_client(1, [np.float32([1])], extra=f"timeout=1.5 degrade={mode}")
        assert vals(frames) == want and h["degraded_frames"] == 1
    cl = client(1, extra="timeout=1.5")
    try:
        cl["src"].push(np.float32([1]))
        cl["src"].end_of_stream()
        with pytest.raises(Exception):
            cl.wait(timeout=20)
    finally:
        cl.stop()


def test_busy_admission_and_tenant_quota_exact():
    srv, port = server(1819, extra="max-inflight=16 tenant-quotas=hot:1",
                       mid="identity sleep=0.05 ! ")
    try:
        n = 8
        frames, h = run_client(port, [np.float32([i]) for i in range(n)],
                               extra="tenant=hot busy-retries=40 retry-backoff=0.01 "
                               "max-in-flight=4 timeout=5", timeout=60)
        assert sorted(vals(frames)) == [2.0 * i for i in range(n)]
        assert h["busy_replies"] > 0
        assert all(b["trips"] == 0 and b["state"] == "closed" for b in h["breakers"].values())
        row = srv.health()["ssrc"]["tenants"]["hot"]
        assert (row["admitted"], row["shed"], row["quota"]) == (n, h["busy_replies"], 1)
        assert h["retried"] == h["busy_replies"]
    finally:
        srv.stop()


def test_busy_without_budget_fails_and_is_breaker_immune():
    srv, port = server(1820, extra="max-inflight=1",
                       mid="identity sleep=0.3 ! ")
    try:
        frames, h = run_client(port, [np.float32([i]) for i in range(3)],
                               extra="busy-retries=0 max-in-flight=3 degrade=skip", timeout=30)
        assert len(frames) + h["degraded_frames"] == 3
        assert h["busy_replies"] == h["degraded_frames"] >= 1
        assert all(b["trips"] == 0 for b in h["breakers"].values())
        assert srv.health()["ssrc"]["load_shed"] == h["busy_replies"]
    finally:
        srv.stop()


def test_drain_goaway_failover_nothing_lost():
    s1, p1 = server(1821, extra="drain-deadline=5", mid="identity sleep=0.005 ! ")
    s2, p2 = server(1822)
    cl = client(p1, extra=f"hosts=127.0.0.1:{p1},127.0.0.1:{p2} max-in-flight=2")
    try:
        n = 40
        for i in range(n):
            cl["src"].push(np.float32([i]))
            if i == 10:
                s1["ssrc"].request_drain()
            time.sleep(0.005)
        cl["src"].end_of_stream()
        cl.wait(timeout=30)
        got = vals(cl["out"].frames)
        h = cl.health()["q"]
        deadline = time.monotonic() + 10
        while not s1["ssrc"].drain_complete and time.monotonic() < deadline:
            time.sleep(0.02)
        assert s1["ssrc"].drain_complete
        h1 = s1.health()["ssrc"]
    finally:
        cl.stop()
        s1.stop()
        s2.stop()
    assert got == [2.0 * i for i in range(n)]  # ordered, none lost or duplicated
    assert h["goaway_replies"] == h1["goaway_sent"] >= 1
    assert all(b["trips"] == 0 for b in h["breakers"].values())
    assert h1["lifecycle"] == "stopped" and h1["draining"]


def test_server_stopped_after_its_drain_fails_over_at_once():
    """A server drained while idle (no request meets its GOAWAY) and then
    stopped: the client's parked sockets to it are closed, so the next
    request to it dials afresh, is refused before anything is sent and
    goes to the other server at once, with ``retries=0``.  Exact values:
    every frame once, in order."""
    s1, p1 = server(1830)
    s2, p2 = server(1831)
    cl = client(p1, extra=f"hosts=127.0.0.1:{p1},127.0.0.1:{p2} max-in-flight=4 wire-batch=4")
    try:
        for i in range(32):
            cl["src"].push(np.float32([i]))
        deadline = time.monotonic() + 10
        while len(cl["out"].frames) < 32 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert s1.health()["ssrc"]["admitted"] >= 1  # the pool holds sockets to s1
        s1["ssrc"].request_drain()
        while not s1["ssrc"].drain_complete and time.monotonic() < deadline:
            time.sleep(0.01)
        s1.stop()
        for i in range(32, 64):
            cl["src"].push(np.float32([i]))
        cl["src"].end_of_stream()
        cl.wait(timeout=30)
        got, h = vals(cl["out"].frames), cl.health()["q"]
    finally:
        cl.stop()
        s1.stop()
        s2.stop()
    assert got == [2.0 * i for i in range(64)]
    assert h["delivered"] == 64 and h["degraded_frames"] == 0 and h["retried"] >= 1


def test_pipeline_drain_of_server_counts_nothing_dropped():
    srv, port = server(1823, mid="identity sleep=0.01 ! ")
    cl = client(port, extra="max-in-flight=4")
    try:
        for i in range(10):
            cl["src"].push(np.float32([i]))
        time.sleep(0.05)
        res = srv.drain(timeout=10)
        assert res["dropped"] == 0
        cl["src"].end_of_stream()
        try:
            cl.wait(timeout=20)
        except Exception:
            pass  # frames sent after the listener closed fail: none were admitted
        h = cl.health()["q"]
        assert h["delivered"] + h["degraded_frames"] <= 10
        assert vals(cl["out"].frames) == [2.0 * i for i in range(len(cl["out"].frames))]
    finally:
        cl.stop()
        srv.stop()


def test_deadline_expiry_counted():
    srv, port = server(1824, mid="identity sleep=0.5 ! ")
    try:
        f = TensorFrame([np.float32([1])])
        f.meta[DEADLINE_META] = time.monotonic() + 0.2
        frames, h = run_client(port, [f], extra="timeout=5 degrade=skip")
        assert frames == [] and h["degraded_frames"] == 1
        assert h["deadline_expired"] == 0  # the request itself timed out server-side
        f = TensorFrame([np.float32([1])])
        f.meta[DEADLINE_META] = time.monotonic() - 1.0
        # delivered to the client past its budget: it never dials
        frames, h = run_client(port, [f], extra="timeout=5 degrade=skip late-policy=deliver")
        assert h["deadline_expired"] == 1 and h["degraded_frames"] == 1
        assert srv.health()["ssrc"]["admitted"] == 1
    finally:
        srv.stop()


@pytest.mark.parametrize("ct", CTS)
def test_spans_add_up_and_query_series_scraped(ct):
    srv, port = server(1825 if ct == "tcp" else 1826, ct)
    cl = client(port, ct, name=f"spancli{ct}")
    try:
        for i in range(5):
            cl["src"].push(np.float32([i]))
        deadline = time.monotonic() + 15
        while len(cl["out"].frames) < 5 and time.monotonic() < deadline:
            time.sleep(0.01)
        for ans in cl["out"].frames:
            s = ans.meta[SPAN_META]
            seg = (s["client_queue"] + s["wire"] + s["server_queue"] + s["device_dispatch"]
                   + s["device_compute"])
            assert seg == s["total"]  # the total is the segments' sum, exactly
            assert all(0.0 <= s[k] <= s["total"] for k in
                       ("client_queue", "wire", "server_queue", "device_dispatch",
                        "device_compute"))
            assert s["device_compute"] > 0.0 and s["remote"] == f"127.0.0.1:{port}"
        agg = cl.health()["q"]["remotes"][f"127.0.0.1:{port}"]
        assert agg["requests"] == 5
        names = {s.name for s in cl.metrics_snapshot().samples}
        assert {"nns.query.delivered", "nns.query.rtt_seconds_count", "nns.query.breaker_open",
                "nns.query.remote_e2e_ms", "nns.query.client_inflight"} <= names | {
            n for n in names if n.startswith("nns.query.rtt_seconds")}
        srv_names = {s.name for s in srv.metrics_snapshot().samples}
        assert {"nns.query.inflight", "nns.query.admitted", "nns.query.tenant_admitted",
                "nns.lifecycle.server_state", "nns.query.corrupt_requests"} <= srv_names
        mport = srv.serve_metrics(0)
        import urllib.request

        text = urllib.request.urlopen(f"http://127.0.0.1:{mport}/metrics", timeout=5).read()
        assert b"nns_query_admitted" in text and b"nns_query_ingress_depth" in text
        cl["src"].end_of_stream()
        cl.wait(timeout=10)
    finally:
        cl.stop()
        srv.stop()


def _discovery_case(case: str, broker, standby) -> None:
    """One discovery property, set as the refused cases once set it, doing
    what it does now."""
    from nnstreamer_tpu_torch.distributed.hybrid import discover_endpoints

    def announced():
        return discover_endpoints("127.0.0.1", broker.port, "nns/query/#", timeout_s=0.3)

    if case in ("serversrc topic", "serversrc dest-port"):
        # one of topic/dest-port alone announces nothing; both announce
        key = "topic=t" if case == "serversrc topic" else f"dest-port={broker.port}"
        for props, want in ((key, 0), (f"topic=t dest-port={broker.port}", 1)):
            srv, port = server(90, extra=f"{props} dest-host=127.0.0.1")
            try:
                found = announced()
                assert len(found) == want and all(hp[1] == port for hp in found.values())
            finally:
                srv.stop()
        assert announced() == {}  # the stop deleted the announce
        return
    if case == "serversrc dest-brokers":
        srv, port = server(91, extra=f"topic=t dest-host=127.0.0.1 dest-port={broker.port} "
                                     f"dest-brokers=127.0.0.1:{standby.port}")
        try:
            assert srv.health()["ssrc"]["plane_reconnects"] == 0
            assert list(announced().values()) == [("127.0.0.1", port)]
        finally:
            srv.stop()
        return
    srv, port = server(92, extra=f"topic=t dest-host=127.0.0.1 dest-port={broker.port}")
    try:
        if case == "client topic":
            frames, health = run_client(0, [np.float32([3])], extra=(
                f"topic=t dest-host=127.0.0.1 dest-port={broker.port}"))
            assert float(frames[0].tensors[0][0]) == 6.0
            assert health["servers"] == [f"127.0.0.1:{port}"]
        else:  # client discovery-timeout: waits that long for an announce
            el_text = (f"appsrc ! tensor_query_client topic=none dest-host=127.0.0.1 "
                       f"dest-port={broker.port} discovery-timeout=0.3 connect-type=tcp ! "
                       "tensor_sink")
            pipe = parse_pipeline(el_text)
            t0 = time.monotonic()
            with pytest.raises(ElementError, match="no live server announced on topic 'none' "
                                                   r"within 0\.3s"):
                pipe.start()
            pipe.stop()
            assert time.monotonic() - t0 < 3.0
    finally:
        srv.stop()


@pytest.mark.parametrize("case", ["serversrc topic", "serversrc dest-port",
                                  "serversrc dest-brokers", "client topic",
                                  "client discovery-timeout"])
def test_discovery_properties_work_now(case):
    """The five discovery properties that once raised naming their slice:
    each now does what the JAX package's does."""
    from nnstreamer_tpu_torch.distributed.mqtt import MiniBroker

    broker, standby = MiniBroker(), MiniBroker()
    try:
        _discovery_case(case, broker, standby)
    finally:
        broker.close()
        standby.close()


def _sim_gen_server(sid, extra=""):
    pipe = parse_pipeline(
        f"tensor_query_serversrc name=ssrc id={sid} host=127.0.0.1 port=0 connect-type=tcp "
        f"{extra} ! tensor_generator name=gen slots=2 custom=sim:1,sim_step_ms:2,vocab:997 "
        f"max-new=40 chunk=4 ! tensor_query_serversink id={sid}", name=f"gsrv{sid}")
    pipe.start()
    return pipe, pipe["ssrc"].props["port"]


def test_later_slices_raise_naming_their_item():
    """The properties that once raised naming their slice now start and take
    effect: ``digest-interval`` publishes digests on the announce, a fenced
    ``request_drain(epoch)`` hands the live stream off (and a stale epoch
    is refused), ``stream-resume=true`` with ``resume-retries=1`` migrates
    it with every token once, and ``stream-resume=false`` surfaces the
    hand-off instead."""
    from nnstreamer_tpu_torch.core.autoscale import StaleEpochError
    from nnstreamer_tpu_torch.distributed.mqtt import MiniBroker

    broker = MiniBroker()
    try:
        s1, p1 = _sim_gen_server(1831, f"topic=dg dest-host=127.0.0.1 dest-port={broker.port} "
                                       "digest-interval=0.1")
        s2, p2 = _sim_gen_server(1832)
        try:
            deadline = time.monotonic() + 10
            while not s1.health()["ssrc"].get("digests_published"):
                assert time.monotonic() < deadline, "no digest published"
                time.sleep(0.02)
            prompt = np.arange(1, 6, dtype=np.int32)
            runs = {}
            for resume, hosts in (("true resume-retries=1", f"127.0.0.1:{p1},127.0.0.1:{p2}"),
                                  ("false", f"127.0.0.1:{p2}")):
                cl = client(p1, extra=f"hosts={hosts} stream=true "
                                      f"retry-backoff=0.01 stream-resume={resume}",
                            name=f"cli-{resume[:4]}")
                try:
                    cl["src"].push(prompt)
                    deadline = time.monotonic() + 10
                    while not cl["out"].frames:
                        assert time.monotonic() < deadline, "no chunk"
                        time.sleep(0.002)
                    if resume == "false":
                        s2["gen"].note_stream_drain()  # the hand-off, with no drain
                    else:
                        s1["ssrc"].request_drain(epoch=3)
                        with pytest.raises(StaleEpochError):
                            s1["ssrc"].request_drain(epoch=2)
                    cl["src"].end_of_stream()
                    try:
                        cl.wait(timeout=30)
                        runs[resume] = None
                    except Exception as e:  # noqa: BLE001 — the surfaced hand-off
                        runs[resume] = e
                    frames, health = list(cl["out"].frames), cl.health()["q"]
                finally:
                    cl.stop()
                toks = [t for f in frames if f.tensors for t in np.asarray(f.tensors[0])[0]]
                if resume == "false":
                    assert runs[resume] is not None and health["stream_migrations"] == 0
                    assert 0 < len(toks) < 40
                    continue
                assert runs[resume] is None
                t, want = int(prompt.sum()) % 997, []
                for _ in range(40):
                    want.append(t)
                    t = (31 * t + 17) % 997
                assert toks == want
                assert [f.meta["chunk_index"] for f in frames] == list(range(len(frames)))
                assert (health["stream_migrations"], health["stream_resumes"],
                        health["resume_failures"]) == (1, 0, 0)
                srv = s1.health()
                assert srv["gen"]["gen_goaway_evicted"] == 1
                assert (srv["ssrc"]["stale_epoch_rejects"], srv["ssrc"]["fence_epoch"]) == (1, 3)
                assert s2.health()["gen"]["gen_resumes"] == 1
        finally:
            s1.stop()
            s2.stop()
    finally:
        broker.close()
    with pytest.raises(ElementError, match="connect-type"):
        bad = parse_pipeline("appsrc ! tensor_query_client port=5 connect-type=udp ! tensor_sink")
        try:
            bad.start()
        finally:
            bad.stop()


def test_serversrc_clamps_wire_version_and_connect_type_default_is_grpc():
    pipe = parse_pipeline("tensor_query_serversrc name=s id=1827 host=127.0.0.1 connect-type=tcp "
                          "wire-version=7 ! tensor_query_serversink id=1827")
    pipe.start()
    try:
        assert pipe["s"]._core.wire_version == 2
    finally:
        pipe.stop()
    from nnstreamer_tpu_torch.elements.query import TensorQueryClient, TensorQueryServerSrc

    assert TensorQueryServerSrc.PROPERTIES["connect-type"].default == "grpc"
    assert TensorQueryClient.PROPERTIES["connect-type"].default == "grpc"


# -- generation streams -----------------------------------------------------------
VOCAB = 997


def oracle(prompt, n):
    """The simulated slot model's tokens: t1 = sum(prompt) % V, then
    t_{j+1} = (31 t_j + 17) % V."""
    t = int(np.asarray(prompt, np.int64).sum()) % VOCAB
    out = [t]
    for _ in range(n - 1):
        t = (31 * t + 17) % VOCAB
        out.append(t)
    return np.asarray(out, np.int32)[None, :]


def gen_server(sid, slots=2, n=12, step_ms=1.0, ct="tcp"):
    custom = f"sim:1,sim_step_ms:{step_ms},sim_per_slot_ms:0.05,sim_prefill_ms:0.02,vocab:{VOCAB}"
    pipe = parse_pipeline(
        f"tensor_query_serversrc name=ssrc id={sid} host=127.0.0.1 port=0 connect-type={ct} ! "
        f"tensor_generator name=gen slots={slots} custom={custom} max-new={n} chunk=3 ! "
        f"tensor_query_serversink id={sid}", name=f"gsrv{sid}")
    pipe.start()
    return pipe, pipe["ssrc"].props["port"]


def tokens(frames):
    return np.concatenate([np.asarray(f.tensors[0]) for f in frames if f.tensors], axis=1)


@pytest.mark.parametrize("ct", CTS)
def test_concurrent_streams_equal_oracle(ct):
    n = 12
    srv, port = gen_server(1828 if ct == "tcp" else 1829, slots=3, n=n, ct=ct)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, VOCAB, (1, 4 + i)).astype(np.int32) for i in range(3)]
    results = {}

    def one(i):
        results[i] = run_client(port, [prompts[i]], ct, "stream=true timeout=60", timeout=60)[0]

    try:
        ts = [threading.Thread(target=one, args=(i,), name=f"gencli{i}") for i in range(3)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=90)
        gh = srv.health()["gen"]
    finally:
        srv.stop()
    for i, p in enumerate(prompts):
        frames = results[i]
        np.testing.assert_array_equal(tokens(frames), oracle(p, n))
        assert [f.meta["final"] for f in frames] == [False] * (len(frames) - 1) + [True]
        assert [f.tensors[0].shape[1] for f in frames] == [3, 3, 3, 3]  # chunk=3
    assert (gh["gen_joins"], gh["gen_completed"], gh["gen_occupied"]) == (3, 3, 0)


def test_stream_single_answer_graph_and_wire_batch_refused():
    srv, port = server(1830, fw="framework=scaler custom=factor:3")
    try:
        frames, _ = run_client(port, [np.float32([i]) for i in range(4)], extra="stream=true")
        assert vals(frames) == [0.0, 3.0, 6.0, 9.0]
    finally:
        srv.stop()
    bad = parse_pipeline("appsrc ! tensor_query_client port=5 stream=true wire-batch=2 ! "
                         "tensor_sink")
    with pytest.raises(ElementError, match="wire-batch must be 1"):
        bad.start()
    bad.stop()


def test_dead_client_frees_its_slot_and_budget_ends_in_typed_expiry():
    n = 4000  # about 8 s of decode: longer than the kill and the budget
    srv, port = gen_server(1831, slots=2, n=n, step_ms=2.0)
    rng = np.random.default_rng(4)
    p_kill = rng.integers(0, VOCAB, (1, 6)).astype(np.int32)
    p_evict = rng.integers(0, VOCAB, (1, 7)).astype(np.int32)
    try:
        victim = client(port, extra="stream=true timeout=60", name="victim")
        victim["src"].push(p_kill)
        deadline = time.monotonic() + 30
        while len(victim["out"].frames) < 2 and time.monotonic() < deadline:
            time.sleep(0.005)
        got = list(victim["out"].frames)
        assert len(got) >= 2
        cancelled0 = srv.health()["gen"]["gen_cancelled"]
        t0 = time.monotonic()
        victim.stop()  # mid-decode: the client vanishes (its stream ends at once)
        while srv.health()["gen"]["gen_cancelled"] == cancelled0 and time.monotonic() - t0 < 5:
            time.sleep(0.01)
        freed_s = time.monotonic() - t0
        gh = srv.health()["gen"]
        assert gh["gen_cancelled"] == cancelled0 + 1 and freed_s < 1.0
        np.testing.assert_array_equal(tokens(got), oracle(p_kill, tokens(got).shape[1]))
        frames, h = run_client(port, [p_evict], extra="stream=true timeout=0.5 retries=0",
                               timeout=30)
        assert frames, "the expiry must answer the stream"
        last = frames[-1].meta
        assert last["final"] is True and last["deadline_expired"] is True
        assert last["evicted"] == "deadline"
        n_tok = sum(f.tensors[0].shape[1] for f in frames if f.tensors)
        assert 0 < n_tok < n and n_tok == last["tokens_done"]
        np.testing.assert_array_equal(tokens(frames), oracle(p_evict, n_tok))
        assert h["deadline_expired"] >= 1
        deadline = time.monotonic() + 10
        while srv.health()["gen"]["gen_occupied"] and time.monotonic() < deadline:
            time.sleep(0.02)
        gh = srv.health()["gen"]
        assert (gh["gen_occupied"], gh["gen_evicted"], gh["gen_cancelled"]) == (0, 1, 1)
    finally:
        srv.stop()

"""Port parity for ``core/telemetry.py`` and the pipeline's telemetry layer.

The registry and its Prometheus text, driven by one script through the
port and the JAX package (``tests/test_telemetry.py`` ``TestRegistry``
and ``TestExposition``); the ``/metrics`` endpoint over loopback and
``NNS_METRICS_PORT``; the catalog against the JAX package's; the
supervision truth-table pipeline (``error-policy=skip`` poison, as in
``TestFusedParity``) fused and unfused in both packages, whose series
names, labels and counter values (timing series aside) must be equal; the
flight recorder on an injected hang in both packages; and ``SloTracker``
fed the same sequences.  Pipelines wait at most a few seconds each.
"""

import json
import re
import socket
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from nnstreamer_tpu.core import resilience as jres
from nnstreamer_tpu.core import telemetry as jt
from nnstreamer_tpu.pipeline import parse_pipeline as jax_parse
from nnstreamer_tpu_torch.core import buffer as tbuf
from nnstreamer_tpu_torch.core import resilience as tres
from nnstreamer_tpu_torch.core import telemetry as tt
from nnstreamer_tpu_torch.pipeline import parse_pipeline as torch_parse

torch.set_num_threads(2)

PKGS = {"port": (tt, tres, torch_parse), "jax": (jt, jres, jax_parse)}


@pytest.fixture(autouse=True)
def _clean_faults():
    yield
    tres.FAULTS.reset()
    jres.FAULTS.reset()


# ---------------------------------------------------------------------------
# Registry and exposition, one script through both packages
# ---------------------------------------------------------------------------
def _registry_script(mod) -> str:
    reg = mod.MetricsRegistry()
    c = reg.counter("nns.filter.invokes", {"pipeline": "t", "element": "f"})
    c.inc()
    c.inc(2)
    assert c.value == 3
    reg.gauge("nns.feed.window_occupancy", {"pipeline": "t"}).set(4)
    g = reg.gauge("nns.gen.occupied", {"pipeline": "t"})
    g.set_fn(lambda: 2.5)
    h = reg.histogram("nns.slo.ttft_seconds", {"pipeline": "t"})
    h.observe(0.004)
    h.observe(0.2)
    assert h.count == 2 and abs(h.sum - 0.204) < 1e-9
    reg.gauge("nns.health.some_key", {"pipeline": "t"}).set(1)
    reg.register_collector(lambda: [mod.Sample("nns.pipeline.delivered", {"pipeline": "t"},
                                               7, "counter")])
    return reg.render_prometheus()


def test_rendered_text_equal_to_jax():
    text = _registry_script(tt)
    assert text == _registry_script(jt)
    assert "# TYPE nns_filter_invokes counter" in text
    assert 'nns_filter_invokes{element="f",pipeline="t"} 3' in text
    assert 'nns_feed_window_occupancy{pipeline="t"} 4' in text
    assert 'nns_gen_occupied{pipeline="t"} 2.5' in text
    assert "# TYPE nns_slo_ttft_seconds histogram" in text
    assert re.search(r'nns_slo_ttft_seconds_bucket\{le="\+Inf",pipeline="t"\} 2', text)
    assert 'nns_pipeline_delivered{pipeline="t"} 7' in text


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_registry_contracts(pkg):
    mod = PKGS[pkg][0]
    reg = mod.MetricsRegistry()
    with pytest.raises(ValueError, match="catalog"):
        reg.counter("nns.made.up_name")
    a = reg.counter("nns.filter.swaps", {"element": "q"})
    assert reg.counter("nns.filter.swaps", {"element": "q"}) is a
    with pytest.raises(ValueError, match="already registered"):
        reg.gauge("nns.filter.swaps", {"element": "q"})
    reg.counter("nns.filter.invokes", {"pipeline": "p1", "element": "q"})
    reg.counter("nns.filter.invokes", {"pipeline": "p2", "element": "q"})
    assert reg.remove_labeled(pipeline="p1") == 1
    labels = {tuple(sorted(s.labels.items())) for s in reg.collect()}
    assert (("element", "q"), ("pipeline", "p2")) in labels
    assert all(("pipeline", "p1") not in lb for lb in labels)

    def bad():
        raise RuntimeError("collector bug")

    reg.register_collector(bad)
    assert len(reg.collect()) == 2  # the scrape survives the collector
    reg.unregister_collector(bad)


def test_catalog_is_the_jax_catalog():
    for name, entry in tt.METRICS.items():
        assert jt.METRICS.get(name) == entry, name
    for key, name in tt.HEALTH_KEY_METRICS.items():
        assert jt.HEALTH_KEY_METRICS[key] == name, key
        assert name in tt.METRICS
    assert tt.STATE_CODES == jt.STATE_CODES
    assert tt.SWAP_STATE_CODES == jt.SWAP_STATE_CODES
    assert tt.HIST_QUANTILE_GAUGES == jt.HIST_QUANTILE_GAUGES
    assert (tt.LOG2_E_MIN, tt.LOG2_NBUCKETS) == (jt.LOG2_E_MIN, jt.LOG2_NBUCKETS)
    for key in ("TL_PREFIX", "TRACE_ID_META", "TL_RX_META", "TL_INVOKE_META", "TL_ENQ_META",
                "TL_QPUT_META", "SPAN_META", "SRV_SPAN_META"):
        assert getattr(tt, key) == getattr(jt, key)
    # the port has no frame pool, hence no nns.pool.frame_* series
    assert not [n for n in tt.METRICS if n.startswith("nns.pool.frame_")]
    assert tt.new_trace_id() != tt.new_trace_id()


def _prom(text: str) -> dict:
    """Exposition text as {name{labels}: value}; raises on a malformed line."""
    out = {}
    line_re = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})? "
                         r"([-+]?[0-9.eE+-]+|NaN|[+-]Inf)$")
    for line in text.strip().splitlines():
        if not line or line.startswith("#"):
            continue
        m = line_re.match(line)
        assert m, f"unparseable exposition line: {line!r}"
        out[m.group(1) + (m.group(2) or "")] = float(m.group(3))
    return out


def _scrape(port: int) -> str:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=5) as r:
        assert r.headers["Content-Type"].startswith("text/plain")
        return r.read().decode()


def test_metrics_endpoint_over_loopback_and_clean_shutdown():
    pipe = torch_parse("appsrc name=src ! tensor_filter name=f framework=scaler "
                       "custom=factor:2 max-batch=4 ! tensor_sink name=out", name="metsrv")
    pipe.enable_tracing()
    port = pipe.serve_metrics(0)
    assert pipe.metrics_port == port and pipe.serve_metrics(0) == port
    pipe.start()
    opened = tt.live_server_count()
    try:
        mid = None
        for i in range(40):
            pipe["src"].push(np.float32([i]))
            if i == 20:
                mid = _prom(_scrape(port))
        pipe["src"].end_of_stream()
        pipe.wait(timeout=20)
        end = _prom(_scrape(port))
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"http://127.0.0.1:{port}/nothing", timeout=5)
    finally:
        pipe.stop()
    for series in ("nns_filter_invokes", "nns_feed_window_occupancy", "nns_lifecycle_state",
                   "nns_element_frames", "nns_pool_device_allocated"):
        assert any(k.startswith(series) for k in mid), series
    assert end['nns_element_frames{element="out",pipeline="metsrv"}'] == 40
    assert end['nns_filter_invoked_frames{element="f",pipeline="metsrv"}'] == 40
    assert end['nns_pipeline_delivered{pipeline="metsrv"}'] == 40
    assert not any(k.startswith("nns_pool_frame") for k in end)
    assert tt.live_server_count() == opened - 1 and pipe.metrics_port is None
    with pytest.raises((urllib.error.URLError, ConnectionError, OSError)):
        urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=2)


def test_nns_metrics_port_env(monkeypatch):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        free = s.getsockname()[1]
    monkeypatch.setenv("NNS_METRICS_PORT", str(free))
    a = torch_parse("appsrc name=src ! tensor_sink name=out", name="envport")
    b = torch_parse("appsrc name=src ! tensor_sink name=out", name="envport")
    a.start()
    b.start()  # the port is taken: b's series are served by a's endpoint
    try:
        assert a.metrics_port == free and b.metrics_port is None
        assert a.telemetry_label == "envport" and b.telemetry_label == "envport#2"
        for p in (a, b):
            p["src"].push(np.float32([1.0]))
            p["src"].end_of_stream()
            p.wait(timeout=10)
        got = _prom(_scrape(free))
        assert got['nns_pipeline_delivered{pipeline="envport"}'] == 1
        assert got['nns_pipeline_delivered{pipeline="envport#2"}'] == 1
    finally:
        b.stop()
        a.stop()
    assert a.metrics_port is None
    c = torch_parse("appsrc name=src ! tensor_sink name=out", name="envport")
    assert c.telemetry_label == "envport"  # labels released, nothing claimed
    c.stop()


def test_snapshot_without_tracer():
    pipe = torch_parse("appsrc name=src ! identity ! tensor_sink name=out", name="snapbasic")
    pipe.start()
    try:
        for i in range(7):
            pipe["src"].push(np.float32([i]))
        pipe["src"].end_of_stream()
        pipe.wait(timeout=15)
        snap = pipe.metrics_snapshot()
        assert snap.get("nns.pipeline.delivered") == 7
        assert snap.get("nns.sink.rendered", element="out") == 7
        assert snap.get("nns.source.pending", element="src") == 0
        assert snap.get("nns.element.frames", element="out") is None  # no tracer
        assert snap.get("nns.element.dead_letters", element="out") == 0
        assert pipe.telemetry_summary()["nns.pipeline.delivered"] == 7
    finally:
        pipe.stop()


def test_staging_pool_series_are_process_totals():
    before = tbuf.staging_pool_totals()
    pool = tbuf.DeviceBufferPool()
    buf = pool.acquire((4, 3), np.uint8)
    pool.release(buf)
    pool.acquire((4, 3), np.uint8)
    del pool, buf
    after = tbuf.staging_pool_totals()  # the pool is gone, its counts stay
    assert after["allocated"] == before["allocated"] + 1
    assert after["reused"] == before["reused"] + 1


# ---------------------------------------------------------------------------
# The supervision truth-table pipeline in both packages
# ---------------------------------------------------------------------------
N = 24
TIMING = ("_bucket", "_sum")


def _parity_run(pkg: str, fuse: bool, text: str):
    mod, res, parse = PKGS[pkg]
    pipe = parse(text, name="parity", fuse=fuse)
    tracer = pipe.enable_tracing()
    res.FAULTS.arm("element.a.handle_frame", exc=ValueError("poison"), every=4)
    pipe.start()
    try:
        for i in range(N):
            pipe["src"].push(np.float32([i]))
        pipe["src"].end_of_stream()
        pipe.wait(timeout=20)
        snap = pipe.metrics_snapshot()
        report = {k: (r["frames"], r["calls"]) for k, r in tracer.report().items()}
    finally:
        res.FAULTS.reset()
        pipe.stop()
    series = {(s.name, tuple(sorted((k, v) for k, v in s.labels.items() if k != "le")))
              for s in snap.samples if not s.name.startswith("nns.pool.")}
    counters = {k: v for k, v in snap.counters().items()
                if not k[0].startswith("nns.pool.") and not k[0].endswith(TIMING)
                and not k[0].startswith("nns.element.queue_wait_seconds")}
    return series, counters, report


PARITY_TEXTS = {
    "identity": ("appsrc name=src ! identity name=a error-policy=skip ! identity name=b ! "
                 "tensor_sink name=out"),
    "filter": ("appsrc name=src ! identity name=a error-policy=skip ! tensor_filter name=f "
               "framework=scaler custom=factor:3 ! tensor_sink name=out"),
}


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("graph", sorted(PARITY_TEXTS))
def test_series_and_counters_equal_to_jax(graph, fuse):
    got = _parity_run("port", fuse, PARITY_TEXTS[graph])
    want = _parity_run("jax", fuse, PARITY_TEXTS[graph])
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2] == want[2]
    assert got[1][("nns.pipeline.delivered", (("pipeline", "parity"),))] == N - 6
    assert got[1][("nns.element.dead_letters", (("element", "a"), ("pipeline", "parity")))] == 6


def test_fused_and_unfused_counters_equal():
    for graph in PARITY_TEXTS.values():
        assert _parity_run("port", True, graph)[1] == _parity_run("port", False, graph)[1]


# ---------------------------------------------------------------------------
# Flight recorder
# ---------------------------------------------------------------------------
def _stall_dump(pkg: str, tmp_path):
    mod, res, parse = PKGS[pkg]
    pipe = parse("appsrc name=src ! identity name=work stall-timeout=0.3 "
                 "stall-policy=restart ! tensor_sink name=out", name="frstall")
    pipe.enable_flight_recorder(dump_dir=str(tmp_path), profile_duration_s=0.1)
    bus = []
    pipe.add_bus_watcher(bus.append)
    res.FAULTS.arm("element.work.handle_frame", hang=True, after=2, times=1)
    pipe.start()
    try:
        for i in range(4):
            pipe["src"].push(np.float32([i]))
        deadline = time.time() + 10
        files = []
        while not files and time.time() < deadline:
            files = list(tmp_path.glob("nns_flight_*.json"))
            time.sleep(0.02)
        assert files, "no flight dump on watchdog stall"
        res.FAULTS.reset()
        pipe["src"].end_of_stream()
        pipe.wait(timeout=10)
        data = json.loads(files[0].read_text())
        out = [float(f.tensors[0][0]) for f in pipe["out"].frames]
        restarts = pipe.health()["work"]["restarts"]
        stalls = pipe.metrics_snapshot().get("nns.element.stalls", element="work")
    finally:
        res.FAULTS.reset()
        pipe.stop()
    posted = [m.data["flight_dump"] for m in bus
              if isinstance(m.data, dict) and "flight_dump" in m.data]
    return data, out, restarts, stalls, posted, files


def test_flight_recorder_stall_dump_like_jax(tmp_path):
    got = _stall_dump("port", tmp_path / "port")
    want = _stall_dump("jax", tmp_path / "jax")
    data, out, restarts, stalls, posted, files = got
    assert set(data) == set(want[0])
    assert (data["reason"], data["source"]) == (want[0]["reason"], want[0]["source"])
    assert data["reason"].startswith("watchdog_") and data["source"] == "work"
    stuck = [(t["trace_id"], s) for t in data["traces"] for s in t["spans"] if s.get("open")]
    jstuck = [s for t in want[0]["traces"] for s in t["spans"] if s.get("open")]
    assert [s["element"] for _, s in stuck] == [s["element"] for s in jstuck] == ["work"]
    assert set(stuck[0][1]) == set(jstuck[0]) and stuck[0][0]
    assert stuck[0][1]["stuck_for_ms"] >= 250.0
    done = [sp for t in data["traces"] for sp in t["spans"]
            if not sp.get("open") and sp["element"] == "work"]
    assert len(done) >= 2
    assert out == want[1] == [0.0, 1.0, 2.0, 3.0]
    assert restarts == want[2] == 1 and stalls >= 1
    assert posted == [str(files[0])]  # the dump's path, posted on the bus
    # the fused segment's thread is named after its head, src; its stack
    # is parked in the hung call
    stacks = data["thread_profile"]["threads"]["src"]["top_stacks"]
    assert any("pipeline.py:_supervised" in s["stack"] for s in stacks)


def test_dead_letters_dump_rate_limited(tmp_path):
    pipe = torch_parse("appsrc name=src ! identity name=work error-policy=skip ! "
                       "tensor_sink name=out", name="frskip")
    rec = pipe.enable_flight_recorder(dump_dir=str(tmp_path), min_dump_interval_s=60.0,
                                      profile_incidents=False)
    assert pipe.flight_recorder is rec and pipe.tracer.recorder is rec
    before = tt.REGISTRY.counter("nns.flight.dumps").value
    tres.FAULTS.arm("element.work.handle_frame", exc=ValueError("poison"), every=2)
    pipe.start()
    try:
        for i in range(8):
            pipe["src"].push(np.float32([i]))
        pipe["src"].end_of_stream()
        pipe.wait(timeout=15)
        assert len(list(tmp_path.glob("nns_flight_*.json"))) == 1
        assert rec.dumps == 1 and rec.suppressed >= 3
        assert pipe.health()["work"]["dead_letters"] == 4
        assert tt.REGISTRY.counter("nns.flight.dumps").value == before + 1
    finally:
        tres.FAULTS.reset()
        pipe.stop()


def test_breaker_trip_routed_into_incident_dumps(tmp_path):
    """A breaker's ``on_trip`` hook routed into ``Pipeline.incident`` (its
    owner's wiring in the JAX package) leaves a dump naming the breaker."""
    pipe = torch_parse("appsrc name=src ! tensor_sink name=out", name="brk")
    pipe.enable_flight_recorder(dump_dir=str(tmp_path), min_dump_interval_s=0.0,
                                profile_incidents=False)
    paths = []
    br = tres.CircuitBreaker(failure_threshold=2, name="remote-a",
                             on_trip=lambda b: paths.append(
                                 pipe.incident("breaker_trip", "q", b.name)))
    for _ in range(2):
        br.record_failure()
    data = json.loads(open(paths[0]).read())
    assert (data["reason"], data["source"], data["detail"]) == ("breaker_trip", "q", "'remote-a'")


def test_incident_without_recorder_is_a_no_op():
    pipe = torch_parse("appsrc name=src ! tensor_sink name=out")
    assert pipe.incident("unit", "src", "detail") is None


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_recorder_units(pkg, tmp_path):
    mod = PKGS[pkg][0]

    class F:
        def __init__(self, tid):
            self.meta = {"_nns_trace_id": tid}

    rec = mod.FlightRecorder(capacity=16, dump_dir=str(tmp_path), min_dump_interval_s=0.0,
                             profile_incidents=False)
    rec.begin("a", F("t1"))
    rec.end("a", F("t1"), 1.0, 2.0, 1)
    rec.begin("b", F("t1"))  # never ends: open span
    tl = rec.timelines()
    assert [s["element"] for s in tl["t1"]] == ["a", "b"]
    assert tl["t1"][1]["open"] is True
    path = rec.dump("unit", "test", detail=ValueError("x"))
    data = json.load(open(path))
    assert data["traces"] and data["detail"] == "ValueError('x')"


def test_dump_reprs_a_tensor_detail_without_touching_it(tmp_path):
    """A card tensor in the detail is repr'd: a meta tensor (no storage,
    .cpu() and .numpy() raise) stands in for one."""
    rec = tt.FlightRecorder(dump_dir=str(tmp_path), min_dump_interval_s=0.0,
                            profile_incidents=False)
    t = torch.empty((2, 3), device="meta")
    with pytest.raises(Exception):
        t.cpu()
    data = json.load(open(rec.dump("unit", "test", detail={"t": t})))
    assert "meta" in data["detail"]


# ---------------------------------------------------------------------------
# SLO accounting
# ---------------------------------------------------------------------------
SLO_SCRIPTS = {
    "met": [("ttft", "", 0.01), ("tokens", "", 0.04, 8), ("stream", "", "good")],
    "burned": [("ttft", "a", 0.5), ("ttft", "a", 0.01), ("tokens", "a", 1.0, 4),
               ("tokens", "a", 0.02, 16), ("stream", "a", "good"),
               ("stream", "a", "expired"), ("stream", "b", "evicted"),
               ("stream", "b", "shed"), ("stream", "b", "error")],
    "warn": [*[("ttft", "t", 0.01)] * 30, ("ttft", "t", 0.3), ("ttft", "t", 0.3),
             *[("stream", "t", "good")] * 997, ("stream", "t", "expired"),
             ("stream", "t", "expired")],
    "empty": [],
}


@pytest.mark.parametrize("objectives", [(0.05, 0.01, 0.999), (0.0, 0.02, 0.0), (0.0, 0.0, 0.0)])
@pytest.mark.parametrize("script", sorted(SLO_SCRIPTS))
def test_slo_tracker_equal_to_jax(script, objectives):
    def run(mod):
        tr = mod.SloTracker(*objectives)
        for op, tenant, *args in SLO_SCRIPTS[script]:
            {"ttft": tr.note_ttft, "tokens": tr.note_tokens,
             "stream": tr.note_stream}[op](tenant, *args)
        return (tr.armed, tr.snapshot(),
                [(n, h.state(), lb) for n, h, lb in tr.hist_rows()])

    assert run(tt) == run(jt)


@pytest.mark.parametrize("burn", [None, 0.0, 1.0, 1.5, 2.0, 7.0])
def test_slo_status_truth_table(burn):
    assert tt.slo_status(burn) == jt.slo_status(burn)


def test_slo_availability_of_one_refused():
    for mod in (tt, jt):
        with pytest.raises(ValueError, match="zero error budget"):
            mod.SloTracker(availability=1.0)

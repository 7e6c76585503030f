"""Port parity for ``core/profiler.py``.

The refcounted ``torch.profiler`` session against a scripted stand-in, as
the JAX package's ``TestJaxTraceSession`` drives a fake ``jax.profiler``
(a failed start leaves the state reset; a session someone else holds is
never stopped; joins and the last stop refcount exactly, the last stop
writing the Chrome trace); the real session on the CPU; the filter's
``trace`` property through the health collector; and the incident-time
thread sampler over named threads.
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

from nnstreamer_tpu.core import profiler as jprof
from nnstreamer_tpu_torch.core import profiler
from nnstreamer_tpu_torch.pipeline import parse_pipeline as torch_parse

torch.set_num_threads(2)


class _FakeSession:
    """Scripted stand-in for one ``torch.profiler.profile``."""

    def __init__(self, log, fail_start=None):
        self.log = log
        self.fail_start = fail_start

    def start(self):
        if self.fail_start is not None:
            raise RuntimeError(self.fail_start)
        self.log.append("start")

    def stop(self):
        self.log.append("stop")

    def export_chrome_trace(self, path):
        self.log.append(("export", path))
        with open(path, "w") as f:
            json.dump({"traceEvents": []}, f)


@pytest.fixture
def fake(monkeypatch):
    """The module's session factory replaced by scripted sessions; the
    module's global state restored afterwards."""
    refs, d, sess = profiler._refs, profiler._dir, profiler._session
    profiler._refs, profiler._dir, profiler._session = 0, None, None
    log, fails = [], []

    def new_session():
        return _FakeSession(log, fails.pop(0) if fails else None)

    monkeypatch.setattr(profiler, "_new_session", new_session)
    monkeypatch.setattr(profiler, "_profiler_enabled", lambda: False)
    yield log, fails
    profiler._refs, profiler._dir, profiler._session = refs, d, sess


def test_failed_start_leaves_state_fully_reset(fake, tmp_path):
    log, fails = fake
    fails.append("injected start failure")
    assert profiler.trace_start(str(tmp_path / "t1")) is False
    assert profiler._refs == 0 and profiler._dir is None and profiler._session is None
    assert log == ["stop"]  # the half-armed session was reset
    assert profiler.trace_active() is False
    t2 = str(tmp_path / "t2")
    assert profiler.trace_start(t2) is True
    assert profiler._refs == 1 and profiler._dir == t2 and profiler.trace_active()
    assert profiler.trace_start(t2) is True  # a join
    assert profiler._refs == 2 and log == ["stop", "start"]
    assert profiler.trace_stop() is None
    assert profiler._refs == 1 and log == ["stop", "start"]
    path = profiler.trace_stop()
    assert profiler._refs == 0 and profiler._dir is None and not profiler.trace_active()
    assert log[2:] == ["stop", ("export", path)] and path.startswith(t2)
    assert profiler.trace_stop() is None  # nothing held: a no-op


def test_foreign_active_session_is_not_reset(fake, monkeypatch, tmp_path):
    log, fails = fake
    fails.append("profiler session already active")
    assert profiler.trace_start(str(tmp_path)) is False
    assert log == [] and profiler._refs == 0  # their session survives
    monkeypatch.setattr(profiler, "_profiler_enabled", lambda: True)
    assert profiler.trace_start(str(tmp_path)) is False
    assert log == [] and profiler._session is None


def test_same_refcount_script_as_jax(fake, monkeypatch, tmp_path):
    """One script of starts and stops through the port (stand-in session)
    and the JAX package (stand-in jax.profiler): the same answers, the
    same reference counts."""
    import jax

    class FakeJax:
        def start_trace(self, d):
            pass

        def stop_trace(self):
            pass

    monkeypatch.setattr(jax, "profiler", FakeJax())
    jrefs, jdir = jprof._refs, jprof._dir
    jprof._refs, jprof._dir = 0, None
    try:
        script = ["a", "a", "b", "stop", "stop", "stop", "stop", "b"]

        def run(mod):
            got = []
            for op in script:
                if op == "stop":
                    mod.trace_stop()
                    got.append(("stop", mod._refs))
                else:
                    got.append((mod.trace_start(str(tmp_path / op)), mod._refs))
            mod.trace_stop()
            return got

        assert run(profiler) == run(jprof)
    finally:
        jprof._refs, jprof._dir = jrefs, jdir


def test_real_session_on_the_cpu_writes_a_chrome_trace(tmp_path):
    assert profiler.trace_start(str(tmp_path)) is True
    try:
        assert profiler.trace_active()
        with profiler.annotate("nns_probe"):
            (torch.ones(64) * 2).sum()
    finally:
        path = profiler.trace_stop()
    assert not profiler.trace_active()
    events = json.loads(open(path).read())["traceEvents"]
    assert any(e.get("name") == "nns_probe" for e in events)


def test_profiler_active_gauge_via_health_collector(fake, tmp_path):
    log, _ = fake
    pipe = torch_parse("appsrc name=src ! tensor_filter name=f framework=scaler custom=factor:2 "
                       f"trace=1 trace-dir={tmp_path} ! tensor_sink name=out", name="profgauge")
    pipe.start()
    try:
        assert pipe.health()["f"]["profiler_active"] == 1
        snap = pipe.metrics_snapshot()
        samples = [s for s in snap.samples if s.name == "nns.profiler.active"
                   and s.labels.get("element") == "f"]
        assert [s.value for s in samples] == [1.0]  # one export path, one series
        pipe["src"].push(np.float32([1.0]))
        pipe["src"].end_of_stream()
        pipe.wait(timeout=10)
    finally:
        pipe.stop()
    assert profiler._refs == 0 and log[0] == "start" and log[-1][0] == "export"
    assert pipe.health()["f"]["profiler_active"] == 0


def test_filter_trace_defaults_equal_to_jax():
    from nnstreamer_tpu.elements.filter import TensorFilter as JFilter
    from nnstreamer_tpu_torch.elements.filter import TensorFilter

    for key in ("trace", "trace-dir"):
        assert TensorFilter.PROPERTIES[key].default == JFilter.PROPERTIES[key].default


def test_profile_threads_samples_named_threads():
    stop = threading.Event()

    def nns_parked_here():
        stop.wait(5.0)

    named = threading.Thread(target=nns_parked_here, name="unit-reaper", daemon=True)
    anon = threading.Thread(target=nns_parked_here, daemon=True)  # "Thread-N": ignored
    named.start()
    anon.start()
    try:
        time.sleep(0.02)
        prof = profiler.profile_threads(duration_s=0.1, hz=50)
        only = profiler.profile_threads(duration_s=0.02, hz=50, include=("-reaper",))
    finally:
        stop.set()
        named.join()
        anon.join()
    assert set(prof) == {"duration_s", "hz", "samples", "threads"}
    row = prof["threads"]["unit-reaper"]
    assert row["samples"] == prof["samples"] >= 1
    assert "test_torch_profiler.py:nns_parked_here" in row["top_stacks"][0]["stack"]
    assert not [n for n in prof["threads"] if n.startswith("Thread-")]
    assert set(only["threads"]) == {"unit-reaper"}
    assert profiler.THREAD_IGNORE == jprof.THREAD_IGNORE

"""Port parity for ``core/liveness.py`` and the scheduler's liveness layer.

The deadline truth table, the ``Watchdog`` on a fake clock, both
admission controllers and ``parse_tenant_quotas``, the memory watermark
monitor on fake samples, each driven by one script through the port and
the JAX package; the scheduler's deadline drops and ``tensor_rate``
shedding through ``_qos_feedback`` (equal drop counts to JAX); and a hung
element restarted under ``stall-policy=restart``.  Time runs on fake
clocks except in the pipeline runs, which wait at most a fraction of a
second.
"""

import time

import numpy as np
import pytest
import torch

from nnstreamer_tpu.core import liveness as jl
from nnstreamer_tpu.core import resilience as jres
from nnstreamer_tpu.core.buffer import TensorFrame as JFrame
from nnstreamer_tpu.pipeline import parse_pipeline as jax_parse
from nnstreamer_tpu_torch.core import liveness as tl
from nnstreamer_tpu_torch.core import resilience as tres
from nnstreamer_tpu_torch.core.buffer import TensorFrame as TFrame
from nnstreamer_tpu_torch.pipeline import parse_pipeline as torch_parse

torch.set_num_threads(2)

@pytest.fixture(autouse=True)
def _clean_faults():
    yield
    tres.FAULTS.reset()
    jres.FAULTS.reset()


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


# ---------------------------------------------------------------------------
# deadline truth table
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("budget,anchor,pts,now", [
    (0.5, None, None, 100.0), (0.5, None, None, 100.4), (0.5, None, None, 100.5),
    (1.0, None, None, 100.999999), (1.0, None, None, 101.5), (0.5, 90.0, 2.0, 92.4),
    (0.5, 90.0, 2.0, 92.5), (0.5, 90.0, None, 100.3), (-0.1, None, None, 100.0),
])
def test_deadline_truth_table_equal_to_jax(budget, anchor, pts, now):
    def row(mod, frame):
        clk = FakeClock(100.0)
        f = mod.stamp_deadline(frame([np.float32([0])], pts=pts), budget, clock=clk,
                               anchor=anchor)
        clk.t = now
        return (f.meta[mod.DEADLINE_META], mod.deadline_remaining(f, clock=clk),
                mod.is_expired(f, clock=clk), mod.is_expired(f, now=now))

    assert row(tl, TFrame) == row(jl, JFrame)


def test_no_deadline_never_expires():
    f = TFrame([np.float32([0])])
    assert tl.deadline_remaining(f) is None and not tl.is_expired(f, now=1e12)
    assert tl.deadline_remaining(object()) is None  # meta-less payloads


# ---------------------------------------------------------------------------
# Watchdog on a fake clock
# ---------------------------------------------------------------------------
WATCH_SCRIPT = [
    ("begin", "a"), ("tick", 0.05), ("check",), ("tick", 0.1), ("check",), ("check",),
    ("done", "a"), ("tick", 0.3), ("check",), ("queue", "b", 2), ("tick", 0.3), ("check",),
    ("tick", 0.1), ("check",), ("tick", 0.25), ("check",), ("begin", "b"), ("tick", 0.6),
    ("check",), ("done", "b"), ("queue", "b", 0), ("tick", 1.0), ("check",), ("begin", "c"),
    ("tick", 0.45), ("check",), ("tick", 0.1), ("check",), ("snap",),
]


def test_watchdog_script_equal_to_jax():
    """Overruns once per episode, stalls needing pending work, an in-call
    hang caught by stall-timeout alone, overrun winning the tie: the same
    findings, fired events and snapshots step for step."""
    def run(mod):
        clk = FakeClock(0.0)
        wd = mod.Watchdog(clock=clk)
        depth = {"a": 0, "b": 0, "c": 0}
        fired = []
        watches = {
            "a": wd.register("a", frame_deadline=0.1, policy="warn",
                             qsize=lambda: depth["a"],
                             on_event=lambda w, k, e: fired.append((w.name, k, round(e, 6)))),
            "b": wd.register("b", stall_timeout=0.5, policy="restart",
                             qsize=lambda: depth["b"]),
            "c": wd.register("c", stall_timeout=0.5, frame_deadline=0.4, policy="fail",
                             qsize=lambda: depth["c"]),
        }
        out = [wd.min_interval()]
        for step in WATCH_SCRIPT:
            if step[0] == "tick":
                clk.t += step[1]
            elif step[0] == "begin":
                wd.begin(watches[step[1]])
            elif step[0] == "done":
                wd.done(watches[step[1]])
            elif step[0] == "queue":
                depth[step[1]] = step[2]
            elif step[0] == "check":
                out.append([(n, k, round(e, 6)) for n, k, e in wd.check()])
            else:
                out.append(wd.snapshot())
        return out, fired

    got, want = run(tl), run(jl)
    assert got == want
    assert any(f for f in got[0][1:] if isinstance(f, list) and f)


def test_watchdog_policy_validated():
    with pytest.raises(ValueError):
        tl.Watchdog().register("x", stall_timeout=1.0, policy="ignore")


def test_thread_beat_edge_and_census():
    clk = FakeClock(0.0)
    beat = tl.ThreadBeat("pump", stall_after_s=1.0, clock=clk)
    clk.t = 2.0
    assert beat.check_stall(busy=True) and not beat.check_stall(busy=True)
    beat.beat()
    assert not beat.check_stall(busy=True)
    assert tl.thread_census(beat, None)["pump"]["stalls"] == 1


# ---------------------------------------------------------------------------
# admission control
# ---------------------------------------------------------------------------
ADMIT_SCRIPT = [("admit", 1)] * 5 + [("release", 1), ("admit", 1), ("release", 2),
                                     ("admit", 1), ("release", 1), ("admit", 2), ("admit", 1)]


@pytest.mark.parametrize("high,low", [(4, None), (4, 0), (1, None), (0, None), (6, 2)])
def test_admission_controller_equal_to_jax(high, low):
    def run(mod):
        ac = mod.AdmissionController(high, low)
        out = []
        for op, n in ADMIT_SCRIPT:
            if op == "admit":
                out.append(ac.try_admit(n))
            else:
                ac.release(n)
            out.append(ac.snapshot())
        return out

    assert run(tl) == run(jl)


@pytest.mark.parametrize("high,low", [(4, 4), (4, -1)])
def test_admission_watermarks_refused_like_jax(high, low):
    for mod in (tl, jl):
        with pytest.raises(ValueError):
            mod.AdmissionController(high, low)


TENANT_SCRIPT = [
    ("admit", "a", 3), ("admit", "a", 3), ("admit", "a", 3), ("admit", "b", 0),
    ("admit", "", 1), ("admit", "b", 2), ("tick", "", 2.0), ("admit", "a", 3),
    ("admit", "a", 3), ("tick", "", 4.0), ("admit", "a", 3), ("pressure", "", True),
    ("admit", "b", 3), ("admit", "", 3), ("pressure", "", False), ("release", "a", 1),
    ("admit", "a", 3), ("release", "b", 1), ("release", "", 1), ("admit", "c", 1),
    ("admit", "c", 0), ("admit", "c", 3), ("admit", "d", 3), ("admit", "d", 2),
    ("admit", "e", 3), ("admit", "f", 3), ("admit", "g", 3), ("admit", "h", 3),
    ("release", "c", 1), ("admit", "h", 3),
]


def test_tenant_admission_equal_to_jax():
    """Quotas, the streak-scaled retry-after, priority ceilings, the global
    watermark, memory shedding and the sustained-shed incident: the same
    verdicts, reasons, paces and snapshots."""
    def run(mod):
        clk = FakeClock(0.0)
        incidents = []
        pressured = {"on": False}
        ac = mod.TenantAdmissionController(
            high=6, low=3, default_quota=2, quotas=mod.parse_tenant_quotas("a:2,b:4", "t"),
            shed_window_s=5.0, on_sustained_shed=incidents.append, clock=clk)
        ac.pressure = lambda: pressured["on"]
        out = []
        for op, tenant, arg in TENANT_SCRIPT:
            if op == "tick":
                clk.t += arg
            elif op == "pressure":
                pressured["on"] = arg
            elif op == "release":
                ac.release(arg, tenant=tenant)
            else:
                try:
                    ac.admit(1, tenant=tenant, priority=arg)
                    out.append("ok")
                except mod.ServerBusyError as e:
                    out.append((e.reason, e.tenant, round(e.retry_after, 6)))
        return out, ac.snapshot(), incidents

    got, want = run(tl), run(jl)
    assert got == want
    assert {"quota", "priority", "load", "memory"} <= {v[0] for v in got[0] if v != "ok"}


@pytest.mark.parametrize("raw", ["a:8,b:4", " a:1 , b:0 ,", "", "a:-1", "a", ":3", "a:x"])
def test_parse_tenant_quotas_equal_to_jax(raw):
    def run(mod):
        try:
            return mod.parse_tenant_quotas(raw, "q")
        except ValueError as e:
            return str(e)

    assert run(tl) == run(jl)


def test_busy_error_is_an_application_reply():
    e = tl.ServerBusyError("busy", retry_after=0.2, tenant="a", reason="quota")
    assert tres.is_remote_application_error(e) and e.retry_after == 0.2
    assert tres.is_transient(tl.StallError("hung"))


# ---------------------------------------------------------------------------
# memory watermarks on fake samples
# ---------------------------------------------------------------------------
def test_memory_monitor_equal_to_jax():
    """Hysteresis, trim on entry, the rate-limited poll, the sustained
    incident: the same snapshots over one sample series."""
    series = [10, 50, 91, 95, 80, 76, 74, 95, 96, 97, 98, 99, 60]

    def run(mod):
        clk = FakeClock(0.0)
        it = iter(series)
        trims, incidents = [], []
        mon = mod.MemoryPressureMonitor(
            high=0.9, low=0.75, sustain_s=0.3, min_poll_s=0.05, incident_interval_s=0.2,
            sample=lambda: (next(it), 100, 7), clock=clk, on_pressure=incidents.append,
            trim_hooks=(lambda: trims.append(1) or 5,))
        out = []
        for i in range(len(series)):
            clk.t = 0.1 * i
            out.append((mon.poll(), mon.poll(), mon.snapshot()))  # the 2nd is rate-limited
        return out, len(trims), len(incidents)

    assert run(tl) == run(jl)


def test_memory_monitor_refuses_bad_watermarks_and_falls_back_to_rss():
    with pytest.raises(ValueError):
        tl.MemoryPressureMonitor(high=0.5, low=0.6)
    mon = tl.MemoryPressureMonitor(high=0.5, low=0.4, host_limit_bytes=1000,
                                   sample=lambda: (0, 0, 600), clock=FakeClock(1.0))
    assert mon.poll() and mon.snapshot()["mem_fraction"] == 0.6


def test_device_memory_sample_never_initialises_cuda():
    in_use, limit, rss = tl.device_memory_sample()
    if not torch.cuda.is_initialized():
        assert (in_use, limit) == (0, 0)
    assert rss > 0


# ---------------------------------------------------------------------------
# the scheduler: deadline drops and tensor_rate shedding through QoS feedback
# ---------------------------------------------------------------------------
def _qos_run(parse, frame_cls, mod, n=10, late=(2, 6)):
    """appsrc ! tensor_rate late-policy=deliver ! tensor_sink (one fused
    streaming thread): frames `late` carry a deadline 1.5 s past; the sink
    drops them and the feedback makes the rate shed the next frame."""
    pipe = parse("appsrc name=src ! tensor_rate name=r late-policy=deliver ! "
                 "tensor_sink name=out")
    pipe.start()
    try:
        for i in range(n):
            f = frame_cls([np.float32([i])], pts=float(i))
            if i in late:
                f.meta[mod.DEADLINE_META] = time.monotonic() - 1.5
            pipe["src"].push(f)
        pipe["src"].end_of_stream()
        pipe.wait(timeout=20)
        h = pipe.health()
    finally:
        pipe.stop()
    r = pipe["r"]
    got = [float(f.tensors[0][0]) for f in pipe["out"].frames]
    return got, h["out"]["deadline_drops"], h["r"]["deadline_drops"], r.qos_dropped, r.dropped


def test_tensor_rate_sheds_through_qos_feedback_like_jax():
    got = _qos_run(torch_parse, TFrame, tl)
    want = _qos_run(jax_parse, JFrame, jl)
    assert got == want
    assert got[0] == [0.0, 1.0, 4.0, 5.0, 8.0, 9.0] and got[1:4] == (2, 0, 2)


def test_scheduler_drops_expired_and_source_stamps_like_jax():
    def run(parse, frame_cls, mod):
        pipe = parse("appsrc name=src ! tensor_sink name=out")
        pipe.start()
        try:
            for v, budget in ((1.0, -0.1), (2.0, 60.0), (3.0, None)):
                f = frame_cls([np.float32([v])])
                if budget is not None:
                    mod.stamp_deadline(f, budget)
                pipe["src"].push(f)
            pipe["src"].end_of_stream()
            pipe.wait(timeout=20)
            drops = pipe.health()["out"]["deadline_drops"]
        finally:
            pipe.stop()
        stamped = parse("appsrc name=src deadline-s=30 ! tensor_sink name=out")
        stamped.start()
        try:
            stamped["src"].push(frame_cls([np.float32([0])]))
            stamped["src"].end_of_stream()
            stamped.wait(timeout=20)
        finally:
            stamped.stop()
        remaining = mod.deadline_remaining(stamped["out"].frames[0])
        return [float(f.tensors[0][0]) for f in pipe["out"].frames], drops, 25 < remaining < 30

    assert run(torch_parse, TFrame, tl) == run(jax_parse, JFrame, jl) == ([2.0, 3.0], 1, True)


# ---------------------------------------------------------------------------
# a hung element under stall-policy=restart
# ---------------------------------------------------------------------------
def _hang_run(parse, mod, policy="restart"):
    pipe = parse("appsrc name=src ! tensor_filter name=f framework=scaler custom=factor:2 "
                 f"stall-timeout=0.1 stall-policy={policy} restart-backoff=0 ! "
                 "tensor_sink name=out")
    mod.FAULTS.arm("element.f.handle_frame", hang=True, times=1, after=2)
    pipe.start()
    err = None
    try:
        for i in range(6):
            pipe["src"].push(np.float32([i]))
        pipe["src"].end_of_stream()
        try:
            pipe.wait(timeout=20)
        except Exception as e:  # noqa: BLE001 — the outcome is compared
            err = type(e).__name__
        h = pipe.health()["f"]
    finally:
        pipe.stop()
    return ([float(f.tensors[0][0]) for f in pipe["out"].frames], h["restarts"],
            h["stalls"] >= 1, err)


def test_hung_element_restarted_zero_loss_like_jax():
    got = _hang_run(torch_parse, tres)
    assert got == _hang_run(jax_parse, jres)
    assert got == ([2.0 * i for i in range(6)], 1, True, None)


def test_stall_policy_fail_tears_down_like_jax():
    got = _hang_run(torch_parse, tres, "fail")
    assert got[3] == "StallError" and got[:2] == _hang_run(jax_parse, jres, "fail")[:2]

"""Port parity for the fleet's control loop: the planner, the leader lease,
the control plane's grading, the performance model, the controller, and
the generator's fenced, zero-loss resize.

* the JAX package's decision truth table (``tests/test_autoscale.py``) as
  one parametrised test: each case's snapshots go through both packages'
  ``plan`` under one fake clock, and the actions and the planning state
  are equal after every tick;
* the lease and plane-assessment cases of ``tests/test_control_plane.py``,
  one parametrised test each: equal held flags, epochs and counters, equal
  levels and reasons;
* ``PerfModel`` predictions within 1e-9 relative, and a ``FleetController``
  over one scripted observatory dispatching the same actions with the
  same epochs and exporting the same ``nns.autoscale.*`` samples;
* ``request_resize`` on a serving generator with zero loss, a rollback on a
  failed build, and a stale epoch refused before any stream is touched.
"""

import dataclasses
import time

import numpy as np
import pytest
import torch

from nnstreamer_tpu.core import autoscale as ja
from nnstreamer_tpu_torch.core import autoscale as ta
from nnstreamer_tpu_torch.core.telemetry import REGISTRY
from nnstreamer_tpu_torch.pipeline import parse_pipeline
from torch_census import module_leak_check  # noqa: F401

torch.set_num_threads(2)

MOD = {"jax": ja, "port": ta}


def _row(topic, addr, occupied=0, slots=4, waiting=0, stale=False, draining=False,
         tokens_per_s=0.0):
    return {"topic": topic, "addr": addr, "occupied": occupied, "slots": slots,
            "waiting": waiting, "stale": stale, "draining": draining,
            "tokens_per_s": tokens_per_s}


def _snap(*rows, headroom=None, burn=None, retired=0):
    if headroom is None:
        headroom = sum(r["slots"] - r["occupied"] for r in rows if not r["stale"])
    return {"servers": list(rows),
            "rollup": {"slot_headroom": headroom, "slo_burn": burn or {}, "retired": retired}}


def _policy_kw(**kw):
    base = dict(min_servers=1, max_servers=4, occupancy_high=0.85, slot_headroom_min=1,
                burn_high=1.0, occupancy_low=0.30, up_streak=2, down_streak=5,
                cooldown_up_s=10.0, cooldown_down_s=30.0, cooldown_resize_s=30.0)
    base.update(kw)
    return base


HOT2 = _snap(_row("a", "h:1", occupied=4), _row("b", "h:2", occupied=4))
CALM3 = _snap(_row("a", "h:1", occupied=1, tokens_per_s=5.0),
              _row("b", "h:2", occupied=0, tokens_per_s=1.0),
              _row("c", "h:3", occupied=0, tokens_per_s=9.0))

#: case -> (policy knobs, [(now, snapshot, inflight to set or None, plane or None)])
PLAN_CASES = {
    "up-hysteresis-and-reset": (dict(up_streak=3), [
        (0.0, HOT2, None, None), (1.0, HOT2, None, None),
        (2.0, _snap(_row("a", "h:1", occupied=2), _row("b", "h:2")), None, None),
        (3.0, HOT2, None, None), (4.0, HOT2, None, None), (5.0, HOT2, None, None)]),
    "up-occupancy": (dict(up_streak=1), [(0.0, _snap(_row("a", "h:1", occupied=4)), None, None)]),
    "up-headroom": (dict(up_streak=1), [
        (0.0, _snap(_row("a", "h:1", occupied=2), headroom=0), None, None)]),
    "up-burn": (dict(up_streak=1), [
        (0.0, _snap(_row("a", "h:1", occupied=1), burn={"A": 1.5}), None, None)]),
    "up-cooldown": (dict(up_streak=1, cooldown_up_s=10.0, max_servers=8), [
        (t, _snap(_row("a", "h:1", occupied=4)), None, None)
        for t in (100.0, 105.0, 109.9, 110.1)]),
    "down-streak-least-loaded": (dict(down_streak=5, cooldown_down_s=0.0), [
        (float(i), CALM3, None, None) for i in range(5)]),
    "down-blocked-by-waiting-and-burn": (dict(down_streak=1), [
        (0.0, _snap(_row("a", "h:1", waiting=1), _row("b", "h:2")), None, None),
        (1.0, _snap(_row("a", "h:1"), _row("b", "h:2"), burn={"A": 1.2}), None, None)]),
    "floor": (dict(min_servers=2, up_streak=5), [(0.0, _snap(_row("a", "h:1")), None, None)]),
    "ceiling": (dict(max_servers=2, cooldown_down_s=5.0), [
        (0.0, _snap(_row("a", "h:1", occupied=2), _row("b", "h:2", occupied=1),
                    _row("c", "h:3", occupied=2)), None, None),
        (0.1, _snap(_row("a", "h:1", occupied=2), _row("b", "h:2", occupied=1),
                    _row("c", "h:3", occupied=2)), {"b": ta.SCALE_DOWN}, None)]),
    "clamp-at-max": (dict(up_streak=1, max_servers=2), [(0.0, HOT2, None, None)]),
    "resize-escalation": (dict(up_streak=1, max_servers=2, resize_max_slots=8,
                               cooldown_resize_s=10.0), [
        (0.0, _snap(_row("a", "h:1", occupied=4, slots=4), _row("b", "h:2", occupied=2, slots=2)),
         None, None),
        (5.0, _snap(_row("a", "h:1", occupied=4, slots=4), _row("b", "h:2", occupied=2, slots=2)),
         None, None),
        (20.0, _snap(_row("a", "h:1", occupied=8, slots=8), _row("b", "h:2", occupied=8, slots=8)),
         None, None)]),
    "inflight-skip": (dict(down_streak=1, cooldown_down_s=0.0), [
        (0.0, _snap(_row("a", "h:1"), _row("b", "h:2", occupied=1)), {"a": ta.RESIZE}, None)]),
    "inflight-spawn-counts": (dict(up_streak=1, max_servers=2), [
        (0.0, _snap(_row("a", "h:1", occupied=4)), {"!spawn:1": ta.SCALE_UP}, None)]),
    "stale-and-draining-never-targets": (dict(up_streak=1, down_streak=1, cooldown_down_s=0.0), [
        (0.0, _snap(_row("a", "h:1", occupied=4, stale=True), _row("b", "h:2"), headroom=4),
         None, None),
        (1.0, _snap(_row("a", "h:1", stale=True), _row("b", "h:2"), _row("c", "h:3", occupied=1),
                    _row("d", "h:4", draining=True)), None, None)]),
    "empty-fleet-to-floor": (dict(), [(0.0, {"servers": [], "rollup": {}}, None, None)]),
    "degraded-freezes-ceiling-drain": (dict(max_servers=1, cooldown_down_s=0.0), [
        (1.0, _snap(_row("a", "h:1", occupied=1, slots=2), _row("b", "h:2", occupied=1, slots=2)),
         None, ("degraded", ("broker_disconnected",))),
        (2.0, _snap(_row("a", "h:1", occupied=1, slots=2), _row("b", "h:2", occupied=1, slots=2)),
         None, ("ok", ()))]),
    "degraded-allows-floor-spawn": (dict(min_servers=3, cooldown_up_s=0.0), [
        (1.0, _snap(_row("a", "h:1", occupied=1, slots=2)), None,
         ("degraded", ("below_quorum",)))]),
    "blind-freezes-everything": (dict(cooldown_up_s=0.0), [
        (1.0, {"servers": [], "rollup": {}}, None, ("blind", ("no_fresh_rows",)))]),
}


def _plan_run(mod, knobs, steps, model=None):
    pol = mod.FleetPolicy(**_policy_kw(**knobs))
    st = mod.ControllerState()
    out = []
    for now, snap, inflight, plane in steps:
        if inflight is not None:
            st.inflight.clear()
            st.inflight.update(inflight)
        ps = None if plane is None else mod.PlaneStatus(*plane)
        acts = mod.plan(snap, pol, st, now=now, model=model, plane=ps)
        out.append(([dataclasses.asdict(a) for a in acts], dataclasses.asdict(st)))
    return out


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_plan_truth_table_equal_to_jax(case):
    knobs, steps = PLAN_CASES[case]
    got, want = _plan_run(ta, knobs, steps), _plan_run(ja, knobs, steps)
    assert got == want
    kinds = [[a["kind"] for a in acts] for acts, _ in got]
    expect = {
        "up-hysteresis-and-reset": [[], [], [], [], [], ["scale_up"]],
        "up-cooldown": [["scale_up"], [], [], ["scale_up"]],
        "down-streak-least-loaded": [[], [], [], [], ["scale_down"]],
        "ceiling": [["scale_down"], []],
        "resize-escalation": [["resize"], [], []],
        "blind-freezes-everything": [[]],
        "degraded-freezes-ceiling-drain": [[], ["scale_down"]],
    }
    if case in expect:
        assert kinds == expect[case]
    if case == "down-streak-least-loaded":
        assert got[-1][0][0]["target"] == "b"
    if case == "resize-escalation":
        assert (got[0][0][0]["target"], got[0][0][0]["slots"]) == ("b", 4)


def _trained(mod):
    m = mod.PerfModel(min_samples=4)
    for occ in (0.1, 0.4, 0.7, 0.9):
        for n in (1.0, 2.0, 3.0):
            m.add_sample(occ, n, 100.0 * occ * n, 10 + 100 * occ + 2 * n + 40 * occ * n)
    return m


def test_perf_model_predicts_as_jax_and_drives_the_predictive_path():
    got, want = _trained(ta), _trained(ja)
    assert got.ready and want.ready
    for occ, n in ((0.0, 1.0), (0.5, 2.0), (0.95, 4.0), (1.3, 7.0)):
        for fn in ("predict_ttft_ms", "predict_tokens_per_s"):
            a, b = getattr(got, fn)(occ, n), getattr(want, fn)(occ, n)
            assert abs(a - b) <= 1e-9 * max(1.0, abs(b)), (fn, occ, n, a, b)
    assert got.feed_bench_row({"slots": 4, "occupied": 2, "tokens_per_s": 1.0}) is True
    assert got.feed_bench_row({"tokens_per_s": 1.0}) is False
    knobs = dict(up_streak=1, ttft_slo_ms=60.0, predict_min_samples=4)
    steps = [(0.0, _snap(_row("a", "h:1", occupied=2, waiting=2)), None, None)]
    p, j = _plan_run(ta, knobs, steps, model=_trained(ta)), _plan_run(ja, knobs, steps,
                                                                        model=_trained(ja))
    assert p == j and p[0][0] and p[0][0][0]["predictive"]


#: lease cases: (ttl, publish script per attempt or None, steps); a step is
#: (op, now, payload-or-None)
LEASE_CASES = {
    "cold-acquire-waits-ttl": (6.0, None, [("attempt", 100.0), ("attempt", 105.9),
                                           ("attempt", 106.0)]),
    "renewal-cadence": (6.0, None, [("attempt", 0.0), ("attempt", 6.0), ("attempt", 7.0),
                                    ("attempt", 8.1), ("attempt", 8.2)]),
    "fresh-foreign-refuses": (6.0, None, [("observe", 10.0, {"owner": "ctl-a", "epoch": 4,
                                                             "ttl_s": 6.0}),
                                          ("attempt", 12.0)]),
    "expired-foreign-stolen": (6.0, None, [("observe", 10.0, {"owner": "ctl-a", "epoch": 4,
                                                              "ttl_s": 6.0}),
                                           ("attempt", 15.0), ("attempt", 16.1)]),
    "deposed-by-higher-epoch": (6.0, None, [("attempt", 0.0), ("attempt", 6.0),
                                            ("observe", 7.0, {"owner": "ctl-0", "epoch": 9,
                                                              "ttl_s": 6.0})]),
    "split-lease-lower-owner-wins": (6.0, None, [("attempt", 0.0), ("attempt", 6.0),
                                                 ("observe", 7.0, {"owner": "ctl-0", "epoch": 1,
                                                                   "ttl_s": 6.0})]),
    "split-lease-higher-owner-loses-to-us": (6.0, None, [
        ("attempt", 0.0), ("attempt", 6.0),
        ("observe", 7.0, {"owner": "ctl-z", "epoch": 1, "ttl_s": 6.0})]),
    "self-fence": (6.0, [True, False, False, False], [("attempt", 0.0), ("attempt", 6.0),
                                                     ("attempt", 8.1), ("attempt", 12.2)]),
    "failed-publish-rolls-back": (6.0, [False, False], [("attempt", 0.0), ("attempt", 6.1)]),
    "reconnect-reasserts": (6.0, [True] * 4, [("attempt", 0.0), ("attempt", 6.0),
                                              ("connected", 11.0), ("attempt", 12.5)]),
    "own-echo-confirms": (6.0, [True] * 4, [("attempt", 0.0), ("attempt", 6.0), ("echo", 11.0),
                                            ("attempt", 11.5)]),
    "release-then-reacquire": (6.0, None, [("attempt", 0.0), ("attempt", 6.0), ("release", 7.0),
                                           ("attempt", 14.0)]),
}


def _lease_run(mod, ttl, publishes, steps):
    it = iter(publishes) if publishes is not None else None
    ls = mod.LeaderLease("ctl-b", ttl_s=ttl,
                         publish=None if it is None else (lambda p: next(it, True)))
    out = []
    for step in steps:
        op, now = step[0], step[1]
        if op == "attempt":
            r = ls.attempt(now)
        elif op == "observe":
            r = ls.observe(step[2], now)
        elif op == "echo":
            r = ls.observe(ls.payload(), now)
        elif op == "connected":
            r = ls.note_connected(now)
        else:
            r = ls.release()
        out.append((r, ls.held, ls.epoch, ls.acquires, ls.renewals, ls.steals, ls.losses,
                    ls.refusals, ls.self_fences, ls.payload()))
    return out


@pytest.mark.parametrize("case", sorted(LEASE_CASES))
def test_leader_lease_equal_to_jax(case):
    got, want = _lease_run(ta, *LEASE_CASES[case]), _lease_run(ja, *LEASE_CASES[case])
    assert got == want
    final = got[-1]
    if case == "expired-foreign-stolen":
        assert final[1:3] == (True, 5) and final[5] == 1
    if case == "self-fence":
        assert final[1] is False and final[8] == 1


def _plane_snap(fresh=0, stale=0, retired=0):
    rows = ([{"topic": f"t{i}", "addr": f"h:{i}", "stale": False, "slots": 2, "occupied": 1}
             for i in range(fresh)]
            + [{"topic": f"s{i}", "addr": f"h:9{i}", "stale": True} for i in range(stale)])
    return {"servers": rows, "rollup": {"retired": retired}}


#: plane cases: [(fresh, stale, retired, connected)]
PLANE_CASES = {
    "healthy": [(3, 0, 0, True)],
    "broker-disconnected": [(3, 0, 0, False)],
    "stale-fraction": [(1, 2, 0, True)],
    "silent-coverage-loss": [(4, 0, 0, True), (1, 0, 0, True)],
    "tombstoned-departure": [(4, 0, 0, True), (2, 0, 2, True)],
    "resurrection-rebaselines": [(3, 0, 0, True), (2, 0, 1, True), (3, 0, 0, True),
                                 (2, 0, 1, True)],
    "blind": [(2, 0, 0, True), (0, 2, 0, True)],
}


@pytest.mark.parametrize("case", sorted(PLANE_CASES))
def test_assess_plane_equal_to_jax(case):
    def run(mod):
        st = mod.ControllerState()
        out = []
        for fresh, stale, retired, connected in PLANE_CASES[case]:
            p = mod.assess_plane(_plane_snap(fresh, stale, retired), mod.FleetPolicy(), st,
                                 connected=connected)
            out.append((p.level, p.reasons, st.known_fleet, st.seen_retired))
        return out

    got = run(ta)
    assert got == run(ja)
    if case == "blind":
        assert got[-1][0] == "blind"


class _ScriptedObservatory:
    topic = "ctl"

    def __init__(self, snaps):
        self.snaps = list(snaps)
        self.plane_connected = True

    def snapshot(self):
        return self.snaps.pop(0) if len(self.snaps) > 1 else self.snaps[0]


def test_controller_dispatches_and_exports_as_jax():
    snaps = [_snap(_row("a", "h:1", occupied=4)), _snap(_row("a", "h:1", occupied=4)),
             _snap(_row("a", "h:1"), _row("b", "h:2"), _row("c", "h:3"))]

    def run(mod):
        t = [0.0]
        lease = mod.LeaderLease("ctl-a", ttl_s=1.0, publish=lambda p: True)
        act = mod.NullActuator()
        ctl = mod.FleetController(_ScriptedObservatory(snaps), act,
                                  mod.FleetPolicy(**_policy_kw(up_streak=2, down_streak=2,
                                                               max_servers=2,
                                                               cooldown_down_s=0.0)),
                                  clock=lambda: t[0], lease=lease)
        ticks = []
        for now in (0.0, 1.0, 1.5, 2.0, 2.5, 3.0, 3.5):
            t[0] = now
            ticks.append([dataclasses.asdict(a) for a in ctl.tick()])
        samples = sorted((s.name, tuple(sorted(s.labels.items())), s.value)
                         for s in ctl._collect())
        snap = ctl.snapshot()["autoscale"]
        return ticks, act.calls, act.epochs, samples, snap

    got, want = run(ta), run(ja)
    assert got == want
    kinds = [c[0] for c in got[1]]
    assert kinds[0] == "scale_up" and set(kinds[1:]) == {"scale_down"} and set(got[2]) == {1}
    assert any(name == "nns.autoscale.lease_epoch" and v == 1 for name, _, v in got[3])


def test_fencing_token_as_jax():
    for mod in (ta, ja):
        tok = mod.FencingToken()
        tok.check(3)
        tok.check(3)
        tok.check(None)
        with pytest.raises(mod.StaleEpochError) as ei:
            tok.check(2)
        assert (ei.value.offered, ei.value.current, tok.epoch, tok.rejects) == (2, 3, 3, 1)


# ---------------------------------------------------------------------------
# the generator's resize, through a serving pipeline
# ---------------------------------------------------------------------------
VOCAB = 997


def _oracle(prompt, n):
    t = int(np.sum(prompt)) % VOCAB
    out = []
    for _ in range(n):
        out.append(t)
        t = (31 * t + 17) % VOCAB
    return out


def _server(sid, max_new):
    pipe = parse_pipeline(
        f"tensor_query_serversrc name=ssrc id={sid} host=127.0.0.1 port=0 connect-type=tcp ! "
        f"tensor_generator name=gen slots=2 custom=sim:1,sim_step_ms:3,vocab:{VOCAB} "
        f"max-new={max_new} chunk=4 ! tensor_query_serversink id={sid}", name=f"rsz{sid}")
    pipe.start()
    return pipe


def _clients(port, n):
    out = []
    for i in range(n):
        cl = parse_pipeline(f"appsrc name=src ! tensor_query_client name=q connect-type=tcp "
                            f"host=127.0.0.1 port={port} stream=true timeout=30 "
                            f"retry-backoff=0.01 busy-retries=20 ! tensor_sink name=out",
                            name=f"rsz-cli{i}")
        cl.start()
        out.append(cl)
    return out


def _wait(pred, what, timeout=15.0):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, what
        time.sleep(0.005)


def test_request_resize_zero_loss_stale_epoch_and_rollback():
    max_new = 48
    srv = _server(1971, max_new)
    gen = srv["gen"]
    clients = _clients(srv["ssrc"].props["port"], 2)
    prompts = [np.arange(1 + i, 6 + i, dtype=np.int32) for i in range(2)]
    try:
        for cl, p in zip(clients, prompts):
            cl["src"].push(p)
        _wait(lambda: all(len(cl["out"].frames) >= 2 for cl in clients), "8 tokens each")
        before = dict(srv.health()["gen"])
        gen.request_resize(4, epoch=5)
        with pytest.raises(ta.StaleEpochError):
            gen.request_resize(8, epoch=4)  # refused before anything is touched
        for cl in clients:
            cl["src"].end_of_stream()
        for cl in clients:
            cl.wait(timeout=60)
        _wait(lambda: not gen.resize_pending, "resize landed")
        row = srv.health()["gen"]
        for cl, p in zip(clients, prompts):
            toks = [t for f in cl["out"].frames if f.tensors
                    for t in np.asarray(f.tensors[0])[0].tolist()]
            assert toks == _oracle(p, max_new)
        migrations = sum(cl.health()["q"]["stream_migrations"] for cl in clients)
        assert row["gen_goaway_evicted"] == migrations >= 1
        assert row["gen_resumes"] == migrations
        assert (row["gen_slots"], row["gen_resizes"]) == (4, 1)
        assert (row["gen_stale_epoch_rejects"], row["gen_fence_epoch"]) == (1, 5)
        from nnstreamer_tpu_torch.core.slots import SlotEngine

        for attr in SlotEngine._LEDGER_ATTRS:
            key = {"joins": "gen_joins", "completions": "gen_completed",
                   "evictions": "gen_evicted", "cancellations": "gen_cancelled",
                   "decode_steps": "gen_decode_steps", "prefill_chunks": "gen_prefill_chunks",
                   "tokens_total": "gen_tokens", "resumes": "gen_resumes",
                   "goaway_evicted": "gen_goaway_evicted", "oom_retries": "gen_oom_retries",
                   "oom_sheds": "gen_oom_sheds", "device_lost": "gen_device_lost",
                   "device_lost_evicted": "gen_device_lost_evicted",
                   "remeshes": "gen_remeshes"}[attr]
            assert row[key] >= before[key], key
        assert srv["gen"].props["slots"] == 4

        # a build that fails rolls back: the old width keeps serving and new
        # streams are no longer handed off
        def broken(slots):
            raise RuntimeError("no memory for the wider cache")

        gen._build_slot_model = broken
        gen.request_resize(8)
        _wait(lambda: not gen.resize_pending, "rollback landed")
        cl2 = _clients(srv["ssrc"].props["port"], 1)[0]
        try:
            cl2["src"].push(prompts[0])
            cl2["src"].end_of_stream()
            cl2.wait(timeout=30)
            toks = [t for f in cl2["out"].frames if f.tensors
                    for t in np.asarray(f.tensors[0])[0].tolist()]
            handed = cl2.health()["q"]["stream_migrations"]
        finally:
            cl2.stop()
        row = srv.health()["gen"]
        assert toks == _oracle(prompts[0], max_new) and handed == 0
        assert (row["gen_slots"], row["gen_resizes"]) == (4, 1)
    finally:
        for cl in clients:
            cl.stop()
        srv.stop()
    assert not [s for s in REGISTRY.collect() if s.name.startswith("nns.autoscale.")]


def test_lease_channel_hands_the_lease_to_the_standby_over_mqtt():
    """Two controllers' leases over ``LeaseChannel`` on a ``MiniBroker``
    (127.0.0.1), under one fake clock: the first takes epoch 1 and the
    standby, which sees the retained document, is refused; once the first
    is gone and its lease has expired, the standby steals it at epoch 2,
    and a target fenced at 2 refuses the deposed leader's epoch."""
    from nnstreamer_tpu_torch.distributed.mqtt import MiniBroker

    broker = MiniBroker()
    t = [0.0]
    chans = []
    try:
        leases = [ta.LeaderLease(f"ctl-{c}", ttl_s=2.0) for c in "ab"]
        chans = [ta.LeaseChannel("127.0.0.1", broker.port, "fx", ls, clock=lambda: t[0])
                 for ls in leases]
        _wait(lambda: all(c.connected for c in chans), "both channels connected")
        a, b = leases
        assert not a.attempt(0.0)
        t[0] = 2.0
        assert a.attempt(2.0) and a.epoch == 1
        _wait(lambda: b._seen is not None, "the standby saw the retained lease")
        assert not b.attempt(2.5) and b.refusals == 1
        chans[0].close()
        t[0] = 4.5
        assert b.attempt(4.5) and (b.epoch, b.steals) == (2, 1)
        target = ta.FencingToken()
        target.check(b.epoch)
        with pytest.raises(ta.StaleEpochError):
            target.check(a.epoch)
        assert target.rejects == 1
    finally:
        for c in chans:
            c.close()
        broker.close()

"""Fleet autoscaling: the loop from the fleet observatory to actuation.

Port of ``nnstreamer_tpu/core/autoscale.py``.  ``core/fleet.py``'s
:class:`~.fleet.FleetObservatory` rolls the fleet's telemetry digests up;
this module acts on them, in three layers that keep the decision pure and
the side effects pluggable:

* :func:`plan`: a pure decision step ``(snapshot, policy, state, now) ->
  [Action]`` (spawn, drain or resize) with hysteresis streaks, per-kind
  cooldowns, a min/max fleet envelope and at most one action in flight per
  server.  Every suppressed impulse is counted (``hysteresis_holds``,
  ``cooldown_skips``, ``envelope_clamps``, ``inflight_skips``), so a quiet
  controller is told apart from a blind one.  Deterministic under a fake
  clock.
* :class:`PerfModel`: a least-squares fit (numpy) of fleet throughput and
  worst p95 TTFT against slot occupancy and fleet size; once it holds
  ``min_samples`` observations the planner acts on the projected TTFT,
  below that the reactive path alone decides.
* :class:`FleetController`: reap finished tickets, take the leader lease
  (:class:`LeaderLease` over :class:`LeaseChannel`, MQTT), grade the view
  (:func:`assess_plane`: a degraded view freezes drains and resizes, a
  blind one everything), snapshot, plan, and dispatch through a
  :class:`FleetActuator`.  Every action carries the lease epoch; targets
  refuse an older one (:class:`FencingToken`, :class:`StaleEpochError`)
  before touching any stream.  The decision ledger exports as
  ``nns.autoscale.*`` through the one registry path.

Zero loss by construction: a scale-down actuates the serversrc's
``request_drain()``, whose live generation streams hand off through the
resumable GOAWAY chunks and resume elsewhere, and a resize the generator's
``request_resize()``, which hands them off the same way around the
rebuild.  Stale rows (``core/fleet.py``'s stale tier) never count as
capacity and are never picked as a drain or resize target.
"""

from __future__ import annotations

import json
import math
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

from .log import get_logger
from .telemetry import METRICS, REGISTRY, Sample, metric_kind

log = get_logger("autoscale")

#: action kinds (the FleetActuator verbs)
SCALE_UP = "scale_up"
SCALE_DOWN = "scale_down"
RESIZE = "resize"

#: control-plane view levels (the fail-static ladder, worst first)
PLANE_OK = "ok"
PLANE_DEGRADED = "degraded"
PLANE_BLIND = "blind"
_PLANE_RANK = {PLANE_OK: 0, PLANE_DEGRADED: 1, PLANE_BLIND: 2}


# ---------------------------------------------------------------------------
# Fencing (controller duplication safety)
# ---------------------------------------------------------------------------
class StaleEpochError(RuntimeError):
    """Typed reject: a fenced control command carried a lease epoch older
    than one this target already accepted — the sender is a deposed
    controller (partitioned old leader, duplicated deployment).  The
    command is REFUSED before it can touch any stream or ledger."""

    def __init__(self, offered: int, current: int):
        super().__init__(
            f"stale lease epoch {offered} < fence {current}: command "
            "refused (issuer no longer holds the leader lease)")
        self.offered = int(offered)
        self.current = int(current)


class FencingToken:
    """A target's side of lease fencing: remember the highest lease
    epoch ever accepted and refuse anything older.  ``epoch=None`` is
    the local/operator bypass (a human on the box outranks the lease
    machinery); every refusal is counted exactly."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.epoch = 0
        self.rejects = 0

    def check(self, epoch: Optional[int]) -> None:
        """Admit ``epoch`` (advancing the fence) or raise
        :class:`StaleEpochError`.  Same-epoch commands are admitted:
        the lease guarantees one holder per epoch."""
        if epoch is None:
            return
        epoch = int(epoch)
        with self._lock:
            if epoch < self.epoch:
                self.rejects += 1
                raise StaleEpochError(epoch, self.epoch)
            self.epoch = epoch


# ---------------------------------------------------------------------------
# Leader lease (at most one actuating controller, by construction)
# ---------------------------------------------------------------------------
class LeaderLease:
    """Epoch-numbered, TTL'd leader lease over one retained document.

    Pure local logic under explicit clock values (a fake clock drives
    every transition in the tests); the
    transport is a pluggable ``publish(payload) -> bool`` callable
    (:class:`LeaseChannel` binds it to the retained MQTT topic).

    Rules:

    * **acquire** — only when the lease topic is provably vacant: the
      last seen lease has outlived its TTL, or nothing was seen for a
      full TTL of watching (retained redelivery must get its chance).
      The new epoch is ``max(every epoch ever seen) + 1`` — strictly
      monotonic across takeovers.
    * **renew** — the holder re-publishes every ``ttl/3``; a renewal is
      confirmed by a successful publish or by observing its own
      retained echo.
    * **self-fence** — a holder whose renewals go unconfirmed for a
      full TTL steps down on its own: a partitioned old leader stops
      actuating BEFORE the standby's takeover epoch can land
      (fail-static, not split-brain).
    * **split lease** — a same-epoch foreign lease (amnesiac broker,
      dueling brokers) resolves deterministically: the lower owner id
      wins everywhere; a fresh foreign lease always refuses an acquire.
    """

    def __init__(self, owner: str, ttl_s: float = 5.0,
                 publish: Optional[Callable[[dict], bool]] = None):
        self.owner = str(owner)
        self.ttl_s = float(ttl_s)
        self.publish = publish
        self.held = False
        self.epoch = 0
        self._max_epoch = 0
        self._seen: Optional[Dict[str, Any]] = None
        self._seen_ts = 0.0
        self._watch_start: Optional[float] = None
        self._confirmed_ts: Optional[float] = None
        self._renew_due_ts = 0.0
        self._lock = threading.RLock()
        # exact transition ledger (exported as nns.autoscale.lease_*)
        self.acquires = 0
        self.renewals = 0
        self.steals = 0
        self.losses = 0
        self.refusals = 0
        self.self_fences = 0

    def payload(self) -> dict:
        return {"owner": self.owner, "epoch": self.epoch,
                "ttl_s": self.ttl_s}

    def _try_publish(self) -> bool:
        if self.publish is None:
            return True
        try:
            return bool(self.publish(self.payload()))
        except OSError:
            return False

    def observe(self, payload: dict, now: float) -> None:
        """Inbound retained lease doc (subscription callback, or the
        truth table injecting a peer's view)."""
        try:
            owner = str(payload["owner"])
            epoch = int(payload["epoch"])
            ttl = float(payload.get("ttl_s", self.ttl_s))
        except (KeyError, TypeError, ValueError):
            return
        with self._lock:
            self._max_epoch = max(self._max_epoch, epoch)
            if owner == self.owner:
                if self.held and epoch == self.epoch:
                    self._confirmed_ts = now  # our own retained echo
                return
            self._seen = {"owner": owner, "epoch": epoch, "ttl_s": ttl}
            self._seen_ts = now
            if not self.held:
                return
            if epoch > self.epoch:
                # a higher-epoch leader exists: we were deposed while
                # partitioned — step down instantly
                self.held = False
                self.losses += 1
            elif epoch == self.epoch and owner < self.owner:
                # split lease: deterministic winner is the lower owner
                # id, on BOTH sides — exactly one controller survives
                self.held = False
                self.losses += 1

    def note_connected(self, now: float) -> None:
        """Transport (re)connected: restart the vacancy watch so a
        standby waits out retained redelivery before declaring the
        topic empty, and re-assert a held lease into an amnesiac
        broker."""
        with self._lock:
            self._watch_start = now
            if self.held and self._try_publish():
                self._confirmed_ts = now

    def release(self) -> None:
        """Voluntary stepdown (tests/operator): not counted as a loss."""
        with self._lock:
            self.held = False

    def attempt(self, now: float) -> bool:
        """One lease step per controller tick: renew when held, acquire
        when provably vacant, self-fence when unconfirmed past a full
        TTL.  Returns whether the lease is held after the step."""
        with self._lock:
            if self._watch_start is None:
                self._watch_start = now
            if self.held:
                if now >= self._renew_due_ts and self._try_publish():
                    self.renewals += 1
                    self._confirmed_ts = now
                    self._renew_due_ts = now + self.ttl_s / 3.0
                if (self._confirmed_ts is not None
                        and now - self._confirmed_ts > self.ttl_s):
                    self.held = False
                    self.self_fences += 1
                    self.losses += 1
                return self.held
            # -- standby: is the topic provably vacant? -------------------
            foreign = False
            if self._seen is not None:
                if now - self._seen_ts <= float(self._seen["ttl_s"]):
                    self.refusals += 1
                    return False
                foreign = self._seen["owner"] != self.owner
            elif now - self._watch_start < self.ttl_s:
                return False
            prev = self.epoch
            self.epoch = max(self._max_epoch, self.epoch) + 1
            if not self._try_publish():
                self.epoch = prev  # transport refused; stay standby
                return False
            self._max_epoch = max(self._max_epoch, self.epoch)
            self.held = True
            self.acquires += 1
            if foreign:
                self.steals += 1
            self._confirmed_ts = now
            self._renew_due_ts = now + self.ttl_s / 3.0
            return True


class LeaseChannel:
    """MQTT binding for :class:`LeaderLease`: one retained lease doc on
    ``nns/ctl/<fleet>/lease`` — deliberately OUTSIDE the ``nns/query/#``
    announce prefix, so discovery subscribers never try to parse it.
    Subscribing to the same topic the lease publishes on gives every
    controller (holder and standby) the same retained view, and the
    reconnect hook re-arms the vacancy watch + re-asserts a held lease
    after broker amnesia."""

    def __init__(self, host: str, port: int, fleet_topic: str,
                 lease: LeaderLease,
                 brokers: Optional[List[Tuple[str, int]]] = None,
                 clock: Callable[[], float] = time.monotonic):
        from ..distributed.mqtt import MqttClient

        self.topic = f"nns/ctl/{fleet_topic or 'all'}/lease"
        self.lease = lease
        self._clock = clock
        self._client = MqttClient(host, port, brokers=brokers)
        lease.publish = self._publish
        self._client.subscribe(self.topic, self._on_msg, qos=1)
        self._client.on_connect(
            lambda: lease.note_connected(self._clock()))

    @property
    def connected(self) -> bool:
        return self._client.connected.is_set()

    def _publish(self, payload: dict) -> bool:
        if not self._client.connected.is_set():
            return False
        self._client.publish(
            self.topic, json.dumps(payload).encode(), retain=True, qos=1)
        return True

    def _on_msg(self, topic: str, payload: bytes) -> None:
        if not payload:
            return
        try:
            doc = json.loads(payload.decode())
        except (ValueError, UnicodeDecodeError):
            log.warning("undecodable lease doc on %s", topic)
            return
        self.lease.observe(doc, self._clock())

    def close(self) -> None:
        self._client.close()


@dataclass
class FleetPolicy:
    """Policy knobs for :func:`plan`."""

    #: fleet-size envelope — the planner never steers outside it
    min_servers: int = 1
    max_servers: int = 8
    #: reactive scale-up triggers: fleet occupancy at/above high water,
    #: admittable slot headroom below the floor, or any tenant's SLO
    #: burn rate at/above ``burn_high``
    occupancy_high: float = 0.85
    slot_headroom_min: int = 1
    burn_high: float = 1.0
    #: reactive scale-down trigger: occupancy at/below low water with
    #: no waiting prompts and no burning tenant
    occupancy_low: float = 0.30
    #: hysteresis: consecutive pressured ticks before acting (scale-up
    #: reacts fast, scale-down deliberately slow)
    up_streak: int = 2
    down_streak: int = 5
    #: per-action-kind cooldowns, seconds of fake/mono clock
    cooldown_up_s: float = 10.0
    cooldown_down_s: float = 30.0
    cooldown_resize_s: float = 30.0
    #: per-server slot-width ceiling for resize escalation when the
    #: fleet is already at ``max_servers`` (0 = resize disabled)
    resize_max_slots: int = 0
    #: predictive path: observations banked before the model may act,
    #: and the TTFT objective it projects against (0 = never predict)
    predict_min_samples: int = 8
    ttft_slo_ms: float = 0.0
    #: fail-static ladder thresholds (:func:`assess_plane`): the view is
    #: DEGRADED once more than this fraction of present rows is stale,
    #: or fresh coverage falls below this fraction of the last-known
    #: fleet (BLIND = no fresh rows at all)
    plane_stale_fraction_max: float = 0.5
    plane_quorum_fraction: float = 0.5


@dataclass
class Action:
    """One planned actuation.  ``target`` is the server's announce
    topic ("" for spawn — the actuator picks placement); ``slots`` is
    the new width for resize."""

    kind: str
    target: str = ""
    slots: int = 0
    reason: str = ""
    predictive: bool = False


@dataclass
class ControllerState:
    """Mutable planning state threaded through :func:`plan` — explicit
    so the truth table replays decisions deterministically.  The skip
    counters accumulate across ticks (they back the ``nns.autoscale.*``
    counters)."""

    up_streak: int = 0
    down_streak: int = 0
    #: per-kind monotonic timestamp of the last emitted action
    last_action_ts: Dict[str, float] = field(default_factory=dict)
    #: inflight ledger: target key -> action kind (the controller
    #: mirrors its ticket table here; plan() never touches a listed
    #: target and counts inflight spawns toward the fleet size)
    inflight: Dict[str, str] = field(default_factory=dict)
    #: fleet size the last plan steered toward
    target_servers: int = 0
    # -- suppressed-impulse accounting (quiet != blind) ------------------
    decisions: int = 0
    hysteresis_holds: int = 0
    cooldown_skips: int = 0
    envelope_clamps: int = 0
    inflight_skips: int = 0
    predictive_decisions: int = 0
    reactive_decisions: int = 0
    # -- fail-static ladder (assess_plane + plan(plane=...)) --------------
    #: actions the ladder froze instead of dispatching, total and by
    #: assessed reason (backs the reason-labeled ``nns.autoscale.frozen``)
    frozen: int = 0
    frozen_by_reason: Dict[str, int] = field(default_factory=dict)
    #: fleet size of the last TRUSTED view (grown on any fresh sighting,
    #: shrunk only by observed tombstone retirements) — the quorum
    #: baseline that makes "half the fleet went invisible" detectable
    known_fleet: int = 0
    #: rollup retirement counter baseline (-1 = not yet baselined)
    seen_retired: int = -1


def _fresh_rows(snapshot: Dict[str, Any]) -> List[Dict[str, Any]]:
    return [r for r in snapshot.get("servers", ())
            if not r.get("stale")]


@dataclass(frozen=True)
class PlaneStatus:
    """One assessed control-plane view level with its exact reasons —
    what :func:`plan` gates on and what the freeze counter labels."""

    level: str = PLANE_OK
    reasons: Tuple[str, ...] = ()

    @property
    def ok(self) -> bool:
        return self.level == PLANE_OK


def assess_plane(snapshot: Dict[str, Any], policy: FleetPolicy,
                 state: ControllerState,
                 connected: bool = True) -> PlaneStatus:
    """Grade the observatory view for the fail-static ladder.

    DEGRADED (freeze destructive actions — drain/resize/ceiling) when
    the broker is disconnected, more than ``plane_stale_fraction_max``
    of present rows is stale, or fresh coverage fell below
    ``plane_quorum_fraction`` of the last-known fleet without observed
    tombstones explaining the departures.  BLIND (freeze everything)
    when not a single fresh row remains — a cold or fully blinded
    controller is no controller.

    ``state.known_fleet`` is the quorum baseline: it grows on any fresh
    sighting and shrinks only by tombstone retirements counted in the
    rollup — so an intentional drain never reads as coverage loss, but
    a partition that silently ages half the fleet into eviction does."""
    rows = list(snapshot.get("servers") or ())
    fresh = [r for r in rows if not r.get("stale")]
    roll = snapshot.get("rollup") or {}
    retired = int(roll.get("retired", 0) or 0)
    if state.seen_retired < 0:
        state.seen_retired = retired  # first sight: baseline only
    elif retired > state.seen_retired:
        state.known_fleet = max(
            0, state.known_fleet - (retired - state.seen_retired))
        state.seen_retired = retired
    elif retired < state.seen_retired:
        # resurrection reversal: a retired server re-announced and the
        # rollup un-counted it — re-baseline DOWN too, or the next real
        # retirement would be swallowed by the stale baseline
        state.seen_retired = retired
    state.known_fleet = max(state.known_fleet, len(fresh))

    reasons: List[str] = []
    if not connected:
        reasons.append("broker_disconnected")
    if rows:
        stale_fraction = 1.0 - len(fresh) / len(rows)
        if stale_fraction > policy.plane_stale_fraction_max:
            reasons.append("stale_fraction")
    if state.known_fleet > 0:
        quorum = max(1, math.ceil(
            state.known_fleet * policy.plane_quorum_fraction))
        if len(fresh) < quorum:
            reasons.append("below_quorum")
    if not fresh:
        return PlaneStatus(PLANE_BLIND, tuple(reasons) + ("no_fresh_rows",))
    if reasons:
        return PlaneStatus(PLANE_DEGRADED, tuple(reasons))
    return PlaneStatus(PLANE_OK)


def _freeze(state: ControllerState, plane: PlaneStatus) -> List[Action]:
    """Count one impulse the fail-static ladder froze (per assessed
    reason, so the labeled counter tells outage causes apart)."""
    state.frozen += 1
    for r in plane.reasons or (plane.level,):
        state.frozen_by_reason[r] = state.frozen_by_reason.get(r, 0) + 1
    return []


def _drain_target(fresh: List[Dict[str, Any]],
                  state: ControllerState) -> Optional[Dict[str, Any]]:
    """Least-loaded fresh server not already draining and with no
    action in flight (one action in flight per server, ever — skips
    are counted so a blocked drain is visible)."""
    cands = []
    for r in fresh:
        if r.get("draining"):
            continue
        if r.get("topic") in state.inflight:
            state.inflight_skips += 1
            continue
        cands.append(r)
    if not cands:
        return None
    return min(cands, key=lambda r: (int(r.get("occupied", 0) or 0),
                                     float(r.get("tokens_per_s", 0.0)
                                           or 0.0),
                                     str(r.get("addr", ""))))


def _cool(state: ControllerState, policy: FleetPolicy, kind: str,
          now: float) -> bool:
    """True while ``kind`` is still cooling down."""
    cool = {SCALE_UP: policy.cooldown_up_s,
            SCALE_DOWN: policy.cooldown_down_s,
            RESIZE: policy.cooldown_resize_s}[kind]
    last = state.last_action_ts.get(kind)
    return last is not None and (now - last) < cool


def _emit(state: ControllerState, now: float, action: Action
          ) -> List[Action]:
    state.last_action_ts[action.kind] = now
    state.decisions += 1
    if action.predictive:
        state.predictive_decisions += 1
    else:
        state.reactive_decisions += 1
    return [action]


def plan(snapshot: Dict[str, Any], policy: FleetPolicy,
         state: Optional[ControllerState] = None, now: float = 0.0,
         model: Optional["PerfModel"] = None,
         plane: Optional[PlaneStatus] = None) -> List[Action]:
    """ONE decision step: pure in its inputs (snapshot + policy +
    explicit state and clock), deterministic, side-effect-free beyond
    the explicit ``state``.  Returns the actions to dispatch this tick
    (at most one — a controller that batches corrections flaps).

    Decision order: envelope floor (immediate — a fleet below
    ``min_servers`` is an outage, not a trend) → scale-up pressure
    (reactive observed signals first, then the predictive projection)
    → scale-down pressure.  Hysteresis streaks gate both directions,
    cooldowns gate re-fire, the envelope clamps the result, and no
    target with an action already in flight is ever picked again.

    ``plane`` (from :func:`assess_plane`) arms the fail-static ladder:
    a DEGRADED view freezes the destructive kinds (drain, resize, the
    ceiling drain), a BLIND view freezes everything — a telemetry
    outage must never amplify into a fleet outage.  ``plane=None``
    (the pure truth table, operators driving plan() by hand) means a
    trusted view.  Frozen impulses are counted, never silently lost;
    hysteresis streaks keep accumulating under a freeze so a healed
    plane acts on the first trusted tick."""
    if state is None:
        state = ControllerState()
    frozen: Tuple[str, ...] = ()
    if plane is not None and plane.level == PLANE_BLIND:
        frozen = (SCALE_UP, SCALE_DOWN, RESIZE)
    elif plane is not None and plane.level == PLANE_DEGRADED:
        frozen = (SCALE_DOWN, RESIZE)
    roll = snapshot.get("rollup") or {}
    fresh = _fresh_rows(snapshot)
    n = len(fresh)
    inflight_spawns = sum(
        1 for k in state.inflight.values() if k == SCALE_UP)
    inflight_drains = sum(
        1 for k in state.inflight.values() if k == SCALE_DOWN)
    # a spawning server is capacity-to-be; a draining one is already gone
    n_eff = n + inflight_spawns - inflight_drains
    state.target_servers = max(n_eff, policy.min_servers)

    slots = sum(int(r.get("slots", 0) or 0) for r in fresh)
    occupied = sum(int(r.get("occupied", 0) or 0) for r in fresh)
    waiting = sum(int(r.get("waiting", 0) or 0) for r in fresh)
    occupancy = (occupied / slots) if slots else 0.0
    # demand occupancy counts queued prompts — the predictive feature
    demand = ((occupied + waiting) / slots) if slots else 0.0
    headroom = int(roll.get("slot_headroom", 0) or 0)
    burn = max([float(b) for b in (roll.get("slo_burn") or {}).values()],
               default=0.0)

    # -- envelope floor: below min is an outage, act immediately --------
    if n_eff < policy.min_servers:
        if SCALE_UP in frozen:
            # a blind controller seeing "zero servers" must NOT spawn:
            # the fleet may be fine and merely invisible (cold start,
            # broker death) — cold/blind controller == no controller
            return _freeze(state, plane)
        if _cool(state, policy, SCALE_UP, now):
            state.cooldown_skips += 1
            return []
        state.target_servers = policy.min_servers
        return _emit(state, now, Action(
            SCALE_UP, reason=f"fleet {n_eff} below floor "
            f"{policy.min_servers}"))

    # -- envelope ceiling: the operator shrank the bound — converge by
    # zero-loss drains (no hysteresis: the envelope is a hard edict;
    # the cooldown still paces it to one drain per window) ---------------
    if n_eff > policy.max_servers:
        if SCALE_DOWN in frozen:
            return _freeze(state, plane)
        if _cool(state, policy, SCALE_DOWN, now):
            state.cooldown_skips += 1
            return []
        tgt = _drain_target(fresh, state)
        if tgt is None:
            return []
        state.target_servers = n_eff - 1
        return _emit(state, now, Action(
            SCALE_DOWN, target=str(tgt.get("topic", "")),
            reason=f"fleet {n_eff} above ceiling {policy.max_servers}; "
            f"draining {tgt.get('addr')} (occupied "
            f"{int(tgt.get('occupied', 0) or 0)})"))

    # -- scale-up pressure ----------------------------------------------
    up_reason = ""
    predictive = False
    if slots and occupancy >= policy.occupancy_high:
        up_reason = (f"occupancy {occupancy:.2f} >= "
                     f"{policy.occupancy_high:.2f}")
    elif slots and headroom < policy.slot_headroom_min:
        up_reason = (f"slot headroom {headroom} < "
                     f"{policy.slot_headroom_min}")
    elif burn >= policy.burn_high:
        up_reason = f"slo burn {burn:.2f} >= {policy.burn_high:.2f}"
    elif (model is not None and model.ready and policy.ttft_slo_ms > 0
          and slots):
        projected = model.predict_ttft_ms(demand, n_eff)
        if projected >= policy.ttft_slo_ms:
            up_reason = (f"projected ttft {projected:.0f}ms >= slo "
                         f"{policy.ttft_slo_ms:.0f}ms at demand "
                         f"{demand:.2f}")
            predictive = True

    if up_reason:
        state.down_streak = 0
        state.up_streak += 1
        if state.up_streak < policy.up_streak:
            state.hysteresis_holds += 1
            return []
        if n_eff >= policy.max_servers:
            # resize escalation: the envelope is full but a server can
            # grow its slot batch in place (zero-loss: live streams
            # hand off resumably around the rebuild)
            if policy.resize_max_slots > 0:
                cands = [
                    r for r in fresh
                    if r.get("topic") not in state.inflight
                    and not r.get("draining")
                    and 0 < int(r.get("slots", 0) or 0)
                    < policy.resize_max_slots
                ]
                if cands:
                    if RESIZE in frozen:
                        return _freeze(state, plane)
                    if _cool(state, policy, RESIZE, now):
                        state.cooldown_skips += 1
                        return []
                    tgt = min(cands,
                              key=lambda r: (int(r.get("slots", 0) or 0),
                                             str(r.get("addr", ""))))
                    cur = int(tgt.get("slots", 0) or 0)
                    new = min(policy.resize_max_slots, max(cur + 1,
                                                           cur * 2))
                    state.up_streak = 0
                    return _emit(state, now, Action(
                        RESIZE, target=str(tgt.get("topic", "")),
                        slots=new, predictive=predictive,
                        reason=f"{up_reason}; fleet at max "
                        f"{policy.max_servers}, widening "
                        f"{tgt.get('addr')} {cur}->{new}"))
            state.envelope_clamps += 1
            return []
        if SCALE_UP in frozen:
            return _freeze(state, plane)
        if _cool(state, policy, SCALE_UP, now):
            state.cooldown_skips += 1
            return []
        state.up_streak = 0
        state.target_servers = n_eff + 1
        return _emit(state, now, Action(
            SCALE_UP, reason=up_reason, predictive=predictive))

    # -- scale-down pressure --------------------------------------------
    state.up_streak = 0
    calm = (slots > 0 and occupancy <= policy.occupancy_low
            and waiting == 0 and burn < policy.burn_high)
    if not calm:
        state.down_streak = 0
        return []
    state.down_streak += 1
    if state.down_streak < policy.down_streak:
        state.hysteresis_holds += 1
        return []
    if n_eff <= policy.min_servers:
        state.envelope_clamps += 1
        return []
    if SCALE_DOWN in frozen:
        return _freeze(state, plane)
    if _cool(state, policy, SCALE_DOWN, now):
        state.cooldown_skips += 1
        return []
    tgt = _drain_target(fresh, state)
    if tgt is None:
        return []
    state.down_streak = 0
    state.target_servers = n_eff - 1
    return _emit(state, now, Action(
        SCALE_DOWN, target=str(tgt.get("topic", "")),
        reason=f"occupancy {occupancy:.2f} <= {policy.occupancy_low:.2f}"
        f" for {policy.down_streak} ticks; draining "
        f"{tgt.get('addr')} (occupied "
        f"{int(tgt.get('occupied', 0) or 0)})"))


# ---------------------------------------------------------------------------
# Predictive model
# ---------------------------------------------------------------------------
class PerfModel:
    """Least-squares fleet performance model: worst p95 TTFT (ms) and
    aggregate tokens/s as functions of slot occupancy and fleet size.

    Features ``[1, occ, n, occ·n]`` fit by normal equations (numpy
    ``lstsq`` — tiny, no solver dependency); observations come from
    observatory snapshots (the digest's ``ttft_p95_ms`` is the SLO
    tracker's log2-histogram estimate) and from banked bench rows
    (:meth:`feed_bench_row`).  ``ready`` only once ``min_samples``
    observations spanning at least two distinct occupancies are banked —
    below that the controller's reactive path is the only authority
    (predictive-path fallback, pinned by the truth table)."""

    MAX_SAMPLES = 512

    def __init__(self, min_samples: int = 8):
        self.min_samples = max(2, int(min_samples))
        self._rows: Deque[Tuple[float, float, float, float]] = deque(
            maxlen=self.MAX_SAMPLES)
        self._w_ttft: Optional[Any] = None
        self._w_tps: Optional[Any] = None
        self._dirty = False
        self.bench_rows = 0

    def __len__(self) -> int:
        return len(self._rows)

    def add_sample(self, occupancy: float, servers: float,
                   tokens_per_s: float, ttft_ms: float) -> None:
        """Bank one observation (zero-TTFT rows are banked for the
        throughput fit but carry no latency signal — they are excluded
        from the TTFT fit)."""
        self._rows.append((float(occupancy), float(servers),
                           float(tokens_per_s), float(ttft_ms)))
        self._dirty = True

    def feed_bench_row(self, row: Dict[str, Any]) -> bool:
        """Bank one benchmark evidence row (``pipeline_digest_stats``
        numbers of one run): needs occupancy
        (or slots+occupied) and at least one of tokens/s / TTFT."""
        try:
            if "occupancy" in row:
                occ = float(row["occupancy"])
            else:
                slots = float(row["slots"])
                occ = float(row["occupied"]) / slots if slots else 0.0
            servers = float(row.get("servers", 1) or 1)
            tps = float(row.get("tokens_per_s", 0.0) or 0.0)
            ttft = float(row.get("ttft_p95_ms", 0.0) or 0.0)
        except (KeyError, TypeError, ValueError):
            return False
        self.add_sample(occ, servers, tps, ttft)
        self.bench_rows += 1
        return True

    @staticmethod
    def _features(occ: float, servers: float):
        return (1.0, occ, servers, occ * servers)

    def _fit(self) -> None:
        import numpy as np

        self._dirty = False
        self._w_ttft = self._w_tps = None
        rows = list(self._rows)
        if len(rows) < self.min_samples:
            return
        if len({round(r[0], 6) for r in rows}) < 2:
            return  # no occupancy spread: the fit would extrapolate air
        x = np.array([self._features(o, s) for o, s, _, _ in rows])
        tps = np.array([r[2] for r in rows])
        self._w_tps = np.linalg.lstsq(x, tps, rcond=None)[0]
        lat = [(o, s, t) for o, s, _, t in rows if t > 0]
        if len(lat) >= self.min_samples:
            xl = np.array([self._features(o, s) for o, s, _ in lat])
            yl = np.array([t for _, _, t in lat])
            self._w_ttft = np.linalg.lstsq(xl, yl, rcond=None)[0]

    @property
    def ready(self) -> bool:
        if self._dirty:
            self._fit()
        return self._w_ttft is not None

    def predict_ttft_ms(self, occupancy: float, servers: float) -> float:
        if not self.ready:
            return 0.0
        v = float(sum(w * f for w, f in zip(
            self._w_ttft, self._features(occupancy, servers))))
        return max(0.0, v)

    def predict_tokens_per_s(self, occupancy: float,
                             servers: float) -> float:
        if self._dirty:
            self._fit()
        if self._w_tps is None:
            return 0.0
        v = float(sum(w * f for w, f in zip(
            self._w_tps, self._features(occupancy, servers))))
        return max(0.0, v)


# ---------------------------------------------------------------------------
# Actuation plane
# ---------------------------------------------------------------------------
class ActionTicket:
    """One dispatched action's completion handle.  The actuator resolves
    it asynchronously; the controller reaps it on a later tick (actions
    are minutes-scale — the decision loop must never block on one)."""

    def __init__(self) -> None:
        self._done = threading.Event()
        self.ok: Optional[bool] = None
        self.detail = ""

    def resolve(self, ok: bool, detail: str = "") -> None:
        self.ok = bool(ok)
        self.detail = detail
        self._done.set()

    def done(self) -> bool:
        return self._done.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)


class FleetActuator:
    """The three verbs a deployment plane implements.  The
    in-process actuator of a test or a smoke run maps them to the
    elements' fenced entry points; a real plane maps them to its
    scheduler.  Every verb returns an :class:`ActionTicket` and
    must NEVER block the calling thread.

    ``epoch`` is the issuing controller's lease epoch (fencing): the
    actuator forwards it to the target's fenced entry points
    (``request_drain(epoch=...)``/``request_resize(..., epoch=...)``),
    which refuse stale epochs with :class:`StaleEpochError`.  ``0``
    (the no-lease default) is below every real epoch, so an unleased
    controller can never out-fence a leased one."""

    def spawn(self, epoch: int = 0) -> ActionTicket:
        raise NotImplementedError

    def drain(self, target: str, epoch: int = 0) -> ActionTicket:
        """Zero-loss decommission of the server announcing under
        ``target``: request_drain → GOAWAY handoffs → stop."""
        raise NotImplementedError

    def resize(self, target: str, slots: int,
               epoch: int = 0) -> ActionTicket:
        raise NotImplementedError


class NullActuator(FleetActuator):
    """Records every verb and resolves instantly: an armed-but-idle
    controller's actuator, and the tests' probe."""

    def __init__(self) -> None:
        self.calls: List[Tuple[str, str, int]] = []
        self.epochs: List[int] = []

    def _ticket(self, kind: str, target: str = "", slots: int = 0,
                epoch: int = 0) -> ActionTicket:
        self.calls.append((kind, target, slots))
        self.epochs.append(int(epoch))
        t = ActionTicket()
        t.resolve(True)
        return t

    def spawn(self, epoch: int = 0) -> ActionTicket:
        return self._ticket(SCALE_UP, epoch=epoch)

    def drain(self, target: str, epoch: int = 0) -> ActionTicket:
        return self._ticket(SCALE_DOWN, target, epoch=epoch)

    def resize(self, target: str, slots: int,
               epoch: int = 0) -> ActionTicket:
        return self._ticket(RESIZE, target, slots, epoch=epoch)


# ---------------------------------------------------------------------------
# Controller
# ---------------------------------------------------------------------------
class FleetController:
    """The closed loop: observatory snapshot → :func:`plan` →
    actuator dispatch, with exact ``nns.autoscale.*`` accounting and a
    flight-recorder incident on every scale action.

    Drive :meth:`tick` from any slow cadence: :meth:`attach` rides a
    pipeline's watchdog sweeper (``register_sweep``: no per-frame
    cost), a script calls it directly, and tests drive it under a fake
    clock."""

    def __init__(self, observatory, actuator: FleetActuator,
                 policy: Optional[FleetPolicy] = None,
                 clock: Callable[[], float] = time.monotonic,
                 recorder=None, model: Optional[PerfModel] = None,
                 lease: Optional[LeaderLease] = None):
        self.observatory = observatory
        self.actuator = actuator
        self.policy = policy or FleetPolicy()
        self.clock = clock
        self.state = ControllerState()
        self.model = model or PerfModel(
            min_samples=self.policy.predict_min_samples)
        #: leader lease (None = single-controller deployment): a
        #: controller without the lease is a pure standby — it reaps
        #: its old tickets but neither plans nor actuates
        self.lease = lease
        self._recorder = recorder
        self._pipe = None
        self._lock = threading.Lock()
        self._inflight: Dict[str, Tuple[Action, ActionTicket]] = {}
        self._spawn_seq = 0
        #: recent decisions (ts, action, status), for dashboards
        self.recent: Deque[Tuple[float, Action, str]] = deque(maxlen=16)
        self.ticks = 0
        self.scale_ups = 0
        self.scale_downs = 0
        self.resizes = 0
        self.actions_failed = 0
        self.standby_ticks = 0
        #: last assessed plane status (freeze-entry incidents fire on
        #: transitions to a WORSE level, once per episode)
        self.plane = PlaneStatus()
        self._collector_registered = False

    # -- wiring -----------------------------------------------------------
    def start(self) -> "FleetController":
        if not self._collector_registered:
            REGISTRY.register_collector(self._collect)
            self._collector_registered = True
        return self

    def stop(self) -> None:
        if self._collector_registered:
            REGISTRY.unregister_collector(self._collect)
            self._collector_registered = False

    def attach(self, pipe, interval_s: float = 1.0) -> "FleetController":
        """Arm the loop on a pipeline's watchdog-sweeper cadence (the
        same slow path the digest publisher rides): no new thread, zero
        per-frame cost."""
        self._pipe = pipe
        pipe.register_sweep(self._sweep, min_poll_s=max(0.05,
                                                        float(interval_s)))
        return self.start()

    def _sweep(self) -> None:
        try:
            self.tick()
        except Exception:  # noqa: BLE001 — the sweeper must survive us
            log.exception("autoscale tick failed")

    # -- the loop ---------------------------------------------------------
    def tick(self) -> List[Action]:
        """One decision step: reap tickets, renew/acquire the lease,
        assess the plane, snapshot, feed the model, plan, dispatch.
        Returns the actions dispatched this tick.  Without the lease
        the tick is a standby heartbeat (reap only); with a degraded
        or blind plane the planner runs but the fail-static ladder
        freezes (and counts) what it would have done."""
        now = self.clock()
        with self._lock:
            self.ticks += 1
            self._reap_locked(now)
            if self.lease is not None and not self.lease.attempt(now):
                # standby: no plan, no actuation — at most one
                # actuating controller by construction
                self.standby_ticks += 1
                return []
            snap = self.observatory.snapshot()
            connected = bool(
                getattr(self.observatory, "plane_connected", True))
            plane = assess_plane(snap, self.policy, self.state,
                                 connected=connected)
            self._note_plane_locked(plane, now)
            self._feed_model(snap)
            actions = plan(snap, self.policy, self.state, now,
                           model=self.model, plane=plane)
            for a in actions:
                self._dispatch_locked(a, now)
            return actions

    def _note_plane_locked(self, plane: PlaneStatus, now: float) -> None:
        """Freeze-entry incident: fire once per degradation episode
        (every transition to a WORSE level), not per frozen impulse —
        the flight recorder's ring then holds the fleet context that
        led INTO the outage, and heals are logged, not dumped."""
        prev = self.plane
        self.plane = plane
        if _PLANE_RANK[plane.level] > _PLANE_RANK[prev.level]:
            detail = (f"plane {prev.level} -> {plane.level}: "
                      f"{','.join(plane.reasons) or 'unknown'}; "
                      "fail-static freeze armed")
            log.warning("autoscale %s", detail)
            if self._recorder is not None:
                self._recorder.dump("autoscale_freeze", "autoscale",
                                    detail=detail, logger=log)
            elif self._pipe is not None:
                self._pipe.incident("autoscale_freeze", "autoscale",
                                    detail)
        elif _PLANE_RANK[plane.level] < _PLANE_RANK[prev.level]:
            log.info("autoscale plane healed: %s -> %s", prev.level,
                     plane.level)

    def _feed_model(self, snap: Dict[str, Any]) -> None:
        roll = snap.get("rollup") or {}
        fresh = _fresh_rows(snap)
        slots = sum(int(r.get("slots", 0) or 0) for r in fresh)
        if not fresh or slots <= 0:
            return
        occupied = sum(int(r.get("occupied", 0) or 0) for r in fresh)
        self.model.add_sample(
            occupied / slots, len(fresh),
            float(roll.get("tokens_per_s", 0.0) or 0.0),
            float(roll.get("ttft_p95_ms", 0.0) or 0.0))

    def _dispatch_locked(self, a: Action, now: float) -> None:
        # fencing: every actuation carries the issuing lease epoch, so
        # a target that already saw a newer leader refuses this one
        epoch = self.lease.epoch if self.lease is not None else 0
        try:
            if a.kind == SCALE_UP:
                ticket = self.actuator.spawn(epoch=epoch)
                self._spawn_seq += 1
                key = f"!spawn:{self._spawn_seq}"
                self.scale_ups += 1
            elif a.kind == SCALE_DOWN:
                ticket = self.actuator.drain(a.target, epoch=epoch)
                key = a.target
                self.scale_downs += 1
            else:
                ticket = self.actuator.resize(a.target, a.slots,
                                              epoch=epoch)
                key = a.target
                self.resizes += 1
        except Exception as e:  # noqa: BLE001 — actuator bug must not kill the loop
            self.actions_failed += 1
            self.recent.append((now, a, f"dispatch-failed: {e}"))
            log.exception("actuator %s failed to dispatch", a.kind)
            self._incident(a, f"dispatch failed: {e}")
            return
        self._inflight[key] = (a, ticket)
        self.state.inflight[key] = a.kind
        self.recent.append((now, a, "dispatched"))
        log.info("autoscale %s %s: %s", a.kind, a.target or "<new>",
                 a.reason)
        self._incident(a, a.reason)

    def _reap_locked(self, now: float) -> None:
        for key, (a, ticket) in list(self._inflight.items()):
            if not ticket.done():
                continue
            self._inflight.pop(key, None)
            self.state.inflight.pop(key, None)
            if ticket.ok:
                self.recent.append((now, a, "ok"))
            else:
                self.actions_failed += 1
                self.recent.append((now, a, f"failed: {ticket.detail}"))
                log.warning("autoscale %s %s failed: %s", a.kind,
                            a.target or "<new>", ticket.detail)
                self._incident(a, f"failed: {ticket.detail}")

    def _incident(self, a: Action, detail: str) -> None:
        """Every scale action is an incident by design: the flight
        recorder's ring holds the fleet context that led to it."""
        msg = f"{a.kind} {a.target or '<new>'}: {detail}"
        if self._recorder is not None:
            self._recorder.dump(f"autoscale_{a.kind}", "autoscale",
                                detail=msg, logger=log)
        elif self._pipe is not None:
            self._pipe.incident(f"autoscale_{a.kind}", "autoscale", msg)

    # -- views ------------------------------------------------------------
    def inflight(self) -> Dict[str, str]:
        with self._lock:
            return dict(self.state.inflight)

    def snapshot(self) -> Dict[str, Any]:
        """The observatory snapshot plus the controller's decision
        block (what a fleet dashboard renders as the decision column)."""
        snap = self.observatory.snapshot()
        with self._lock:
            snap["autoscale"] = {
                "ticks": self.ticks,
                "decisions": self.state.decisions,
                "target_servers": self.state.target_servers,
                "inflight": dict(self.state.inflight),
                "model_samples": len(self.model),
                "model_ready": self.model.ready,
                # control-plane column: plane level + why,
                # leader identity, frozen-impulse count
                "plane_level": self.plane.level,
                "plane_reasons": list(self.plane.reasons),
                "plane_connected": bool(
                    getattr(self.observatory, "plane_connected", True)),
                "frozen": self.state.frozen,
                "standby_ticks": self.standby_ticks,
                "lease": (
                    {"owner": self.lease.owner, "held": self.lease.held,
                     "epoch": self.lease.epoch}
                    if self.lease is not None else None),
                "recent": [
                    {"kind": a.kind, "target": a.target,
                     "reason": a.reason, "status": status,
                     "predictive": a.predictive}
                    for _, a, status in list(self.recent)[-5:]
                ],
            }
        return snap

    # -- registry export (ONE collector; scrape-time only) ----------------
    def _collect(self) -> List[Sample]:
        s = self.state
        lease = self.lease
        vals: Tuple[Tuple[str, float, str], ...] = (
            ("nns.autoscale.ticks", self.ticks, "counter"),
            ("nns.autoscale.decisions", s.decisions, "counter"),
            ("nns.autoscale.scale_ups", self.scale_ups, "counter"),
            ("nns.autoscale.scale_downs", self.scale_downs, "counter"),
            ("nns.autoscale.resizes", self.resizes, "counter"),
            ("nns.autoscale.actions_failed", self.actions_failed,
             "counter"),
            ("nns.autoscale.actions_inflight", len(self._inflight),
             "gauge"),
            ("nns.autoscale.cooldown_skips", s.cooldown_skips, "counter"),
            ("nns.autoscale.hysteresis_holds", s.hysteresis_holds,
             "counter"),
            ("nns.autoscale.envelope_clamps", s.envelope_clamps,
             "counter"),
            ("nns.autoscale.inflight_skips", s.inflight_skips, "counter"),
            ("nns.autoscale.predictive_decisions", s.predictive_decisions,
             "counter"),
            ("nns.autoscale.reactive_decisions", s.reactive_decisions,
             "counter"),
            ("nns.autoscale.model_samples", len(self.model), "gauge"),
            ("nns.autoscale.model_ready",
             1 if self.model.ready else 0, "gauge"),
            ("nns.autoscale.target_servers", s.target_servers, "gauge"),
            # fail-static ladder + leader lease
            ("nns.autoscale.frozen", s.frozen, "counter"),
            ("nns.autoscale.plane_level",
             _PLANE_RANK[self.plane.level], "gauge"),
            ("nns.autoscale.standby_ticks", self.standby_ticks,
             "counter"),
            ("nns.autoscale.lease_held",
             1 if (lease is not None and lease.held) else 0, "gauge"),
            ("nns.autoscale.lease_epoch",
             lease.epoch if lease is not None else 0, "gauge"),
            ("nns.autoscale.lease_acquires",
             lease.acquires if lease is not None else 0, "counter"),
            ("nns.autoscale.lease_steals",
             lease.steals if lease is not None else 0, "counter"),
            ("nns.autoscale.lease_losses",
             lease.losses if lease is not None else 0, "counter"),
            ("nns.autoscale.lease_refusals",
             lease.refusals if lease is not None else 0, "counter"),
        )
        base = {"fleet": getattr(self.observatory, "topic", "") or "all"}
        out: List[Sample] = []
        for mname, v, kind in vals:
            assert mname in METRICS and metric_kind(mname) == kind, mname
            out.append(Sample(mname, dict(base), float(v), kind))
        # reason-labeled freeze breakdown (same catalogued name; the
        # unlabeled total above is the sum across reasons)
        for reason, count in sorted(s.frozen_by_reason.items()):
            out.append(Sample(
                "nns.autoscale.frozen", dict(base, reason=reason),
                float(count), "counter"))
        return out

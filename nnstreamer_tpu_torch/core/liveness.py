"""Liveness primitives: stall watchdog, deadline QoS, admission control,
memory watermarks, and background-thread heartbeats.

Port of ``nnstreamer_tpu/core/liveness.py``.  The query server core
(``distributed/service.py``) admits requests through the admission
controllers here and sheds with :class:`ServerBusyError`; the query client
reads the deadline helpers.  The supervision layer (``core/resilience.py``)
handles elements that *crash*; this module covers the failures that never
raise: an element that silently hangs, a frame that arrives too late to
matter, a server drowning in more in-flight work than it can serve, and
card memory running out.

Design rules (same as resilience.py):

* **Injectable time.**  ``Watchdog`` and the deadline helpers take
  ``clock`` so tests run on a fake clock.
* **Zero hot-path cost when idle.**  Heartbeat pings are two attribute
  stores; the deadline check is one dict lookup on frames that carry no
  deadline.
* **Cooperative interruption.**  A hung call cannot be killed from
  outside (nor can a running CUDA kernel); escalation sets the element's
  interrupt flag and relies on the hung site (an armed ``hang=`` fault,
  an element polling ``Element.interrupted``) to surface
  :class:`StallError`, which the scheduler's restart machinery then
  handles like any transient fault.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from .log import get_logger
from .resilience import RemoteApplicationError, TransientError

log = get_logger("liveness")


class StallError(TransientError):
    """A hung call was interrupted by the liveness layer.

    Subclasses :class:`TransientError`: a stall is exactly the failure
    class a restart can cure, so ``error-policy=restart`` /
    ``stall-policy=restart`` treat it as retryable."""


class ServerBusyError(RemoteApplicationError):
    """The server refused the request at ADMISSION (load shed).

    Subclasses :class:`RemoteApplicationError`: the server answered, so
    breakers/cooldowns must not count it against the remote's health —
    tenant-quota refusals included (one tenant over ITS quota says
    nothing about the server's ability to serve anyone else).
    Admission-refused requests provably never executed, which makes a
    resend safe even under at-most-once delivery — clients retry these
    on a RetryPolicy-paced budget separate from ``retries``.

    ``tenant``/``reason`` identify WHY the shed happened (``"quota"`` =
    the tenant's own quota, ``"priority"`` = priority-class headroom,
    ``"load"`` = the global watermark, ``"memory"`` = the memory
    watermark — the card is near memory exhaustion, so the server sheds
    BEFORE it OOMs): diagnostics only, the client contract is identical
    for all four."""

    def __init__(self, msg: str = "server busy", retry_after: float = 0.05,
                 tenant: str = "", reason: str = "load"):
        super().__init__(msg)
        self.retry_after = float(retry_after)
        self.tenant = tenant
        self.reason = reason

# -- tenant identity --------------------------------------------------------
#: frame.meta key carrying the requesting tenant's name
TENANT_META = "_nns_tenant"
#: frame.meta key carrying the request's priority class, 0..3 (3 =
#: highest); requests without it are priority 3
PRIORITY_META = "_nns_priority"
#: priority classes (inclusive bounds)
PRIORITY_MIN, PRIORITY_MAX = 0, 3


def clamp_priority(p) -> int:
    try:
        p = int(p)
    except (TypeError, ValueError):
        return PRIORITY_MAX
    return max(PRIORITY_MIN, min(PRIORITY_MAX, p))


# ---------------------------------------------------------------------------
# Deadline QoS
# ---------------------------------------------------------------------------
#: frame.meta key holding the absolute expiry instant on the local
#: ``time.monotonic`` clock (process-local: a transport carries a
#: remaining-budget duration instead and re-stamps on arrival)
DEADLINE_META = "deadline_ts"


def stamp_deadline(
    frame: Any,
    budget_s: float,
    clock: Callable[[], float] = time.monotonic,
    anchor: Optional[float] = None,
) -> Any:
    """Stamp ``frame`` with an absolute deadline.

    Wall-anchored (``anchor=None``): expires ``budget_s`` from now —
    the serving contract ("answer within X of ingest").  Pts-anchored
    (``anchor`` = the stream epoch on this clock): expires at
    ``anchor + pts + budget_s`` — the live-playback contract (a frame
    due at pts is worthless ``budget_s`` after its slot)."""
    if anchor is not None and frame.pts is not None:
        frame.meta[DEADLINE_META] = anchor + frame.pts + float(budget_s)
    else:
        frame.meta[DEADLINE_META] = clock() + float(budget_s)
    return frame


def deadline_remaining(
    frame: Any, clock: Callable[[], float] = time.monotonic
) -> Optional[float]:
    """Seconds of budget left (may be negative); None = no deadline.
    Tolerates meta-less payloads (wire batches hand opaque objects
    through the same code paths)."""
    meta = getattr(frame, "meta", None)
    ts = meta.get(DEADLINE_META) if meta is not None else None
    if ts is None:
        return None
    return ts - clock()


def is_expired(
    frame: Any,
    now: Optional[float] = None,
    clock: Callable[[], float] = time.monotonic,
) -> bool:
    """True when the frame's budget is exhausted.

    Boundary contract (pinned by the deadline truth table test): a frame
    is DELIVERED while any budget remains and DROPPED from the instant
    ``now >= deadline`` — zero remaining budget cannot pay for any
    downstream work, so the boundary frame is already late."""
    meta = getattr(frame, "meta", None)
    ts = meta.get(DEADLINE_META) if meta is not None else None
    if ts is None:
        return False
    return (clock() if now is None else now) >= ts


# ---------------------------------------------------------------------------
# Background-thread heartbeats
# ---------------------------------------------------------------------------
class ThreadBeat:
    """Watchdog heartbeat for one NAMED background framework thread
    (slot-engine pump, completion-window reaper, staging-lane worker).

    The owning thread calls :meth:`beat` once per loop iteration —
    lock-free, one clock read + two GIL-atomic stores (the watchdog-ping
    discipline) — and the element-side consumer asks
    :meth:`check_stall` ``(busy=...)`` from its dispatch thread: a
    thread that has WORK (``busy``) but has not beaten for
    ``stall_after_s`` is wedged (stuck inside a device call / C
    extension), which a sticky error can never surface because the
    thread never returns.  ``check_stall`` is edge-triggered — one True
    per stall episode — so the caller can fire a single flight-recorder
    incident instead of a dump storm.  :meth:`snapshot` feeds the
    named-thread census in ``health()``."""

    __slots__ = ("name", "stall_after_s", "_clock", "_last", "beats",
                 "stalls", "_flagged", "_thread")

    def __init__(self, name: str, stall_after_s: float = 5.0,
                 clock: Callable[[], float] = time.monotonic):
        self.name = name
        self.stall_after_s = float(stall_after_s)
        self._clock = clock
        self._last = clock()
        self.beats = 0
        self.stalls = 0
        self._flagged = False
        self._thread: Optional[threading.Thread] = None

    def bind(self, thread: Optional[threading.Thread]) -> None:
        """Attach the live Thread object (liveness census reads
        ``is_alive``)."""
        self._thread = thread

    def beat(self) -> None:
        self._last = self._clock()
        self.beats += 1  # single-writer: the beating thread itself

    def alive(self) -> bool:
        t = self._thread
        return bool(t is not None and t.is_alive())

    def age_s(self) -> float:
        return max(0.0, self._clock() - self._last)

    def check_stall(self, busy: bool) -> bool:
        """True ONCE per stall episode: the thread has pending work but
        has not beaten within ``stall_after_s``.  An idle thread (or a
        beat arriving again) re-arms the edge."""
        if not busy or self.age_s() < self.stall_after_s:
            self._flagged = False
            return False
        if self._flagged:
            return False
        self._flagged = True
        self.stalls += 1
        return True

    def snapshot(self) -> Dict[str, Any]:
        return {
            "alive": self.alive(),
            "age_s": round(self.age_s(), 3),
            "beats": self.beats,
            "stalls": self.stalls,
        }


def thread_census(*beats: Optional["ThreadBeat"]) -> Dict[str, Any]:
    """``health()`` census of an element's background threads: one row
    per :class:`ThreadBeat`, keyed by thread name (Nones skipped)."""
    return {b.name: b.snapshot() for b in beats if b is not None}


# ---------------------------------------------------------------------------
# Watchdog
# ---------------------------------------------------------------------------
class _Watch:
    """Per-element watchdog entry: config + heartbeat + counters."""

    __slots__ = (
        "name", "stall_timeout", "frame_deadline", "policy", "qsize",
        "on_event", "busy_since", "last_progress", "frames_done",
        "stalls", "overruns", "_overrun_flagged", "_last_stall_flag",
    )

    def __init__(self, name, stall_timeout, frame_deadline, policy,
                 qsize, on_event, now):
        self.name = name
        self.stall_timeout = float(stall_timeout)
        self.frame_deadline = float(frame_deadline)
        self.policy = policy
        self.qsize = qsize
        self.on_event = on_event
        self.busy_since: Optional[float] = None
        self.last_progress = now
        self.frames_done = 0
        self.stalls = 0
        self.overruns = 0
        self._overrun_flagged: Optional[float] = None  # busy episode token
        self._last_stall_flag = float("-inf")


def _check_stall_policy(v: str) -> str:
    if v not in ("warn", "restart", "fail"):
        raise ValueError(f"stall-policy {v!r} (want warn | restart | fail)")
    return v


class Watchdog:
    """Per-element heartbeat registry + stall/overrun monitor.

    The scheduler pings :meth:`begin`/:meth:`done` around every frame
    call; :meth:`check` sweeps the registry and fires ``on_event(watch,
    kind, elapsed)`` for each finding:

    * ``"overrun"`` — a single call has been running longer than
      ``frame_deadline`` (the hung-``handle_frame`` case; flagged once
      per busy episode).
    * ``"stall"`` — work is pending (input queued, or a call in flight)
      but nothing has COMPLETED for ``stall_timeout``: covers both a
      hang inside a call and a worker wedged outside processing (e.g.
      blocked pushing downstream).  Re-flagged every ``stall_timeout``;
      an in-call hang that also overruns is reported as the overrun in
      that sweep (overrun wins the tie, once per episode).

    Passive by design: no thread of its own.  The pipeline polls
    :meth:`check` from a sweeper thread; tests call it directly on a
    fake clock.  Pings are lock-free (two attribute stores on the GIL —
    a torn read in the sweeper costs one late/spurious finding, never a
    crash), registration is locked."""

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self._lock = threading.Lock()
        self._watches: Dict[str, _Watch] = {}

    def register(
        self,
        name: str,
        stall_timeout: float = 0.0,
        frame_deadline: float = 0.0,
        policy: str = "warn",
        qsize: Callable[[], int] = lambda: 0,
        on_event: Optional[Callable[[_Watch, str, float], None]] = None,
    ) -> _Watch:
        w = _Watch(name, stall_timeout, frame_deadline,
                   _check_stall_policy(policy), qsize, on_event,
                   self._clock())
        with self._lock:
            self._watches[name] = w
        return w

    def unregister(self, name: str) -> None:
        with self._lock:
            self._watches.pop(name, None)

    def watch(self, name: str) -> Optional[_Watch]:
        with self._lock:
            return self._watches.get(name)

    # -- heartbeat pings (hot path: no lock) --------------------------------
    def begin(self, w: Optional[_Watch]) -> None:
        if w is not None:
            w.busy_since = self._clock()

    def done(self, w: Optional[_Watch]) -> None:
        if w is not None:
            w.busy_since = None
            w.last_progress = self._clock()
            w.frames_done += 1
            w._overrun_flagged = None

    # -- monitor -------------------------------------------------------------
    def min_interval(self) -> float:
        """Suggested poll period: a quarter of the tightest armed bound."""
        with self._lock:
            bounds = [
                b for w in self._watches.values()
                for b in (w.stall_timeout, w.frame_deadline) if b > 0
            ]
        if not bounds:
            return 0.5
        return min(0.5, max(0.01, min(bounds) / 4.0))

    def check(self, now: Optional[float] = None) -> List[Tuple[str, str, float]]:
        """One sweep; returns ``[(element, kind, elapsed_s), ...]`` and
        fires each watch's ``on_event`` callback."""
        now = self._clock() if now is None else now
        with self._lock:
            watches = list(self._watches.values())
        findings: List[Tuple[str, str, float]] = []
        for w in watches:
            busy = w.busy_since
            if (busy is not None and w.frame_deadline > 0
                    and now - busy >= w.frame_deadline
                    and w._overrun_flagged != busy):
                w._overrun_flagged = busy  # once per episode
                w.overruns += 1
                findings.append((w.name, "overrun", now - busy))
                self._fire(w, "overrun", now - busy)
            elif (w.stall_timeout > 0
                    and now - w.last_progress >= w.stall_timeout
                    and now - w._last_stall_flag >= w.stall_timeout):
                # pending work = queued input OR a call in flight — an
                # element hung INSIDE handle_frame must be detectable by
                # stall-timeout alone (frame-deadline is the per-call
                # refinement, not a prerequisite)
                if busy is not None:
                    pending = 1
                else:
                    try:
                        pending = w.qsize()
                    except Exception:  # allow-silent: mailbox mid-teardown
                        pending = 0
                if pending > 0:
                    w._last_stall_flag = now
                    w.stalls += 1
                    elapsed = now - w.last_progress
                    findings.append((w.name, "stall", elapsed))
                    self._fire(w, "stall", elapsed)
        return findings

    def _fire(self, w: _Watch, kind: str, elapsed: float) -> None:
        log.warning(
            "watchdog: %s %s for %.3fs (policy=%s)",
            w.name, kind, elapsed, w.policy,
        )
        if w.on_event is not None:
            try:
                w.on_event(w, kind, elapsed)
            except Exception:
                log.exception("watchdog escalation for %s failed", w.name)

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            watches = list(self._watches.values())
        return {
            w.name: {
                "busy": w.busy_since is not None,
                "frames_done": w.frames_done,
                "stalls": w.stalls,
                "overruns": w.overruns,
            }
            for w in watches
        }


# ---------------------------------------------------------------------------
# Memory-pressure watermark monitor
# ---------------------------------------------------------------------------
def host_rss_bytes() -> int:
    """Resident set size of THIS process (bytes), from /proc (Linux) —
    no psutil dependency; 0 where unreadable."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        return 0


def host_total_bytes() -> int:
    """Total physical memory of the host (bytes); 0 where unreadable.
    The default denominator of the host-RSS watermark fallback, so the
    monitor stays meaningful on platforms whose devices report no
    ``memory_stats()`` (CPU) without any explicit limit configured."""
    try:
        return os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError):
        return 0


def device_memory_sample() -> Tuple[int, int, int]:
    """``(bytes_in_use, bytes_limit, host_rss)`` for the most-loaded
    visible CUDA card (the fraction that matters is the worst card's).

    ``bytes_in_use`` is ``torch.cuda.memory_reserved(d)``: the bytes the
    caching allocator holds from the driver (allocated tensors plus its
    free cached blocks), which is what another allocation competes with.
    ``bytes_limit`` is the card's total memory
    (``torch.cuda.get_device_properties(d).total_memory``) times the
    per-process fraction cap that ``torch.cuda.set_per_process_memory_fraction``
    set (1.0 when never set), i.e. the point where the allocator raises
    ``OutOfMemoryError``.

    Reads torch's CUDA state ONLY when this process already initialised
    CUDA (``torch.cuda.is_initialized()``): the monitor must never be the
    reason a CUDA context is created.  Without one it reports
    ``(0, 0, rss)`` and the monitor falls back to the host-RSS
    watermark."""
    import sys

    in_use = limit = 0
    torch = sys.modules.get("torch")
    if torch is not None:
        try:
            if torch.cuda.is_initialized():
                best = -1.0
                for d in range(torch.cuda.device_count()):
                    total = int(torch.cuda.get_device_properties(d).total_memory)
                    frac_cap = _memory_fraction(torch, d)
                    bl = int(total * frac_cap)
                    bi = int(torch.cuda.memory_reserved(d))
                    frac = (bi / bl) if bl else 0.0
                    if frac > best:
                        best, in_use, limit = frac, bi, bl
        except Exception:  # allow-silent: a stats probe must never fault serving
            in_use = limit = 0
    return in_use, limit, host_rss_bytes()


def _memory_fraction(torch, device: int) -> float:
    """The per-process memory fraction cap of ``device`` (1.0 when none
    was set); ``torch.cuda.get_per_process_memory_fraction`` where this
    torch has it."""
    get = getattr(torch.cuda, "get_per_process_memory_fraction", None)
    if get is None:
        return 1.0
    try:
        return float(get(device))
    except Exception:  # allow-silent: older torch / no allocator yet
        return 1.0


class MemoryPressureMonitor:
    """High/low-watermark card-memory + host-RSS pressure signal (the "shed
    BUSY *before* the card OOMs" piece of the degrade-don't-die ladder).

    Polled from slow cadences only — the watchdog sweeper thread and the
    serversrc's idle request-pump tick — never from a per-frame path:
    :meth:`poll` is internally rate-limited to ``min_poll_s`` and the
    hot-path read is the plain :attr:`pressured` attribute (one bool).

    State machine (hysteresis, the admission-controller discipline):
    the watermark FRACTION (device ``bytes_in_use/bytes_limit`` when the
    platform reports it, else host RSS over ``host_limit_bytes``,
    itself defaulting to the host's physical RAM so an armed watermark
    is never silently inert) crossing ``high`` enters pressure; it
    persists until the
    fraction falls back to ``low``.  Entering pressure fires the
    ``trim_hooks`` (the generators' cold prefix entries, the backends'
    allocator caches, and the host staging pools while the fraction is
    host memory — memory the process can recreate; each returns the
    entries it freed); pressure SUSTAINED for
    ``sustain_s`` fires ``on_pressure(snapshot)`` once per
    ``incident_interval_s`` (``Pipeline.enable_memory_monitor`` routes it
    into ``Pipeline.incident``, which dumps the flight recorder).

    ``sample``/``clock`` are injectable — tier-1 drives the whole ladder
    on fake samples with a fake clock."""

    def __init__(self, high: float = 0.90, low: float = 0.75,
                 sustain_s: float = 2.0, min_poll_s: float = 0.25,
                 incident_interval_s: float = 30.0,
                 host_limit_bytes: int = 0,
                 sample: Callable[[], Tuple[int, int, int]] = device_memory_sample,
                 clock: Callable[[], float] = time.monotonic,
                 on_pressure: Optional[Callable[[Dict[str, Any]], None]] = None,
                 trim_hooks: Tuple[Callable[[], int], ...] = ()):
        if not 0.0 <= low <= high:
            raise ValueError(
                f"memory watermarks low={low} high={high} "
                "(want 0 <= low <= high)")
        self.high = float(high)
        self.low = float(low)
        self.sustain_s = float(sustain_s)
        self.min_poll_s = float(min_poll_s)
        self.incident_interval_s = float(incident_interval_s)
        self.host_limit_bytes = int(host_limit_bytes)
        self._sample = sample
        self._clock = clock
        self.on_pressure = on_pressure
        self.trim_hooks: List[Callable[[], int]] = list(trim_hooks)
        #: the hot-path signal: one GIL-atomic bool read (admission)
        self.pressured = False
        self._pressured_since: Optional[float] = None
        self._last_poll = float("-inf")
        self._last_incident = float("-inf")
        # last sample (scrape-time gauges)
        self.bytes_in_use = 0
        self.bytes_limit = 0
        self.host_rss = 0
        self.fraction = 0.0
        # exact accounting
        self.polls = 0
        self.trims = 0           # trim-hook sweeps fired
        self.trimmed_entries = 0  # entries the hooks reported freeing
        self.incidents = 0

    def add_trim_hook(self, hook: Callable[[], int]) -> None:
        self.trim_hooks.append(hook)

    def _fraction(self) -> float:
        if self.bytes_limit > 0:
            return self.bytes_in_use / self.bytes_limit
        if self.host_limit_bytes > 0:
            return self.host_rss / self.host_limit_bytes
        # stats-less platform, no explicit limit: RSS over physical RAM
        # (never silently inert — an armed watermark must watch SOMETHING)
        total = host_total_bytes()
        if total > 0:
            return self.host_rss / total
        return 0.0

    def poll(self, now: Optional[float] = None) -> bool:
        """One watermark evaluation (rate-limited; safe from any slow
        cadence).  Returns the post-poll :attr:`pressured` state."""
        now = self._clock() if now is None else now
        if now - self._last_poll < self.min_poll_s:
            return self.pressured
        self._last_poll = now
        self.polls += 1
        self.bytes_in_use, self.bytes_limit, self.host_rss = self._sample()
        self.fraction = self._fraction()
        if not self.pressured:
            if self.fraction >= self.high:
                self.pressured = True
                self._pressured_since = now
                self._trim()
                log.warning(
                    "memory pressure ENTERED: fraction %.3f >= high %.3f "
                    "(in_use=%d limit=%d rss=%d)", self.fraction,
                    self.high, self.bytes_in_use, self.bytes_limit,
                    self.host_rss)
        elif self.fraction <= self.low:
            self.pressured = False
            self._pressured_since = None
            log.info("memory pressure cleared: fraction %.3f <= low %.3f",
                     self.fraction, self.low)
        if (self.pressured and self._pressured_since is not None
                and now - self._pressured_since >= self.sustain_s
                and now - self._last_incident >= self.incident_interval_s):
            self._last_incident = now
            self.incidents += 1
            if self.on_pressure is not None:
                try:
                    self.on_pressure(self.snapshot())
                except Exception:
                    log.exception("on_pressure hook failed")
        return self.pressured

    def _trim(self) -> None:
        freed = 0
        for hook in self.trim_hooks:
            try:
                freed += int(hook() or 0)
            except Exception:
                log.exception("memory trim hook failed")
        self.trims += 1
        self.trimmed_entries += freed
        if freed:
            log.info("memory pressure: trimmed %d pooled/cached entries",
                     freed)

    def snapshot(self) -> Dict[str, Any]:
        """``mem_*`` health keys (exported as ``nns.mem.*`` gauges via
        the health collector)."""
        return {
            "mem_bytes_in_use": int(self.bytes_in_use),
            "mem_bytes_limit": int(self.bytes_limit),
            "mem_host_rss": int(self.host_rss),
            "mem_fraction": round(float(self.fraction), 4),
            "mem_pressure": 1 if self.pressured else 0,
            "mem_polls": int(self.polls),
            "mem_trims": int(self.trims),
            "mem_trimmed_entries": int(self.trimmed_entries),
            "mem_incidents": int(self.incidents),
        }


# ---------------------------------------------------------------------------
# Admission control
# ---------------------------------------------------------------------------
class AdmissionController:
    """Bounded in-flight slots with high/low watermark hysteresis.

    ``try_admit`` refuses once ``high`` requests are in flight and keeps
    refusing until the backlog drains to ``low`` — the hysteresis band
    prevents admit/refuse flapping right at the limit (reference analog:
    GstQueue's high/low watermark signals).  ``high <= 0`` = unlimited
    (admission disabled; counters still track in-flight).

    Thread-safe; refusals are O(1) and allocation-free — the overload
    path must be the cheapest path in the server."""

    def __init__(self, high: int = 0, low: Optional[int] = None):
        self.high = int(high)
        if self.high > 0:
            # default low = high//2; an explicit 0 is legal and honored
            # (drain fully before re-admitting — the only choice when
            # high is 1)
            self.low = self.high // 2 if low is None else int(low)
            if not 0 <= self.low < self.high:
                # a negative low could never clear the shedding band:
                # the first overload would brick the server into BUSY
                raise ValueError(
                    f"low watermark {self.low} must be in [0, "
                    f"high={self.high})"
                )
        else:
            self.low = 0
        self._lock = threading.Lock()
        self._inflight = 0
        self._shedding = False
        self.admitted = 0
        self.shed = 0

    def try_admit(self, n: int = 1) -> bool:
        with self._lock:
            if self.high > 0:
                if self._shedding and self._inflight > self.low:
                    self.shed += n
                    return False
                if self._inflight + n > self.high:
                    self._shedding = True
                    self.shed += n
                    return False
                self._shedding = False
            self._inflight += n
            self.admitted += n
            return True

    def release(self, n: int = 1) -> None:
        with self._lock:
            self._inflight = max(0, self._inflight - n)
            if self._shedding and self._inflight <= self.low:
                self._shedding = False

    @property
    def inflight(self) -> int:
        with self._lock:
            return self._inflight

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "inflight": self._inflight,
                "high": self.high,
                "low": self.low,
                "shedding": self._shedding,
                "admitted": self.admitted,
                "shed": self.shed,
            }


class TenantAdmissionController(AdmissionController):
    """Per-tenant quotas and priority classes layered on the watermark
    admission controller — the "one hot tenant must shed before
    starving the fleet" piece of fleet overload resilience.

    Check order (the shed truth table, pinned by tests):

    1. **Tenant quota** (``reason="quota"``): a named tenant may hold at
       most ``quota`` in-flight slots (per-tenant override in
       ``quotas``, else ``default_quota``; 0 = unlimited; unnamed
       requests are never quota-checked).  The refusal is weighted
       per-tenant: ``retry_after`` grows with the tenant's consecutive
       shed streak (capped 8x) so a tenant hammering its quota is paced
       harder than one that just grazed it, and an admit resets the
       pacing.
    2. **Priority headroom** (``reason="priority"``): with a global
       ``high`` watermark armed, priority class ``p`` (0..3) may only
       fill ``ceil(high * (p+1) / 4)`` slots — low-priority work hits
       its ceiling first, so under pressure it sheds while priority-3
       traffic still has headroom.  Requests without a priority class
       are priority 3: the exact pre-tenancy admission semantics.
    3. **Global watermark** (``reason="load"``): the inherited
       high/low-hysteresis band, applied to everything.

    All three refusals surface as :class:`ServerBusyError` — answered
    instantly at admission, provably never executed, breaker-immune.

    **Sustained-shed incidents**: a tenant whose QUOTA sheds persist
    beyond ``shed_window_s`` without a single admit fires
    ``on_sustained_shed(tenant)`` (rate-limited to once per window per
    tenant) — the serversrc routes it into the pipeline's flight
    recorder so "who is drowning this server" is answerable without a
    repro.

    Single-lock design: quota, priority, and watermark accounting
    update atomically, so per-tenant ``admitted/shed/inflight`` counts
    are exact even under concurrent admission (the acceptance contract
    of the fleet chaos e2e)."""

    def __init__(self, high: int = 0, low: Optional[int] = None,
                 default_quota: int = 0,
                 quotas: Optional[Dict[str, int]] = None,
                 shed_window_s: float = 5.0,
                 on_sustained_shed: Optional[Callable[[str], None]] = None,
                 clock: Callable[[], float] = time.monotonic):
        super().__init__(high, low)
        self.default_quota = max(0, int(default_quota))
        self.quotas: Dict[str, int] = {
            str(k): max(0, int(v)) for k, v in (quotas or {}).items()
        }
        self.shed_window_s = float(shed_window_s)
        self.on_sustained_shed = on_sustained_shed
        self._clock = clock
        # priority-class admission ceilings (high > 0 only); p=3 equals
        # `high` so the top class is governed by the watermark alone
        if self.high > 0:
            self._pri_high = [
                -(-self.high * (p + 1) // 4) for p in range(4)
            ]
        else:
            self._pri_high = None
        # memory-watermark coupling (MemoryPressureMonitor): when set
        # and True, every admission sheds with reason="memory" — the
        # server refuses work BEFORE the card OOMs.  One attribute read
        # + (armed only) one bool call per admission; breaker-immune
        # like every other shed.
        self.pressure: Optional[Callable[[], bool]] = None
        self.memory_shed = 0
        # LRU-ordered so the bound below can evict the LEAST-recently
        # active idle tenant: the tenant name comes straight off the
        # wire (client-controlled), so an unbounded dict would let a
        # hostile peer grow server memory and metric cardinality forever
        self._tenants: "Dict[str, Dict[str, Any]]" = {}
        self.tenants_evicted = 0

    #: cap on the streak-scaled retry-after multiplier (quota sheds)
    RETRY_AFTER_CAP = 8.0
    #: max tracked tenant ledgers; idle (inflight == 0) least-recently
    #: active entries are evicted beyond this (their admitted/shed
    #: history stays in the aggregate counters; `tenants_evicted`
    #: counts the dropped rows so truncation is never silent)
    TENANT_MAP_MAX = 1024

    def quota_for(self, tenant: str) -> int:
        """The in-flight quota governing ``tenant`` (0 = unlimited;
        unnamed tenants are never quota-bound)."""
        if not tenant:
            return 0
        return self.quotas.get(tenant, self.default_quota)

    def _tenant_entry(self, tenant: str) -> Dict[str, Any]:
        t = self._tenants.get(tenant)
        if t is None:
            if len(self._tenants) >= self.TENANT_MAP_MAX:
                # evict the least-recently ACTIVE idle ledger (dicts
                # iterate in insertion order; _touch re-inserts on every
                # admit/shed, so iteration order IS activity order) —
                # in-flight tenants are never evicted, their release
                # accounting must find them
                for name, row in self._tenants.items():
                    if row["inflight"] == 0:
                        del self._tenants[name]
                        self.tenants_evicted += 1
                        break
            t = {
                "inflight": 0, "admitted": 0, "shed": 0,
                "streak": 0, "shed_since": None,
                "last_incident": float("-inf"),
            }
            self._tenants[tenant] = t
        return t

    def _touch(self, tenant: str, t: Dict[str, Any]) -> None:
        """Move the ledger to the back of the activity order (cheap
        LRU: delete + re-insert on the plain dict)."""
        if next(reversed(self._tenants), None) != tenant:
            del self._tenants[tenant]
            self._tenants[tenant] = t

    def admit(self, n: int = 1, tenant: str = "",
              priority: int = PRIORITY_MAX,
              retry_after: float = 0.05) -> None:
        """Admit ``n`` slots for ``tenant`` at ``priority`` or raise
        :class:`ServerBusyError` carrying the per-tenant retry-after.
        Pair every successful call with :meth:`release`."""
        tenant = str(tenant or "")
        p = clamp_priority(priority)
        fire: Optional[str] = None
        err: Optional[ServerBusyError] = None
        with self._lock:
            t = self._tenant_entry(tenant)
            quota = self.quota_for(tenant)
            reason = None
            if quota > 0 and t["inflight"] + n > quota:
                reason = "quota"
            elif self.pressure is not None and self.pressure():
                # memory watermark: shed EVERYTHING (all tenants, all
                # priority classes) — card-memory exhaustion takes the whole
                # card down, so no class has headroom against it
                reason = "memory"
                self.memory_shed += n
            elif self._pri_high is not None:
                # base watermark semantics first (identical to
                # AdmissionController for priority 3), then the
                # priority-class ceiling — a hard threshold with no
                # hysteresis of its own (the global band supplies that)
                if self._shedding and self._inflight > self.low:
                    reason = "load"
                elif self._inflight + n > self.high:
                    self._shedding = True
                    reason = "load"
                elif (p < PRIORITY_MAX
                        and self._inflight + n > self._pri_high[p]):
                    reason = "priority"
                else:
                    self._shedding = False
            if reason is None:
                t["inflight"] += n
                t["admitted"] += n
                t["streak"] = 0
                t["shed_since"] = None
                self._inflight += n
                self.admitted += n
                self._touch(tenant, t)
            else:
                t["shed"] += n
                self.shed += n
                self._touch(tenant, t)
                pace = float(retry_after)
                if reason == "quota":
                    # streak-scaled pacing is a QUOTA property: a tenant
                    # hammering its own quota backs off harder.  Global
                    # load/priority sheds keep the flat pre-tenancy
                    # retry-after — otherwise unnamed clients sharing
                    # the "" ledger would couple each other's pacing
                    t["streak"] += 1
                    pace *= min(self.RETRY_AFTER_CAP, float(t["streak"]))
                    now = self._clock()
                    if t["shed_since"] is None:
                        t["shed_since"] = now
                    elif (now - t["shed_since"] >= self.shed_window_s
                            and now - t["last_incident"]
                            >= self.shed_window_s):
                        t["last_incident"] = now
                        fire = tenant
                err = ServerBusyError(
                    f"server busy ({reason}"
                    + (f", tenant={tenant}" if tenant else "") + ")",
                    retry_after=pace, tenant=tenant, reason=reason,
                )
        if fire is not None and self.on_sustained_shed is not None:
            try:
                self.on_sustained_shed(fire)
            except Exception:  # accounting hook must never break admission
                log.exception("on_sustained_shed(%r) failed", fire)
        if err is not None:
            raise err

    def release(self, n: int = 1, tenant: str = "") -> None:
        tenant = str(tenant or "")
        with self._lock:
            self._inflight = max(0, self._inflight - n)
            if self._shedding and self._inflight <= self.low:
                self._shedding = False
            t = self._tenants.get(tenant)
            if t is not None:
                t["inflight"] = max(0, t["inflight"] - n)

    def tenant_snapshot(self) -> Dict[str, Dict[str, Any]]:
        """Exact per-tenant accounting for health()/metrics: {tenant:
        {inflight, admitted, shed, quota}}."""
        with self._lock:
            return {
                name: {
                    "inflight": t["inflight"],
                    "admitted": t["admitted"],
                    "shed": t["shed"],
                    "quota": self.quota_for(name),
                }
                for name, t in self._tenants.items()
            }

    def snapshot(self) -> Dict[str, Any]:
        snap = super().snapshot()
        snap["tenants"] = self.tenant_snapshot()
        snap["tenants_evicted"] = self.tenants_evicted
        snap["memory_shed"] = self.memory_shed
        return snap


def parse_tenant_quotas(raw: str, owner: str = "") -> Dict[str, int]:
    """Parse a ``"tenantA:8,tenantB:4"`` property value into a quota
    dict (shared by the serversrc prop and the chaos harness)."""
    out: Dict[str, int] = {}
    for part in (raw or "").split(","):
        part = part.strip()
        if not part:
            continue
        name, sep, q = part.rpartition(":")
        if not sep or not name or not q.lstrip("-").isdigit() or int(q) < 0:
            raise ValueError(
                f"{owner or 'tenant-quotas'}: bad entry {part!r} "
                "(want tenant:quota, quota >= 0)")
        out[name] = int(q)
    return out

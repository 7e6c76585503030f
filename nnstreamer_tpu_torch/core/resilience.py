"""Resilience primitives: retry policies, circuit breakers, error
classification, and deterministic fault injection.

Port of ``nnstreamer_tpu/core/resilience.py``.  The pipeline supervisor
(``pipeline/pipeline.py``), the filter's OOM and device-loss ladder
(``elements/filter.py``), the slot engine (``core/slots.py``) and the
query transports and client (``distributed/``, ``elements/query.py``,
ROADMAP A13.1) share these primitives.

Design rules:

* **Injectable time.** Every time-dependent class takes ``clock`` (and
  ``sleep`` where it blocks) so tests run on a fake clock.
* **Deterministic jitter.** Jitter comes from a seedable
  ``random.Random``, never the process-global RNG.
* **Zero hot-path cost when idle.** ``FaultInjector.check`` is a plain
  dict lookup guarded by one bool; un-armed sites cost ~nothing.

Device errors are classified from torch's exceptions, not XLA's:
``torch.cuda.OutOfMemoryError`` and the allocation failures that cuBLAS,
cuDNN and the port's own kernels report as ``RuntimeError`` text become
:class:`DeviceOomError`; the sticky CUDA context errors (an illegal
memory access, an unspecified launch failure, ...) become
:class:`DeviceLostError`.  The marker strings are pinned by
``tests/test_torch_resilience.py``.
"""

from __future__ import annotations

import random
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple, Type

import torch

from .log import get_logger

log = get_logger("resilience")


# ---------------------------------------------------------------------------
# Transient-vs-fatal error classification
# ---------------------------------------------------------------------------
# Transient: the operation may succeed if simply re-tried (network blips,
# timeouts, resource exhaustion).  Fatal: retrying cannot help (bad
# arguments, schema mismatches, programming errors): retry loops must
# fail fast instead of burning their deadline budget on them.
_TRANSIENT_TYPES: Tuple[Type[BaseException], ...] = (
    ConnectionError,
    TimeoutError,
    InterruptedError,
    BrokenPipeError,
    OSError,  # includes socket.timeout/socket.error
)
_FATAL_TYPES: Tuple[Type[BaseException], ...] = (
    TypeError,
    ValueError,
    KeyError,
    IndexError,
    AttributeError,
    NotImplementedError,
)


class TransientError(RuntimeError):
    """Raise (or wrap with) this to force transient classification."""


class FatalError(RuntimeError):
    """Raise (or wrap with) this to force fatal classification."""


class DeviceOomError(TransientError):
    """The card ran out of memory (``torch.cuda.OutOfMemoryError`` or a
    library's failed allocation).

    Transient by design: the call may succeed on a smaller batch bucket
    or after the caching allocator's free blocks were released: the
    filter's shrink-retry and the slot engine's slot shed both cure it
    without a restart.  Carries no device identity: the card is still
    there, just full."""


class DeviceLostError(TransientError):
    """The card's CUDA context is gone (a sticky error such as an illegal
    memory access, or the device fell off the bus).

    Transient at the serving level (an element restart that re-picks
    devices cures it when another card is left) but never curable by a
    plain same-device retry: a sticky context error poisons every later
    call of this process on that card.  ``device_ids`` names the lost
    ordinals when known (an injected fault names them); empty means "one
    unidentified card"."""

    def __init__(self, msg: str = "device lost", device_ids=()):
        super().__init__(msg)
        self.device_ids = tuple(device_ids)


#: the text torch and the CUDA libraries put in an error they raise as a
#: plain ``RuntimeError`` (``torch.cuda.OutOfMemoryError`` is typed and
#: needs none): a message is a device error only when it names CUDA or
#: one of its libraries (``_CUDA_CONTEXT``) AND carries a marker
_CUDA_CONTEXT = ("CUDA", "cuda", "CUBLAS", "cuBLAS", "CUDNN", "cuDNN")
_OOM_MARKERS = (
    "out of memory",               # cudaErrorMemoryAllocation's text
    "CUBLAS_STATUS_ALLOC_FAILED",  # cuBLAS handle or workspace allocation
    "CUDNN_STATUS_ALLOC_FAILED",   # cuDNN workspace allocation
    "cudaErrorMemoryAllocation",
)
_LOST_MARKERS = (
    "an illegal memory access was encountered",  # cudaErrorIllegalAddress
    "unspecified launch failure",                # cudaErrorLaunchFailure
    "misaligned address",                        # cudaErrorMisalignedAddress
    "an illegal instruction was encountered",    # cudaErrorIllegalInstruction
    "device-side assert triggered",              # cudaErrorAssert
    "the launch timed out and was terminated",   # cudaErrorLaunchTimeout
    "uncorrectable ECC error encountered",       # cudaErrorECCUncorrectable
    "hardware stack error",                      # cudaErrorHardwareStackError
    "GPU is lost",
    "device not ready",
    "all CUDA-capable devices are busy or unavailable",
    "no CUDA-capable device is detected",
)


def classify_device_error(err: BaseException):
    """Map a raw torch/CUDA exception to the typed device-error taxonomy:
    returns a :class:`DeviceOomError` / :class:`DeviceLostError` (the
    original as ``__cause__``) or ``None`` when the error is not a
    device-resource failure.  Already-typed errors pass through.  The
    single classification point for every invoke path (the torch-cuda
    backend, the feed's copies, the slot-engine pump)."""
    if isinstance(err, (DeviceOomError, DeviceLostError)):
        return err
    msg = str(err)
    if isinstance(err, torch.cuda.OutOfMemoryError):
        out = DeviceOomError(f"device OOM: {msg[:400]}")
        out.__cause__ = err
        return out
    if not isinstance(err, RuntimeError) or not any(c in msg for c in _CUDA_CONTEXT):
        return None
    if any(m in msg for m in _OOM_MARKERS):
        out = DeviceOomError(f"device OOM: {msg[:400]}")
        out.__cause__ = err
        return out
    if any(m in msg for m in _LOST_MARKERS):
        out = DeviceLostError(f"device lost: {msg[:400]}")
        out.__cause__ = err
        return out
    return None


def device_call(fn, *args, inject=True):
    """THE classification boundary around a raw device call (shared by
    the torch-cuda backend and the slot-engine pump, so the two cannot
    drift): fires the deterministic ``device.oom`` / ``device.lost`` fault
    sites where the real card would fail, maps raw errors through
    :func:`classify_device_error`, and re-raises everything else
    untouched.  ``inject=False`` keeps the typed classification but skips
    the fault sites: the copy paths use it, so an armed site fires at
    model-call boundaries only, while a REAL copy-time OOM still surfaces
    typed."""
    try:
        if inject and FAULTS.is_armed():
            FAULTS.check("device.oom")
            FAULTS.check("device.lost")
        return fn(*args)
    except (KeyboardInterrupt, SystemExit):
        raise
    except BaseException as e:  # noqa: BLE001 — classification boundary
        typed = classify_device_error(e)
        if typed is None or typed is e:
            raise
        try:
            raise typed from e
        finally:
            # this frame's `typed` and the traceback through this frame
            # form a cycle that only the cyclic collector frees, and
            # `typed.__cause__` keeps the failed call's frames, so its card
            # tensors would outlive the caller's retry
            typed = None


class RemoteApplicationError(RuntimeError):
    """The remote ANSWERED, with an application-level error reply.

    The round trip itself succeeded, so this must never count against
    the remote's health (circuit breakers, down-cooldowns): a stream of
    poison frames must not trip a breaker open against a healthy
    server."""


def is_remote_application_error(err: BaseException) -> bool:
    """True when the failure is an application-level reply from a live
    server (transport worked), as opposed to a connectivity/timeout
    fault.  Health machinery (breakers, cooldowns) must ignore these.
    A gRPC status is read only where ``grpc`` is already loaded (the
    query client's gRPC transport imports it; the card machine has none)."""
    if isinstance(err, RemoteApplicationError):
        return True
    grpc = sys.modules.get("grpc")
    if grpc is not None and isinstance(err, grpc.RpcError):
        code = getattr(err, "code", lambda: None)()
        # a status the server DECIDED to send is not a dead server, except
        # DATA_LOSS: sustained corruption must be able to trip breakers
        return code not in (
            None,
            grpc.StatusCode.UNAVAILABLE,
            grpc.StatusCode.DEADLINE_EXCEEDED,
            grpc.StatusCode.CANCELLED,
            grpc.StatusCode.DATA_LOSS,
        )
    return False


def register_transient(*types: Type[BaseException]) -> None:
    """Extend the transient set (e.g. a transport's own error type)."""
    global _TRANSIENT_TYPES
    _TRANSIENT_TYPES = _TRANSIENT_TYPES + tuple(types)


def register_fatal(*types: Type[BaseException]) -> None:
    global _FATAL_TYPES
    _FATAL_TYPES = _FATAL_TYPES + tuple(types)


def is_transient(err: BaseException) -> bool:
    """Best-effort classification; unknown exception types default to
    transient (an always-on pipeline prefers one wasted retry over a
    dropped stream), except the known-fatal program-error set."""
    if not isinstance(err, Exception):
        return False  # KeyboardInterrupt/SystemExit/GeneratorExit: never retry
    if isinstance(err, FatalError):
        return False
    if isinstance(err, TransientError):
        return True
    # explicit marker wins over the type tables (a transport can stamp
    # an exception it re-raises without subclassing)
    marked = getattr(err, "nns_transient", None)
    if marked is not None:
        return bool(marked)
    if isinstance(err, _FATAL_TYPES):
        return False
    if isinstance(err, _TRANSIENT_TYPES):
        return True
    return True


# ---------------------------------------------------------------------------
# RetryPolicy
# ---------------------------------------------------------------------------
@dataclass
class RetryPolicy:
    """Exponential backoff with jitter under a total deadline budget.

    ``max_attempts`` bounds tries (first call included); ``deadline_s``
    bounds the *total* wall time spent inside :meth:`call` — a retry
    whose backoff would overrun the budget is not taken.  ``jitter`` is
    the +/- fraction applied to each delay (0.25 = 25%), drawn from a
    seedable RNG for reproducible tests.
    """

    max_attempts: int = 3
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    multiplier: float = 2.0
    jitter: float = 0.25
    deadline_s: Optional[float] = None
    classify: Callable[[BaseException], bool] = field(default=is_transient)
    seed: Optional[int] = None

    def __post_init__(self):
        self._rng = random.Random(self.seed)

    def delay_for(self, attempt: int) -> float:
        """Backoff before retry #`attempt` (1-based: after the first
        failure attempt=1)."""
        raw = min(
            self.max_delay_s,
            self.base_delay_s * (self.multiplier ** max(0, attempt - 1)),
        )
        if self.jitter:
            raw *= 1.0 + self.jitter * (2.0 * self._rng.random() - 1.0)
        return max(0.0, raw)

    def call(
        self,
        fn: Callable[..., Any],
        *args: Any,
        on_retry: Optional[Callable[[int, BaseException, float], None]] = None,
        sleep: Callable[[float], None] = time.sleep,
        clock: Callable[[], float] = time.monotonic,
        **kwargs: Any,
    ) -> Any:
        """Run ``fn`` under this policy.  ``on_retry(attempt, err,
        delay)`` fires before each backoff; fatal errors and budget
        exhaustion re-raise the last error immediately."""
        start = clock()
        attempt = 0
        while True:
            try:
                return fn(*args, **kwargs)
            except (KeyboardInterrupt, SystemExit, GeneratorExit):
                raise  # interrupts must never be absorbed into a retry
            except BaseException as e:  # noqa: BLE001 — policy boundary
                attempt += 1
                if not self.classify(e):
                    raise
                if attempt >= self.max_attempts:
                    raise
                delay = self.delay_for(attempt)
                if self.deadline_s is not None:
                    elapsed = clock() - start
                    if elapsed + delay >= self.deadline_s:
                        raise
                if on_retry is not None:
                    on_retry(attempt, e, delay)
                if delay > 0:
                    sleep(delay)


# ---------------------------------------------------------------------------
# CircuitBreaker
# ---------------------------------------------------------------------------
class CircuitOpenError(ConnectionError):
    """Raised by :meth:`CircuitBreaker.call` while the circuit is open.

    Subclasses ConnectionError so existing transport-boundary handlers
    (and :func:`is_transient`) treat a tripped breaker as a transient,
    fail-fast condition."""


class CircuitBreaker:
    """Classic closed / open / half-open breaker on a rolling window.

    * **closed**: calls flow; failures are timestamped into a rolling
      ``window_s`` deque — reaching ``failure_threshold`` failures
      inside the window trips the breaker open.
    * **open**: calls are refused (``allow()`` False /
      :class:`CircuitOpenError`) until ``reset_timeout_s`` passes.
    * **half-open**: up to ``half_open_max`` probe calls are let
      through; one success closes the breaker (and clears the window),
      one failure re-opens it for another ``reset_timeout_s``.

    Thread-safe; ``clock`` is injectable for fake-clock tests.
    """

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half-open"

    def __init__(
        self,
        failure_threshold: int = 5,
        window_s: float = 30.0,
        reset_timeout_s: float = 5.0,
        half_open_max: int = 1,
        clock: Callable[[], float] = time.monotonic,
        name: str = "",
        on_trip: Optional[Callable[["CircuitBreaker"], None]] = None,
    ):
        self.failure_threshold = max(1, int(failure_threshold))
        self.window_s = float(window_s)
        self.reset_timeout_s = float(reset_timeout_s)
        self.half_open_max = max(1, int(half_open_max))
        self.name = name
        # observability hook: fired (outside the lock) each time the
        # breaker transitions to OPEN.  Its owner (the query client) routes
        # it into ``Pipeline.incident`` (a flight-recorder dump)
        self._on_trip = on_trip
        self._clock = clock
        self._lock = threading.Lock()
        self._failures: List[float] = []
        self._state = self.CLOSED
        self._opened_at = 0.0
        self._probes = 0
        self._last_probe_at = 0.0
        self._trips = 0  # lifetime count of closed/half-open -> open

    # -- state ---------------------------------------------------------------
    @property
    def state(self) -> str:
        with self._lock:
            return self._peek_state()

    @property
    def trip_count(self) -> int:
        with self._lock:
            return self._trips

    def _peek_state(self) -> str:
        # lock held: open lazily decays into half-open on inspection
        now = self._clock()
        if self._state == self.OPEN:
            if now - self._opened_at >= self.reset_timeout_s:
                self._state = self.HALF_OPEN
                self._probes = 0
        elif (
            self._state == self.HALF_OPEN
            and self._probes >= self.half_open_max
            and now - self._last_probe_at >= self.reset_timeout_s
        ):
            # a probe slot was reserved but its outcome never recorded
            # (caller abandoned mid-call — e.g. a generator torn down by
            # pipeline stop): self-heal by opening a new probe window
            # instead of staying wedged half-open forever
            self._probes = 0
        return self._state

    def allow(self) -> bool:
        """True if a call may proceed now (reserves a probe slot while
        half-open)."""
        with self._lock:
            st = self._peek_state()
            if st == self.CLOSED:
                return True
            if st == self.HALF_OPEN and self._probes < self.half_open_max:
                self._probes += 1
                self._last_probe_at = self._clock()
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            if self._peek_state() == self.OPEN:
                # STALE in-flight success (request predates the trip,
                # e.g. a slow response from before the failure burst):
                # closing here would bypass reset_timeout and half-open
                # probing entirely — under partial loss the breaker
                # would flap closed on every stray success.  Symmetric
                # to the stale-failure case in record_failure().
                return
            self._failures.clear()
            if self._state != self.CLOSED:
                log.info("breaker %s: closed (probe succeeded)", self.name)
            self._state = self.CLOSED
            self._probes = 0

    def record_failure(self) -> None:
        tripped = False
        with self._lock:
            now = self._clock()
            st = self._peek_state()
            if st == self.HALF_OPEN and self._probes > 0:
                # a granted probe failed: straight back to open.  With no
                # probe outstanding this is a STALE in-flight failure
                # (request older than the open window, e.g. a timeout
                # longer than reset_timeout) — it falls through to plain
                # window accounting instead of re-opening and bumping
                # trip_count for a probe that never ran.
                self._state = self.OPEN
                self._opened_at = now
                self._probes = 0
                self._trips += 1
                tripped = True
                log.warning("breaker %s: re-opened (probe failed)", self.name)
            else:
                self._failures.append(now)
                cutoff = now - self.window_s
                self._failures = [t for t in self._failures if t >= cutoff]
                if (
                    st == self.CLOSED
                    and len(self._failures) >= self.failure_threshold
                ):
                    self._state = self.OPEN
                    self._opened_at = now
                    self._trips += 1
                    tripped = True
                    log.warning(
                        "breaker %s: OPEN (%d failures in %.1fs)",
                        self.name, len(self._failures), self.window_s,
                    )
        if tripped and self._on_trip is not None:
            try:
                self._on_trip(self)
            except Exception:  # observer bugs must never break the breaker
                log.exception("breaker %s: on_trip hook failed", self.name)

    def call(self, fn: Callable[..., Any], *args: Any, **kwargs: Any) -> Any:
        if not self.allow():
            raise CircuitOpenError(
                f"circuit {self.name or 'breaker'} is {self.state}"
            )
        try:
            result = fn(*args, **kwargs)
        except BaseException:
            self.record_failure()
            raise
        self.record_success()
        return result

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "state": self._peek_state(),
                "recent_failures": len(self._failures),
                "trips": self._trips,
            }


# ---------------------------------------------------------------------------
# FaultInjector
# ---------------------------------------------------------------------------
class _FaultPlan:
    """One armed site: decides per-invocation whether to raise."""

    def __init__(
        self,
        exc: Any = None,
        rate: float = 0.0,
        times: Optional[int] = None,
        after: int = 0,
        every: Optional[int] = None,
        seed: int = 0,
        callback: Optional[Callable[[int], Optional[BaseException]]] = None,
        delay: float = 0.0,
        hang: bool = False,
        corrupt: Optional[str] = None,
    ):
        self.exc = exc if exc is not None else TransientError("injected fault")
        self.rate = float(rate)
        self.times = times  # max number of faults to fire (None = forever)
        self.after = int(after)  # skip the first N invocations
        self.every = every  # fire on every Nth invocation (deterministic)
        self.callback = callback
        # latency faults: delay=S sleeps the caller S seconds at the site
        # (then proceeds normally); hang=True blocks until cooperatively
        # interrupted, then raises StallError (core/liveness.py) — the
        # deterministic stand-in for an element that silently wedges
        self.delay = float(delay)
        self.hang = bool(hang)
        # corruption faults: 'bitflip' | 'truncate' — consumed by
        # FaultInjector.mangle() at wire sites (check() ignores these
        # plans; the fault is a data mutation, not an exception)
        if corrupt not in (None, "bitflip", "truncate"):
            raise ValueError(f"corrupt={corrupt!r} (want bitflip|truncate)")
        self.corrupt = corrupt
        self._rng = random.Random(seed)
        self.calls = 0
        self.fired = 0

    def decide(self) -> Optional[Tuple[str, Any]]:
        """None (no fault) or an action: ``("raise", exc)``,
        ``("delay", seconds)``, or ``("hang", None)``."""
        i = self.calls
        self.calls += 1
        if self.callback is not None:
            err = self.callback(i)
            if err is not None:
                self.fired += 1
                return ("raise", err)
            return None
        if i < self.after:
            return None
        if self.times is not None and self.fired >= self.times:
            return None
        hit = (
            ((i - self.after) % self.every == 0) if self.every
            else (self._rng.random() < self.rate)
        )
        if not hit:
            return None
        self.fired += 1
        if self.corrupt:
            return ("corrupt", self.corrupt)
        if self.hang:
            return ("hang", None)
        if self.delay > 0:
            return ("delay", self.delay)
        exc = self.exc
        if isinstance(exc, type):
            return ("raise", exc("injected fault"))
        try:
            # fresh instance per fire: concurrent raisers of ONE shared
            # instance would cross-contaminate __traceback__/__context__
            return ("raise", type(exc)(*exc.args))
        except Exception:  # exotic ctor signature: fall back to sharing
            return ("raise", exc)


class FaultInjector:
    """Process-wide registry of named fault sites.

    Production code sprinkles ``FAULTS.check("tcp_query.send")`` at
    interesting boundaries; the check is a no-op until a test *arms*
    the site::

        FAULTS.arm("tcp_query.send", rate=0.3, seed=7,
                   exc=ConnectionResetError)
        ...
        FAULTS.reset()   # in teardown, always

    Determinism: rate-based plans draw from their own seeded RNG, and
    ``every=N`` fires on exactly every Nth invocation — two runs with
    the same seed inject the same fault sequence.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._plans: Dict[str, _FaultPlan] = {}
        self._armed = False  # one-bool fast path for un-instrumented runs
        # release valve for in-progress delay/hang faults: reset()/disarm()
        # set it so no teardown ever waits on an injected wedge
        self._release = threading.Event()

    def arm(
        self,
        site: str,
        exc: Any = None,
        rate: float = 1.0,
        times: Optional[int] = None,
        after: int = 0,
        every: Optional[int] = None,
        seed: int = 0,
        callback: Optional[Callable[[int], Optional[BaseException]]] = None,
        delay: float = 0.0,
        hang: bool = False,
        corrupt: Optional[str] = None,
    ) -> None:
        """Arm `site`.  ``exc`` may be an exception instance or class;
        ``rate`` is the per-invocation fault probability (1.0 = always),
        ``every=N`` switches to strictly periodic injection, ``after``
        skips the first invocations, ``times`` caps total faults, and
        ``callback(i)`` takes full control (return an exception or
        None).  ``delay=S`` injects S seconds of latency instead of an
        error (the call then proceeds); ``hang=True`` blocks the caller
        until cooperatively interrupted — the site's ``interrupt``
        callable, the element's interrupt flag, or ``reset()`` — then
        raises :class:`~..core.liveness.StallError`.

        ``corrupt="bitflip"|"truncate"`` injects deterministic seeded
        WIRE CORRUPTION instead of an exception: instrumented transports
        route their encoded bytes through :meth:`mangle`, which flips
        one seeded bit / truncates at a seeded offset whenever the plan
        fires (``check()`` ignores corrupt plans — the fault is a data
        mutation, not a raise)."""
        with self._lock:
            self._plans[site] = _FaultPlan(
                exc=exc, rate=rate, times=times, after=after,
                every=every, seed=seed, callback=callback,
                delay=delay, hang=hang, corrupt=corrupt,
            )
            self._armed = True
            self._release.clear()

    def disarm(self, site: str) -> None:
        with self._lock:
            self._plans.pop(site, None)
            self._armed = bool(self._plans)
            if not self._armed:
                self._release.set()

    def reset(self) -> None:
        with self._lock:
            self._plans.clear()
            self._armed = False
            self._release.set()

    def is_armed(self) -> bool:
        """Fast gate for call sites whose site NAME is costly to build
        (f-strings on per-frame paths): skip check() entirely when no
        plan is armed."""
        return self._armed

    def check(self, site: str,
              interrupt: Optional[Callable[[], bool]] = None) -> None:
        """Raise/delay/hang per the planned fault for `site`, if armed
        (hot-path no-op otherwise).  ``interrupt`` is the cooperative
        escape hatch for latency faults: sites on supervised paths pass
        the element's interrupt/stop predicate so a watchdog escalation
        (or pipeline stop) can break an injected hang."""
        if not self._armed:
            return
        with self._lock:
            plan = self._plans.get(site)
            if plan is None or plan.corrupt is not None:
                return  # corrupt plans fire via mangle(), not check()
            action = plan.decide()
        if action is None:
            return
        kind, arg = action
        if kind == "raise":
            log.debug("fault injected at %s: %r", site, arg)
            raise arg
        if kind == "delay":
            log.debug("latency fault at %s: %.3fs", site, arg)
            deadline = time.monotonic() + arg
            while time.monotonic() < deadline:
                if (interrupt is not None and interrupt()) or \
                        self._release.wait(
                            min(0.005, max(0.0, deadline - time.monotonic()))):
                    break
            return
        # hang: block until someone pulls the plug, then surface as a
        # stall so restart machinery can treat it like any transient
        log.debug("hang fault at %s (waiting for interrupt)", site)
        while not (interrupt is not None and interrupt()):
            if self._release.wait(0.005):
                break
        from .liveness import StallError

        raise StallError(f"injected hang at {site} interrupted")

    def mangle(self, site: str, data):
        """Deterministic wire corruption: when `site` is armed with a
        ``corrupt=`` plan and the plan fires, return a mutated COPY of
        ``data`` (one seeded bit flipped, or the buffer truncated at a
        seeded offset); otherwise return ``data`` unchanged.

        Instrumented transports call this on their ENCODED bytes, after
        checksums are computed — simulating corruption on the wire, so
        the receiver's integrity verification is what must catch it.
        Sites guard the call with :meth:`is_armed` to keep the un-armed
        hot path free."""
        if not self._armed:
            return data
        with self._lock:
            plan = self._plans.get(site)
            if plan is None or plan.corrupt is None:
                return data
            action = plan.decide()
            if action is None:
                return data
            kind = action[1]
            buf = bytearray(bytes(data))
            if not buf:
                return data
            if kind == "truncate":
                cut = plan._rng.randrange(len(buf))
                log.debug("corruption fault at %s: truncated %d -> %d bytes",
                          site, len(buf), cut)
                return bytes(buf[:cut])
            pos = plan._rng.randrange(len(buf) * 8)
            buf[pos // 8] ^= 1 << (pos % 8)
            log.debug("corruption fault at %s: bit %d flipped", site, pos)
            return bytes(buf)

    def mangle_parts(self, site: str, parts: List) -> List:
        """:meth:`mangle` over a vectored parts list: the join (a copy)
        happens only when `site` actually holds a corrupt plan, so
        gather-send hot paths never pay it un-armed."""
        if not self._armed:
            return parts
        with self._lock:
            plan = self._plans.get(site)
            armed = plan is not None and plan.corrupt is not None
        if not armed:
            return parts
        return [self.mangle(site, b"".join(bytes(p) for p in parts))]

    def stats(self, site: str) -> Dict[str, int]:
        """{calls, fired} counters for an armed (or just-disarmed) site;
        zeros if never armed."""
        with self._lock:
            plan = self._plans.get(site)
            if plan is None:
                return {"calls": 0, "fired": 0}
            return {"calls": plan.calls, "fired": plan.fired}

    def armed_sites(self) -> List[str]:
        with self._lock:
            return sorted(self._plans)


#: the process-wide injector every instrumented site consults
FAULTS = FaultInjector()

"""Lifecycle primitives: validated hot model swap, graceful drain, and
rolling-restart support: the zero-downtime operations layer.

Port of ``nnstreamer_tpu/core/lifecycle.py``.  The supervision layer
makes the pipeline survive *unplanned* failures; this module covers the
two most common *planned* disruptions of a serving fleet, model updates
and restarts, so neither drops a frame:

* **Validated hot model swap** (:class:`HotSwapCoordinator`): the new
  model is staged on a *second* backend instance in a background thread
  (open, schema compatibility check against the pipeline's negotiated
  specs, warm-up on a zero probe frame, on a CUDA stream of its own in
  the torch-cuda filter), so none of that lands on the hot path; then the
  serving pointer swaps at a frame boundary.  Any staging failure keeps
  the old model serving (``swap_failures``), and an error burst inside
  the post-swap observation window rolls back to the retained old
  backend (``rollbacks``).  The retiring backend closes only after the
  element's last in-flight frame has been emitted (the graveyard is
  reaped at drained frame boundaries).

* **Graceful drain** (``Pipeline.drain``, see pipeline/pipeline.py):
  quiesce sources, flush in-flight frames to the sinks through the
  existing EOS machinery under a bounded deadline, report exact
  ``{drained, dropped, elapsed}``.

* **Rolling query-server restart**: a draining query server refuses
  *new* requests with a GOAWAY reply (:class:`ServerGoawayError`) that
  clients treat as an immediate, resend-safe failover signal: 'G' on
  the raw-TCP transport, UNAVAILABLE with a goaway detail on gRPC
  (``distributed/``).

Design rules follow core/resilience.py: injectable clocks, zero hot-path
cost when idle (the coordinator's pending checks are plain attribute
reads), and every counter exact.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

from .log import get_logger
from .resilience import FAULTS, RemoteApplicationError

log = get_logger("lifecycle")


class ServerGoawayError(RemoteApplicationError):
    """The server refused the request because it is DRAINING (GOAWAY).

    Subclasses :class:`RemoteApplicationError`: the server answered, so
    breakers/cooldowns must not count it against the remote's health —
    a planned restart is not an outage.  A GOAWAY-refused request
    provably never executed, which makes an immediate resend on another
    host safe even under at-most-once delivery; unlike BUSY there is no
    pacing to honor (the host is leaving, not overloaded), so clients
    fail over with zero added latency."""

    def __init__(self, msg: str = "server draining (goaway)"):
        super().__init__(msg)


def pipeline_quiescing(element: Any, drain: bool = True) -> bool:
    """True when the element's owning pipeline wants its sources to stop
    producing: hard stop always; graceful drain when ``drain``.  Shared
    by every source whose ``frames()`` generator waits in an internal
    poll loop (appsrc, repo, edge/grpc/mqtt subscribers) — the
    scheduler-level drain check only runs between yields, so sources
    that block *inside* ``frames()`` must poll this themselves."""
    p = getattr(element, "_pipeline", None)
    if p is None:
        return False
    if p._stop_flag.is_set():
        return True
    return bool(drain and p.draining)


class SwapTicket:
    """Handle for one hot-swap request.

    States: ``staging`` → ``failed`` | ``staged`` → ``applied`` →
    ``committed`` | ``rolled-back`` (plus ``refused`` when a request is
    rejected up front, e.g. another swap is already in flight).
    ``wait_staged`` unblocks when the background validation finished
    either way; ``wait_applied`` when the new model actually started
    serving (the swap lands at the element's next frame boundary)."""

    def __init__(self, model: str):
        self.model = model
        self.state = "staging"
        self.error: Optional[BaseException] = None
        self._staged_done = threading.Event()
        self._applied = threading.Event()

    # -- transitions (coordinator-internal) ---------------------------------
    def _fail(self, err: BaseException, state: str = "failed") -> None:
        self.error = err
        self.state = state
        self._staged_done.set()
        self._applied.set()  # never will be: unblock waiters

    def _staged(self) -> None:
        self.state = "staged"
        self._staged_done.set()

    def _apply(self) -> None:
        self.state = "applied"
        self._applied.set()

    # -- API ----------------------------------------------------------------
    @property
    def ok(self) -> bool:
        """Staging succeeded (the swap may still be pending/observing)."""
        return self.error is None

    def wait_staged(self, timeout: Optional[float] = None) -> bool:
        return self._staged_done.wait(timeout)

    def wait_applied(self, timeout: Optional[float] = None) -> bool:
        """True once the new model is serving (False on timeout or when
        staging failed — check ``ok``)."""
        if not self._applied.wait(timeout):
            return False
        return self.state in ("applied", "committed", "rolled-back")


class HotSwapCoordinator:
    """Stage → validate → warm → swap → observe → commit/rollback state
    machine for one serving element (composed by ``tensor_filter``).

    The element supplies three callables:

    * ``build(model) -> backend`` — open a SECOND backend instance for
      the new model (must not touch the serving one).
    * ``validate(backend) -> (in_spec, out_spec)`` — raise unless the
      new model is schema-compatible with the pipeline's negotiated
      specs; returns the model info the element adopts at swap time.
    * ``warmup(backend) -> None`` — run the probe invoke(s) so the
      first real frame after the swap pays no compile.

    Threading contract: ``request``/staging run on a private daemon
    thread; ``take_staged``/``activated``/``note_ok``/``note_error``/
    ``discard``/``reap`` are called ONLY from the element's streaming
    thread (single consumer); counters and slots are lock-guarded so
    ``snapshot()`` may be read from anywhere.

    Fault sites (deterministic chaos, core/resilience.py FAULTS):
    ``filter.reload.load`` fires before the new backend opens,
    ``filter.reload.warmup`` before the probe invoke, and
    ``filter.reload.post`` inside the observation window's invoke path —
    the three planned-failure kinds of a model rollout."""

    def __init__(
        self,
        name: str,
        build: Callable[[str], Any],
        validate: Callable[[Any], Tuple[Any, Any]],
        warmup: Callable[[Any], None],
        clock: Callable[[], float] = time.monotonic,
    ):
        self.name = name
        self._build = build
        self._validate = validate
        self._warmup = warmup
        self._clock = clock
        self._lock = threading.Lock()
        # lifetime counters (survive element restarts — accounting is the
        # acceptance contract: a failed swap must show up HERE, never in
        # the supervisor's restart budget)
        self.swaps = 0
        self.swap_failures = 0
        self.rollbacks = 0
        self.model_version = 0
        self.last_error = ""
        # staged slot: (backend, model, in_spec, out_spec, ticket)
        self._staged: Optional[Tuple] = None
        self._staging = False
        # bumped by close(): a staging thread that completes after the
        # element stopped must discard its backend (never stage it —
        # that would leak a device-resident model, or silently apply a
        # stale pre-stop swap after a restart)
        self._close_epoch = 0
        # retired slot while observing: (old_blob, ticket); old_blob is
        # the element's opaque restore state (backend + model info)
        self._retired: Optional[Tuple] = None
        self.observing = False
        self._obs_deadline = 0.0
        self._obs_errors = 0
        self._obs_burst = 3
        # backends awaiting close — reaped only at a DRAINED frame
        # boundary, so a retiring backend can never be closed under its
        # last in-flight frames
        self._graveyard: list = []

    # -- hot-path pending checks (plain attribute reads) ---------------------
    @property
    def has_boundary_work(self) -> bool:
        """Anything to do at the next frame boundary?  Cheap enough for
        the per-call hot path."""
        return (
            self._staged is not None
            or bool(self._graveyard)
            or (self.observing and self._clock() >= self._obs_deadline)
        )

    # -- request / staging ----------------------------------------------------
    def request(self, model: str, observation_window: float = 5.0,
                error_burst: int = 3) -> SwapTicket:
        """Begin staging ``model`` on a background thread; returns the
        ticket immediately.  Refused (ticket state ``refused``) when a
        swap is already staging/staged *or still inside its observation
        window* (accepting then would overwrite the retained old backend
        before its commit/rollback verdict — leaking it and stranding
        its ticket) — the caller retries after it lands; refusals are
        not ``swap_failures`` (nothing was tried)."""
        ticket = SwapTicket(model)
        with self._lock:
            if (self._staging or self._staged is not None
                    or self._retired is not None):
                ticket._fail(
                    RuntimeError(f"{self.name}: a model swap is already "
                                 "in progress"),
                    state="refused",
                )
                return ticket
            self._staging = True
            self._pending_window = max(0.0, float(observation_window))
            self._pending_burst = max(1, int(error_burst))
            epoch = self._close_epoch
        t = threading.Thread(
            target=self._stage, args=(model, ticket, epoch),
            name=f"{self.name}-model-stage", daemon=True,
        )
        t.start()
        return ticket

    def stage_sync(self, model: str, observation_window: float = 5.0,
                   error_burst: int = 3) -> SwapTicket:
        """Synchronous staging (tests / call sites that want to block)."""
        ticket = self.request(model, observation_window, error_burst)
        if ticket.state != "refused":
            ticket.wait_staged()
        return ticket

    def _stage(self, model: str, ticket: SwapTicket, epoch: int) -> None:
        backend = None
        try:
            FAULTS.check("filter.reload.load")
            backend = self._build(model)
            in_spec, out_spec = self._validate(backend)
            FAULTS.check("filter.reload.warmup")
            self._warmup(backend)
        except (KeyboardInterrupt, SystemExit):
            raise
        except BaseException as e:  # noqa: BLE001 — staging boundary: ANY
            # failure here must leave the old model serving untouched
            if backend is not None:
                try:
                    backend.close()
                except Exception:  # allow-silent: teardown of a dead stage
                    pass
            with self._lock:
                self._staging = False
                stale = epoch != self._close_epoch
                if not stale:
                    self.swap_failures += 1
                    self.last_error = repr(e)
            if not stale:
                log.error(
                    "%s: hot swap to %r failed during staging "
                    "(old model keeps serving): %s", self.name, model, e,
                )
            ticket._fail(e)
            return
        with self._lock:
            self._staging = False
            stale = epoch != self._close_epoch
            if not stale:
                self._staged = (backend, model, in_spec, out_spec, ticket)
        if stale:
            # the element stopped while we were staging: the freshly
            # opened backend must be torn down, never staged (a restart
            # must not inherit a pre-stop swap)
            try:
                backend.close()
            except Exception:
                log.exception("%s: closing orphaned staged backend failed",
                              self.name)
            ticket._fail(RuntimeError("element stopped during staging"))
            return
        log.info(
            "%s: model %r staged and warmed; swapping at the next frame "
            "boundary", self.name, model,
        )
        ticket._staged()

    def note_inline_failure(self, err: BaseException) -> SwapTicket:
        """Account a failed LEGACY inline ``backend.reload()`` (staging
        bypassed): same counter, same keep-serving contract."""
        with self._lock:
            self.swap_failures += 1
            self.last_error = repr(err)
        t = SwapTicket("")
        t._fail(err)
        return t

    def note_inline_swap(self, model: str) -> SwapTicket:
        """Account a successful legacy inline reload (no observation
        window — the backend swapped internally)."""
        with self._lock:
            self.swaps += 1
            self.model_version += 1
        t = SwapTicket(model)
        t._staged()
        t._apply()
        t.state = "committed"
        return t

    # -- swap at the frame boundary (element streaming thread only) ----------
    def take_staged(self) -> Optional[Tuple]:
        """Claim the staged (backend, model, in_spec, out_spec, ticket)
        or None.  The caller MUST follow up with :meth:`activated`."""
        with self._lock:
            staged, self._staged = self._staged, None
            return staged

    def activated(self, old_blob: Tuple, ticket: SwapTicket) -> None:
        """The element swapped its serving pointer; retain the old
        backend for the observation window."""
        with self._lock:
            self._retired = (old_blob, ticket)
            self.observing = True
            self._obs_deadline = self._clock() + getattr(
                self, "_pending_window", 5.0)
            self._obs_errors = 0
            self._obs_burst = getattr(self, "_pending_burst", 3)
            self.swaps += 1
            self.model_version += 1
        ticket._apply()

    def note_ok(self) -> None:
        """A post-swap invoke succeeded: commit once the observation
        window has elapsed (the retired backend moves to the graveyard,
        closed at the next drained boundary)."""
        if not self.observing or self._clock() < self._obs_deadline:
            return
        self._commit()

    def _commit(self) -> None:
        with self._lock:
            if self._retired is None:
                self.observing = False
                return
            (old_blob, ticket), self._retired = self._retired, None
            self.observing = False
            self._graveyard.append(old_blob[0])
        ticket.state = "committed"
        log.info("%s: swap committed (model_version=%d)",
                 self.name, self.model_version)

    def note_error(self, err: BaseException) -> Optional[Tuple]:
        """A post-swap invoke failed.  Returns ``(old_blob,
        rolled_back)`` — the element retries the frame on the retained
        old backend either way (zero frame loss), and on ``rolled_back``
        it must restore its pointers from ``old_blob`` and hand the
        failed new backend to :meth:`discard`.  None when no observation
        window is active (normal supervision applies)."""
        if not self.observing or self._retired is None:
            return None
        with self._lock:
            if self._retired is None:
                return None
            self._obs_errors += 1
            self.last_error = repr(err)
            burst = self._obs_errors >= self._obs_burst
            old_blob, ticket = self._retired
            if burst:
                self._retired = None
                self.observing = False
                self.rollbacks += 1
                self.model_version -= 1
        if burst:
            ticket.state = "rolled-back"
            log.error(
                "%s: %d invoke error(s) inside the post-swap observation "
                "window — rolled back to the previous model: %s",
                self.name, self._obs_errors, err,
            )
        else:
            log.warning(
                "%s: post-swap invoke error %d/%d (frame served by the "
                "retained old model): %s",
                self.name, self._obs_errors, self._obs_burst, err,
            )
        return (old_blob, burst)

    def discard(self, backend: Any) -> None:
        """Queue a rolled-back (or otherwise dead) backend for closing
        at the next drained frame boundary."""
        with self._lock:
            self._graveyard.append(backend)

    def reap(self) -> None:
        """Close graveyard backends.  Call ONLY after the element's
        in-flight window is drained — this is what guarantees a retiring
        backend outlives its last in-flight frame."""
        with self._lock:
            dead, self._graveyard = self._graveyard, []
        for be in dead:
            try:
                be.close()
            except Exception:
                log.exception("%s: closing retired backend failed", self.name)

    def close(self) -> None:
        """Element stop: tear down every non-serving backend this
        coordinator still holds (staged, retired, graveyard).  Counters
        survive — they are lifetime accounting."""
        with self._lock:
            staged, self._staged = self._staged, None
            retired, self._retired = self._retired, None
            dead, self._graveyard = self._graveyard, []
            self.observing = False
            self._staging = False
            # an in-flight staging thread sees the epoch change and
            # discards its backend instead of staging it
            self._close_epoch += 1
        if staged is not None:
            dead.append(staged[0])
            staged[4]._fail(RuntimeError("element stopped before swap"))
        if retired is not None:
            dead.append(retired[0][0])
            retired[1].state = "committed"  # the new model served until stop
        for be in dead:
            try:
                be.close()
            except Exception:
                log.exception("%s: closing backend failed", self.name)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            state = (
                "staging" if self._staging
                else "staged" if self._staged is not None
                else "observing" if self.observing
                else "idle"
            )
            return {
                "swaps": self.swaps,
                "swap_failures": self.swap_failures,
                "rollbacks": self.rollbacks,
                "model_version": self.model_version,
                "swap_state": state,
                "swap_last_error": self.last_error,
            }

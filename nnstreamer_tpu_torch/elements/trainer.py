"""tensor_trainer: in-pipeline training element.

Port of ``nnstreamer_tpu/elements/trainer.py``, with its properties; the
``framework`` default is ``torch`` (``trainer/torch_trainer.py``), and
``accelerator`` (the filter's grammar; empty = ``cuda:0``) places the
model.  What the backend cannot run (a ``.msgpack`` model path, ``mesh=``,
ROADMAP A11, no CUDA device without ``accelerator=cpu``) fails at
``start()``, before any frame flows.

Reference: ``gst/nnstreamer/elements/gsttensor_trainer.c`` (SURVEY §3.4) —
a data pump + lifecycle/event manager around a trainer subplugin: first
buffer triggers create+start, every buffer becomes push_data, epoch
completion pushes a model-stats frame downstream, training completion saves
the model and lets the pipeline EOS.

Robustness (net-new vs the reference — the preemptible-accelerator contract):

* **No silent death** — the training thread runs off the frame path, so a
  crash on a quiet stream used to be invisible until the next buffer (or
  forever).  The element registers a watchdog sweep that detects a dead
  backend thread within ~250ms, records a flight-recorder incident, and
  routes the typed error through the supervision taxonomy:
  ``error-policy=restart`` revives the backend (restart budget/backoff via
  the pipeline supervisor) with ``resume=1`` forced when a checkpoint-path
  exists — mid-run, on a live stream, realigning at the next epoch
  boundary; the fail-stop default surfaces the error immediately (the
  liveness-fail pattern: ``wait()`` raises without waiting for EOS).
* **Starvation-free co-hosting** — when the pipeline's memory watermark
  monitor reports sustained pressure, the sweep pauses training at the
  next step boundary (resumable — the bounded trainer queue backpressures,
  zero samples lost) and unpauses when pressure clears, so co-hosted
  serving never competes with train steps for headroom.  ``pause=true``
  is the manual override (runtime-settable).
* **Exact accounting** — ``health_info()`` exports the ``nns.train.*``
  surface (steps/samples/loss/checkpoints/resumes/pauses/...) through the
  one health-collector path; counters survive backend revives.
"""

from __future__ import annotations

import threading
from typing import Any, Dict

import numpy as np

from ..core.buffer import TensorFrame
from ..core.resilience import FatalError, TransientError, is_transient
from ..core.types import FORMAT_STATIC, StreamSpec, TensorSpec
from ..pipeline.element import Element, ElementError, Property, element
from ..pipeline.pipeline import BusMessage
from ..trainer.base import (
    EVENT_EPOCH_COMPLETION,
    EVENT_TRAINING_COMPLETION,
    TrainerStatus,
    find_trainer,
)


@element("tensor_trainer")
class TensorTrainer(Element):
    PROPERTIES = {
        "framework": Property(str, "torch", "trainer backend name"),
        "accelerator": Property(
            str, "", "ordered wish list 'true:gpu.N,cpu' or 'cpu' (empty = cuda:0)"),
        "model-config": Property(str, "", "config file path or inline JSON"),
        "model-save-path": Property(str, "", "where to save the trained model"),
        "model-load-path": Property(str, "", "warm-start weights"),
        "num-inputs": Property(int, 1, "input tensors per frame"),
        "num-labels": Property(int, 1, "label tensors per frame"),
        "num-training-samples": Property(int, 0, "train samples per epoch"),
        "num-validation-samples": Property(int, 0, "validation samples per epoch"),
        "epochs": Property(int, 1, "number of epochs"),
        "max-buffers": Property(int, 0, "mailbox depth override"),
        # periodic full-state checkpointing (net-new vs reference, SURVEY §5.3:
        # preemptible-accelerator recovery needs more than final model-save-path)
        "checkpoint-path": Property(str, "", "dir for periodic checkpoints"),
        "checkpoint-interval": Property(int, 1, "epochs between checkpoints"),
        "checkpoint-steps": Property(
            int, 0, "optimizer steps between checkpoints (0 = epoch-grain)"
        ),
        "checkpoint-keep": Property(int, 3, "checkpoints retained (0 = all)"),
        "resume": Property(bool, False, "resume from newest checkpoint"),
        # mesh-sharded train steps (the serving ``mesh=`` grammar): not
        # ported, refused at start (ROADMAP A11)
        "mesh": Property(str, "", "mesh spec (dp:2,tp:2) to shard train steps"),
        # resumable pause (starvation-free co-hosting; auto-driven by the
        # memory watermark monitor, manually via this runtime-settable prop)
        "pause": Property(bool, False, "true = pause training (runtime-settable)"),
        # ≙ gsttensor_trainer.c PROP_READY_TO_COMPLETE_TRAINING: setting
        # true on a RUNNING trainer finishes training gracefully (current
        # data drained, model saved, completion event fired)
        "ready-to-complete": Property(
            bool, False, "true = finish training now (runtime-settable)"
        ),
    }

    def set_property(self, key, value):
        super().set_property(key, value)
        k = key.replace("_", "-")
        if k == "ready-to-complete" and self.props["ready-to-complete"]:
            if self.backend is not None and self._created:
                # mirror the reference contract: graceful early finish
                # while training is live
                if hasattr(self.backend, "end_of_data"):
                    self._finish_requested = True
                    self.backend.end_of_data()
            else:
                # ≙ the reference's PLAYING-state-only warning; the flag
                # is honored when training goes live (handle_frame)
                self.log.warning(
                    "ready-to-complete set before training started; will "
                    "finish after the first pushed batch"
                )
        elif k == "pause":
            self._set_manual_pause(bool(self.props["pause"]))

    def __init__(self, name=None):
        super().__init__(name)
        self.backend = None
        self._created = False
        self._finish_requested = False
        self.training_complete = threading.Event()
        self._stats_lock = threading.Lock()
        self._stats_pending = []  # epoch stats awaiting downstream emission
        self._backend_lock = threading.Lock()  # create/revive vs sweep races
        self._sweep_cb = None       # the registered sweep hook (per-run dedup)
        self._death_handled = False  # one supervision verdict per backend
        self._revive_next = False   # next backend create resumes mid-stream
        self._manual_pause = False  # pause= prop (owns the paused state)
        self._auto_paused = False   # memory-watermark pause (yields to manual)
        # element-lifetime accounting: a revive replaces the backend, so
        # counters the chaos harness pins fold in here across restarts
        self.pauses = 0
        self.train_restarts = 0
        self._carry: Dict[str, int] = {
            "samples": 0, "checkpoints": 0, "resumes": 0,
            "replay_skipped": 0, "gap_samples": 0,
        }
        self._last_steps = 0
        self._last_status = TrainerStatus()

    def start(self):
        try:
            cls = find_trainer(self.props["framework"])
        except KeyError:
            raise ElementError(
                f"{self.name}: unknown trainer framework {self.props['framework']!r}"
            ) from None
        check = getattr(cls, "check_props", None)
        if check is not None:
            try:
                check(dict(self.props))
            except (ValueError, NotImplementedError, RuntimeError) as e:
                raise ElementError(f"{self.name}: {e}") from e
        self.backend = cls()
        self.backend.add_listener(self._on_event)
        # reset run state so a restarted pipeline waits for the new run
        self.training_complete.clear()
        self._finish_requested = False
        self._death_handled = False
        with self._stats_lock:
            self._stats_pending = []
        p = self._pipeline
        if p is not None:
            if not p._started:
                # fresh pipeline run (vs a mid-run supervisor restart,
                # where _started is True): the stream will replay from
                # sample 0, so the mid-stream realign must not arm
                self._revive_next = False
            # dead-thread detection + memory-pressure coupling live on
            # the watchdog sweeper (~4Hz) — never on the frame path; a
            # mid-run supervisor restart must not stack a second hook
            cb = self._sweep_cb
            if cb is None or all(f is not cb for f, _ in p._sweep_hooks):
                self._sweep_cb = self._sweep
                p.register_sweep(self._sweep_cb, 0.25)

    def stop(self):
        if self.backend is not None:
            self._fold_counters(self.backend)
            self.backend.stop()
            self.backend = None
        self._created = False
        self._auto_paused = False

    def _fold_counters(self, be) -> None:
        """Preserve a dying/stopping backend's exact accounting: the
        next backend starts its session counters at zero, so the element
        carries the totals (``steps`` is global — restored from the
        checkpoint cursor — and must NOT be summed)."""
        c = self._carry
        c["samples"] += be.samples_trained
        c["checkpoints"] += be.checkpoints
        c["resumes"] += be.resumes
        c["replay_skipped"] += be.replay_skipped
        c["gap_samples"] += be.gap_samples
        self._last_steps = max(self._last_steps, be.steps)
        self._last_status = be.status

    def _on_event(self, event: str, status: TrainerStatus) -> None:
        # fires on the trainer's own thread: queue stats for in-band emission
        # (≙ reference pushing model-stats buffers) and post out-of-band
        if self._pipeline is not None:
            self._pipeline.post(BusMessage("element", self.name, {event: status.as_dict()}))
        if event == EVENT_EPOCH_COMPLETION:
            s = status
            with self._stats_lock:
                self._stats_pending.append(
                    np.asarray(
                        [s.epoch_count, s.training_loss, s.training_accuracy,
                         s.validation_loss, s.validation_accuracy],
                        np.float64,
                    )
                )
        if event == EVENT_TRAINING_COMPLETION:
            self.training_complete.set()

    def _drain_stats(self):
        with self._stats_lock:
            pending, self._stats_pending = self._stats_pending, []
        if not self.srcpads or not self.srcpads[0].is_linked:
            return []  # terminal trainer: drop (don't accumulate) stats
        return [(0, TensorFrame([stats])) for stats in pending]

    def derive_spec(self, pad=0):
        # downstream sees epoch-stats vectors
        return StreamSpec(
            (TensorSpec((5,), np.float64, "model-stats"),), FORMAT_STATIC
        )

    def _create_backend(self) -> None:
        """Create + start the backend (first buffer, or a supervision
        revive).  After a backend death with a checkpoint-path, the new
        backend resumes from the newest durable checkpoint and realigns
        on the live (non-replaying) stream."""
        props = dict(self.props)
        if self._revive_next:
            self._revive_next = False
            if props.get("checkpoint-path"):
                props["resume"] = True
                props["_midstream-restart"] = True
            self.train_restarts += 1
        self.backend.create(props)
        self.backend.start()
        if self._manual_pause or self._auto_paused:
            self.backend.pause()  # a pause spans backend revives
        self._created = True
        self._death_handled = False

    def handle_frame(self, pad, frame):
        assert self.backend is not None
        with self._backend_lock:
            if not self._created:
                # first buffer: create + start (reference :141-144)
                self._create_backend()
            be = self.backend
        be.push_data(frame)
        if (
            self.props["ready-to-complete"] and not self._finish_requested
            and hasattr(be, "end_of_data")
        ):
            # flag was set before training went live: honor it now
            self._finish_requested = True
            be.end_of_data()
        self._check_backend_error()
        return self._drain_stats()

    def _check_backend_error(self):
        err = getattr(self.backend, "error", None)
        if err is not None:
            if self.props.get("checkpoint-path"):
                self._revive_next = True  # a supervisor retry resumes
            if isinstance(err, (TransientError, FatalError)):
                # typed: the supervisor's restart policy classifies it
                # (transient -> restart budget, fatal -> fail/dead-letter)
                raise err
            raise ElementError(f"{self.name}: trainer failed: {err}") from err

    # -- watchdog sweep (dead-thread detection + pressure coupling) ----------
    def _sweep(self) -> None:
        """Runs on the pipeline's watchdog sweeper thread (~4Hz): detect
        a dead training thread even on a quiet stream, and couple the
        resumable pause to the memory watermark monitor."""
        pipe, be = self._pipeline, self.backend
        if pipe is None or be is None or not self._created:
            return
        self._pressure_sweep(pipe, be)
        if self._death_handled:
            return
        err = getattr(be, "error", None)
        if err is None and (self.training_complete.is_set()
                            or be.thread_alive()):
            # running, or finished clean (the backend fires
            # TRAINING_COMPLETION even on error — the error, not the
            # completion flag, decides whether this was a death)
            return
        if err is None:
            # the thread is gone with no recorded error: nothing a
            # restart can't also hit — treat as transient (a preemption
            # kill looks exactly like this)
            err = TransientError(f"{self.name}: training thread died silently")
        self._death_handled = True
        h = pipe.health_map.get(self.name)
        if h is not None:
            h.last_error = repr(err)
        pipe.incident("trainer_death", self.name, repr(err))
        pipe.post(BusMessage("warning", self.name, {
            "trainer": "died", "error": err,
        }))
        if self.props.get("error-policy") == "restart" and is_transient(err):
            if self.props.get("checkpoint-path"):
                self._revive_next = True
            verdict = pipe._restart_element(self, err)
            if verdict == "retry":
                with self._backend_lock:
                    try:
                        self._create_backend()
                    except Exception as e:  # revive failed: fail-stop
                        err = e
                    else:
                        return
            elif verdict == "stopping":
                return
            # degraded (budget exhausted / start failed): fall through
        # fail-stop: surface NOW (the liveness-fail pattern) — wait()
        # must raise instead of hoping a dead trainer ever reports
        if not isinstance(err, ElementError):
            err = ElementError(f"{self.name}: trainer failed: {err}")
        if h is not None:
            h.state = "failed"
        self.training_complete.set()  # never hang handle_eos on a corpse
        pipe.errors.append(err)
        pipe.post(BusMessage("error", self.name, err))
        pipe._stop_flag.set()
        pipe._sinks_done.set()

    def _pressure_sweep(self, pipe, be) -> None:
        """Memory-watermark coupling: sustained pressure pauses train
        steps (resumable, counted, incident) before serving degrades;
        training unpauses when pressure clears.  Manual ``pause=true``
        owns the state — auto never overrides it."""
        mon = pipe.memory_monitor
        if mon is None or self._manual_pause:
            return
        pressured = bool(getattr(mon, "pressured", False))
        if pressured and not self._auto_paused:
            self._auto_paused = True
            self.pauses += 1
            be.pause()
            self.log.warning(
                "%s: training paused (memory pressure; pause #%d)",
                self.name, self.pauses,
            )
            pipe.post(BusMessage("warning", self.name, {
                "train": "paused", "reason": "memory-pressure",
                "pauses": self.pauses,
            }))
            pipe.incident("train_paused", self.name,
                          {"reason": "memory-pressure"})
        elif not pressured and self._auto_paused:
            self._auto_paused = False
            be.unpause()
            self.log.info("%s: training resumed (pressure cleared)", self.name)
            pipe.post(BusMessage("element", self.name, {"train": "resumed"}))

    def _set_manual_pause(self, want: bool) -> None:
        if want == self._manual_pause:
            return
        self._manual_pause = want
        be = self.backend
        if be is None or not self._created:
            return  # honored when the backend comes up (_create_backend)
        if want:
            if not self._auto_paused:
                self.pauses += 1
            be.pause()
        elif not self._auto_paused:
            # pressure-driven pause survives a manual unpause: the
            # watermark still governs until it clears
            be.unpause()

    # -- health export (the one collector path) ------------------------------
    def health_info(self) -> Dict[str, Any]:
        """The ``nns.train.*`` surface: exact step/sample accounting the
        kill/resume truth table and the chaos harness pin."""
        be = self.backend
        c = self._carry
        status = be.status if be is not None else self._last_status
        info = {
            "train_steps": max(self._last_steps, be.steps if be else 0),
            "train_samples": c["samples"] + (be.samples_trained if be else 0),
            "train_epochs": int(status.epoch_count),
            "train_loss": float(status.training_loss),
            "train_checkpoints": c["checkpoints"] + (be.checkpoints if be else 0),
            "train_resumes": c["resumes"] + (be.resumes if be else 0),
            "train_replay_skipped": (
                c["replay_skipped"] + (be.replay_skipped if be else 0)
            ),
            "train_gap_samples": c["gap_samples"] + (be.gap_samples if be else 0),
            "train_pauses": self.pauses,
            "train_paused": int(bool(be is not None and be.paused)),
            "train_restarts": self.train_restarts,
            "train_alive": int(bool(be is not None and be.thread_alive())),
        }
        return info

    def handle_eos(self, pad):
        if self.backend is not None and self._created:
            if hasattr(self.backend, "end_of_data"):
                self.backend.end_of_data()
            # wait for the training thread to finish + save (reference waits
            # on TRAINING_COMPLETION before EOS)
            if not self.training_complete.wait(timeout=600):
                raise ElementError(
                    f"{self.name}: training did not complete within 600s"
                )
            self._check_backend_error()
        return self._drain_stats()

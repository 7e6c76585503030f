"""Continuous batching for the generation path: the slot scheduler.

Port of ``nnstreamer_tpu/core/slots.py`` (``lru_bucket``, ``GenStream``,
``SlotEngine``), reduced to serving fresh streams.  Many concurrent
generation streams share one fixed-width decode batch: each live request
occupies a slot of a ``models/transformer.SlotModel``, and one decode call
runs ``k = min(chunk, min remaining)`` tokens for every active slot, so
each stream completes exactly at a call boundary.

* **join at token boundaries**: a new prompt claims a free slot (highest
  priority class first, FIFO within a class), its slot is reset, and its
  prompt is prefilled in ``prefill_chunk`` pieces interleaved with decode
  (``prefill_priority`` pieces per decode call; with nothing decoding,
  every joiner's next piece runs);
* **leave immediately**: finished, cancelled and deadline-evicted streams
  free their slot at the next boundary; idle slots are masked
  (``active = 0``), never removed, so the batch keeps its shape;
* **deadline QoS**: a stream whose request deadline (``DEADLINE_META``)
  or per-token pace budget (``token_budget_s``) is blown is evicted with a
  typed-expiry final chunk (partial tokens kept, ``evicted`` and
  ``deadline_expired`` meta);
* **emission** in exactly chunk-sized pieces and a final tail, the
  unslotted path's chunking whatever the decode call's length was.

Threading: the engine decodes on its own pump thread, which enters
``torch.inference_mode()`` and selects the model's CUDA device itself
(both are thread-local); the element drains ready chunks on its dispatch
thread through :meth:`SlotEngine.pop_ready`, which re-raises a pump error
there.  Tokens stay on the device between calls: one host copy per decode
call brings its ``(S, k)`` tokens back.

Not ported (ROADMAP A7): the prefix cache, the simulated model, GOAWAY
hand-off, resume and ledger adoption, OOM and device-loss recovery (A4),
SLO tracking.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .liveness import ThreadBeat

log = logging.getLogger("nnstreamer_tpu_torch.slots")

#: terminal stream states
DONE_STATES = ("done", "evicted", "cancelled")


def lru_bucket(lru: "OrderedDict", key, build, cap: int):
    """The bounded bucket cache shared by the engine's per-length prefill
    and decode functions: returns the cached (or freshly built) entry and
    evicts the least recently used past ``cap``."""
    fn = lru.get(key)
    if fn is not None:
        lru.move_to_end(key)
        return fn
    fn = build(key)
    lru[key] = fn
    while len(lru) > cap:
        lru.popitem(last=False)
    return fn


class GenStream:
    """One generation stream: a prompt waiting for or occupying a slot.

    ``frame`` is the source TensorFrame (emitted chunks inherit its meta
    through ``with_tensors``); tokens accumulate in ``pending`` until a
    chunk boundary or a terminal event flushes them."""

    __slots__ = (
        "sid", "frame", "prompt", "prompt_dev", "max_new", "chunk", "tenant",
        "priority", "deadline_ts", "token_budget_s", "state", "slot",
        "prefill_pos", "gen", "pending", "pending_n", "chunk_index",
        "tokens_out", "last_token_ts",
    )

    def __init__(self, sid: int, frame, prompt, max_new: int, chunk: int,
                 tenant: str = "", priority: int = 3,
                 deadline_ts: Optional[float] = None,
                 token_budget_s: float = 0.0, now: float = 0.0):
        self.sid = sid
        self.frame = frame
        self.prompt = prompt              # np.int32 (1, Tp)
        self.prompt_dev = None            # the prompt on the model's device
        self.max_new = int(max_new)
        self.chunk = max(1, int(chunk))
        self.tenant = tenant
        self.priority = int(priority)
        self.deadline_ts = deadline_ts    # absolute monotonic or None
        self.token_budget_s = float(token_budget_s)
        self.state = "waiting"            # waiting|prefill|decoding|<DONE>
        self.slot: Optional[int] = None
        self.prefill_pos = 0
        self.gen = 0                      # tokens generated so far
        self.pending: List[Any] = []      # np arrays (1, k) awaiting a chunk
        self.pending_n = 0
        self.chunk_index = 0
        self.tokens_out = 0               # tokens actually emitted
        self.last_token_ts = now

    @property
    def finished(self) -> bool:
        return self.state in DONE_STATES


class SlotEngine:
    """Fixed-width continuous-batching scheduler over a
    :class:`~nnstreamer_tpu_torch.models.transformer.SlotModel`.

    Public API (thread-safe): :meth:`submit`, :meth:`cancel`,
    :meth:`pop_ready`, :meth:`pending`, :meth:`idle`,
    :meth:`wait_progress`, :meth:`snapshot`.  ``start``/``stop`` bound the
    pump thread's life to the owning element's.
    """

    #: bound on live per-length prefill/decode functions
    BUCKET_MAX = 16
    #: deadline evictions fire this far BEFORE the request deadline, so the
    #: typed-expiry answer still reaches a client whose own timeout fires
    #: at the deadline
    EVICT_MARGIN_S = 0.05

    def __init__(self, model, *, max_seq: int, chunk: int = 8,
                 prefill_chunk: int = 32, prefill_priority: int = 1,
                 token_budget_s: float = 0.0,
                 clock: Callable[[], float] = time.monotonic,
                 name: str = "slots"):
        self.model = model
        self.slots = int(model.slots)
        self.device = torch.device(model.device)
        self.max_seq = int(max_seq)
        self.chunk = max(1, int(chunk))
        self.prefill_chunk = max(1, int(prefill_chunk))
        self.prefill_priority = max(0, int(prefill_priority))
        self.token_budget_s = float(token_budget_s)
        self.clock = clock
        self.name = name
        # the pump beats once per loop: pending work with a stale beat
        # means a wedged pump (stuck in a device call)
        self.heartbeat = ThreadBeat(f"{name}-slots", clock=clock)

        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)       # pump wakeups
        self._progress = threading.Condition(self._lock)   # consumer waits
        self._waiting: List[GenStream] = []
        self._occupants: List[Optional[GenStream]] = [None] * self.slots
        self._ready: List[Tuple[int, Any]] = []  # (pad, TensorFrame) outs
        self._streams: Dict[int, GenStream] = {}  # live (non-terminal)
        self._sid = 0
        self._error: Optional[BaseException] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

        # device state (pump-thread-private after start): the cache, the
        # (S,) int32 token and count vectors, the active mask and its host
        # copy (uploaded only when the decoding set changes)
        self._cache = None
        self._tok_vec = None
        self._gen_vec = None
        self._active = None
        self._active_host: Optional[np.ndarray] = None
        self._prefill_lru: "OrderedDict[int, Any]" = OrderedDict()
        self._decode_lru: "OrderedDict[int, Any]" = OrderedDict()

        # exact accounting (lock-held writes, GIL-atomic reads)
        self.joins = 0
        self.completions = 0
        self.evictions = 0
        self.cancellations = 0
        self.decode_steps = 0
        self.prefill_chunks = 0
        self.tokens_total = 0
        self.tokens_per_step = 0.0  # EWMA of active slots per decode call

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> None:
        self._stop.clear()
        self._error = None
        self._cache = self.model.init_cache()
        with torch.inference_mode():
            self._tok_vec = torch.zeros(self.slots, dtype=torch.int32, device=self.device)
            self._gen_vec = torch.zeros(self.slots, dtype=torch.int32, device=self.device)
        self._active_host = None
        self._thread = threading.Thread(
            target=self._pump, name=f"{self.name}-slots", daemon=True)
        self.heartbeat.beat()
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        with self._work:
            self._work.notify_all()
            self._progress.notify_all()
        t = self._thread
        if t is not None:
            t.join(timeout=30.0)
            self._thread = None
        with self._lock:
            abandoned = len(self._streams)  # waiting ones are members too
            if abandoned:
                log.warning("%s: engine stopped with %d stream(s) abandoned",
                            self.name, abandoned)
            self._waiting.clear()
            self._streams.clear()
            self._occupants = [None] * self.slots
            self._ready.clear()
        self._cache = self._tok_vec = self._gen_vec = self._active = None
        self._prefill_lru.clear()
        self._decode_lru.clear()

    # -- submission / cancellation -----------------------------------------
    def submit(self, frame, prompt, max_new: int, chunk: int,
               tenant: str = "", priority: int = 3,
               deadline_ts: Optional[float] = None) -> GenStream:
        """Queue one prompt for a slot.  ``prompt`` is host int32 (1, Tp),
        already validated against ``max_seq`` by the caller."""
        with self._lock:
            if self._error is not None:
                raise self._error
            self._sid += 1
            s = GenStream(
                self._sid, frame, prompt, max_new, chunk,
                tenant=tenant, priority=priority, deadline_ts=deadline_ts,
                token_budget_s=self.token_budget_s, now=self.clock(),
            )
            self._streams[s.sid] = s
            self._waiting.append(s)
            self._work.notify_all()
            return s

    def cancel(self, sid: Optional[int] = None,
               client_id: Optional[int] = None) -> bool:
        """Cancel by stream id or by the source frame's ``client_id`` meta.
        The slot frees at the next token boundary; no further chunks are
        emitted."""
        with self._lock:
            for s in list(self._streams.values()):
                if s.finished:
                    continue  # reaped at the next boundary; never recount
                if (sid is not None and s.sid == sid) or (
                        client_id is not None
                        and s.frame.meta.get("client_id") == client_id):
                    s.state = "cancelled"
                    self.cancellations += 1
                    self._work.notify_all()
                    return True
        return False

    # -- consumer side (element dispatch thread) ----------------------------
    def pop_ready(self) -> List[Tuple[int, Any]]:
        """Drain ready chunk frames (FIFO).  Re-raises a pump-thread error
        here, and keeps raising it: a dead pump fails loudly until the
        element restarts with a fresh engine."""
        with self._lock:
            if self._error is not None and not self._ready:
                raise self._error
            out, self._ready = self._ready, []
            return out

    def pending(self) -> int:
        """Live streams (waiting ones included) plus undelivered chunks."""
        with self._lock:
            return len(self._streams) + len(self._ready)

    def idle(self) -> bool:
        with self._lock:
            return not self._streams and not self._ready

    def wait_progress(self, timeout: float = 0.1) -> None:
        """Block the caller until the pump makes progress (EOS flush)."""
        with self._progress:
            if self._ready or self._error is not None:
                return
            self._progress.wait(timeout)

    # -- accounting ---------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "gen_slots": self.slots,
                "gen_occupied": sum(1 for s in self._occupants if s is not None),
                "gen_waiting": len(self._waiting),
                "gen_joins": self.joins,
                "gen_completed": self.completions,
                "gen_evicted": self.evictions,
                "gen_cancelled": self.cancellations,
                "gen_tokens": self.tokens_total,
                "gen_decode_steps": self.decode_steps,
                "gen_prefill_chunks": self.prefill_chunks,
                "gen_tokens_per_step": round(self.tokens_per_step, 3),
            }

    # -- pump internals -----------------------------------------------------
    def _prefill_fn(self, n: int):
        return lru_bucket(self._prefill_lru, n, self.model.prefill_fn, self.BUCKET_MAX)

    def _decode_fn(self, k: int):
        return lru_bucket(self._decode_lru, k, self.model.decode_fn, self.BUCKET_MAX)

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """A small host array on the model's device without draining the
        device's queue (a pageable copy would wait for it)."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _take(self, s: GenStream, n: int):
        """Slice the first ``n`` pending tokens off the stream's buffer
        (lock held)."""
        buf = (s.pending[0] if len(s.pending) == 1
               else np.concatenate(s.pending, axis=1))
        piece = buf[:, :n]
        rest = buf[:, n:]
        s.pending = [rest] if rest.shape[1] else []
        s.pending_n = buf.shape[1] - n
        return piece

    def _emit_frame(self, s: GenStream, toks, final: bool,
                    extra_meta: Optional[Dict[str, Any]] = None) -> None:
        """Emit one chunk frame (lock held).  ``toks`` None is a terminal
        answer with nothing pending: a tensor-less final frame."""
        if toks is not None:
            s.tokens_out += toks.shape[1]
            tensors = [toks.astype(np.int32)]
        else:
            tensors = []
        out = s.frame.with_tensors(tensors)
        out.meta.update(
            stream_seq=s.frame.seq, chunk_index=s.chunk_index,
            tokens_done=s.tokens_out, final=bool(final),
        )
        if extra_meta:
            out.meta.update(extra_meta)
        s.chunk_index += 1
        self._ready.append((0, out))
        self._progress.notify_all()

    def _emit_boundary(self, s: GenStream) -> None:
        """Emit EXACTLY chunk-sized pieces (lock held)."""
        while s.pending_n >= s.chunk:
            self._emit_frame(s, self._take(s, s.chunk), final=False)

    def _emit_terminal(self, s: GenStream,
                       extra_meta: Optional[Dict[str, Any]] = None) -> None:
        """Terminal flush (lock held): full chunks first, then the tail as
        the FINAL frame."""
        while s.pending_n > s.chunk:
            self._emit_frame(s, self._take(s, s.chunk), final=False)
        self._emit_frame(
            s, self._take(s, s.pending_n) if s.pending_n else None,
            final=True, extra_meta=extra_meta)

    def _free_slot(self, s: GenStream) -> None:
        """Release the stream's slot (lock held); the idle mask clears at
        the next decode call."""
        if s.slot is not None:
            self._occupants[s.slot] = None
        s.prompt_dev = None
        self._streams.pop(s.sid, None)

    def _finish(self, s: GenStream, state: str,
                extra_meta: Optional[Dict[str, Any]] = None) -> None:
        s.state = state
        if state == "done":
            self.completions += 1
            self._emit_terminal(s)
        elif state == "evicted":
            self.evictions += 1
            self._emit_terminal(s, extra_meta=extra_meta or {})
        # cancelled: the consumer is gone — nothing to emit
        self._free_slot(s)

    def _sweep_deadlines(self, now: float) -> None:
        """Evict streams whose request deadline is blown, waiting ones
        included (lock held).  The typed-expiry chunk keeps partial
        tokens."""
        for s in list(self._streams.values()):
            if s.finished:
                continue
            if not (s.deadline_ts is not None
                    and now >= s.deadline_ts - self.EVICT_MARGIN_S):
                continue
            if s.state == "waiting":
                self._waiting.remove(s)
            self._evict(s, "deadline")

    def _evict(self, s: GenStream, reason: str) -> None:
        """Typed-expiry eviction (lock held): partial tokens flush with the
        eviction meta, the slot frees at this boundary."""
        self._finish(s, "evicted", extra_meta={
            "evicted": reason, "deadline_expired": True,
        })
        log.warning("%s: stream %d evicted (%s) after %d token(s)",
                    self.name, s.sid, reason, s.tokens_out)

    def _reap_cancelled(self) -> None:
        """Free slots of streams cancelled since the last boundary and drop
        cancelled entries still waiting (lock held)."""
        self._waiting = [w for w in self._waiting if w.state != "cancelled"]
        for s in list(self._streams.values()):
            if s.state == "cancelled":
                self._free_slot(s)

    def _join_waiting(self, now: float) -> List[GenStream]:
        """Assign free slots to waiting streams, highest priority class
        first, FIFO within a class (lock held)."""
        joined = []
        free = [i for i, oc in enumerate(self._occupants) if oc is None]
        if not free or not self._waiting:
            return joined
        order = sorted(
            range(len(self._waiting)),
            key=lambda i: (-self._waiting[i].priority, i),
        )
        winners = sorted(order[: len(free)])  # FIFO among the admitted
        for slot, wi in zip(free, winners):
            s = self._waiting[wi]
            s.slot = slot
            s.state = "prefill"
            s.last_token_ts = now
            self._occupants[slot] = s
            self.joins += 1
            joined.append(s)
        taken = set(winners)
        self._waiting = [
            w for i, w in enumerate(self._waiting) if i not in taken
        ]
        return joined

    def _pump(self) -> None:
        try:
            # grad mode and the current CUDA device are thread-local
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
            with torch.inference_mode():
                self._pump_loop()
        except BaseException as e:  # noqa: BLE001 — thread boundary
            with self._lock:
                self._error = e
                self._progress.notify_all()
            if not self._stop.is_set():
                log.exception("%s: slot pump failed", self.name)

    def _pump_loop(self) -> None:
        while not self._stop.is_set():
            self.heartbeat.beat()
            with self._work:
                self._reap_cancelled()
                self._sweep_deadlines(self.clock())
                joined = self._join_waiting(self.clock())
                have_prefill = any(
                    s is not None and s.state == "prefill"
                    for s in self._occupants)
                have_decode = any(
                    s is not None and s.state == "decoding"
                    for s in self._occupants)
                if not (joined or have_prefill or have_decode):
                    self._work.wait(0.05)
                    continue

            # ---- prefill: while decoding, up to prefill_priority pieces
            # per decode call (a long prompt never stalls live streams for
            # more); with the batch empty every joiner's next piece runs
            prefilling = [
                s for s in self._occupants
                if s is not None and s.state == "prefill" and not s.finished
            ]
            budget = (self.prefill_priority if have_decode
                      else max(1, len(prefilling)))
            for s in prefilling[:budget]:
                self._prefill_one(s)

            # ---- decode: k tokens for every active slot in one call
            # (k = min(chunk, min remaining): every stream completes
            # exactly at a call boundary)
            with self._lock:
                decoding = [
                    s for s in self._occupants
                    if s is not None and s.state == "decoding" and not s.finished
                ]
            if not decoding:
                continue
            k = max(1, min(self.chunk, min(s.max_new - s.gen for s in decoding)))
            active = np.zeros((self.slots,), np.int32)
            for s in decoding:
                active[s.slot] = 1
            if self._active_host is None or not np.array_equal(active, self._active_host):
                self._active_host, self._active = active, self._upload(active)
            self._cache, self._tok_vec, self._gen_vec, toks = self._decode_fn(k)(
                self._cache, self._tok_vec, self._gen_vec, self._active)
            # the one host copy per call: a yielded token must exist, not
            # merely be queued
            toks_host = toks.cpu().numpy()  # (slots, k)
            now = self.clock()
            with self._lock:
                self.decode_steps += 1
                self.tokens_total += k * len(decoding)
                a = 0.2  # EWMA horizon ~ last 5 calls
                self.tokens_per_step = (
                    len(decoding) if self.decode_steps == 1
                    else (1 - a) * self.tokens_per_step + a * len(decoding)
                )
                for s in decoding:
                    if s.finished:  # cancelled mid-call: tokens discarded
                        continue
                    row = toks_host[s.slot:s.slot + 1, :]  # (1, k)
                    s.gen += k
                    # per-token pace QoS: this call's own per-token rate
                    # against the stream's budget (its tokens are kept in
                    # the typed-expiry flush)
                    pace_blown = (
                        s.token_budget_s > 0.0
                        and (now - s.last_token_ts) / k > s.token_budget_s
                    )
                    s.last_token_ts = now
                    s.pending.append(row.astype(np.int32))
                    s.pending_n += k
                    if s.gen >= s.max_new:
                        self._finish(s, "done")
                    elif pace_blown:
                        self._evict(s, "token_budget")
                    else:
                        self._emit_boundary(s)

    def _prefill_one(self, s: GenStream) -> None:
        """One chunked-prefill step for a joining stream: reset its slot on
        first touch, run one piece, pick token 1 when the prompt is done.
        Device work runs OUTSIDE the lock."""
        if s.prefill_pos == 0:
            self._cache = self.model.reset_slot(self._cache, s.slot)
            s.prompt_dev = self._upload(s.prompt)
        tp = s.prompt.shape[1]
        n = min(self.prefill_chunk, tp - s.prefill_pos)
        toks = s.prompt_dev[:, s.prefill_pos:s.prefill_pos + n]
        self._cache, logits = self._prefill_fn(n)(self._cache, toks, s.slot)
        s.prefill_pos += n
        with self._lock:
            self.prefill_chunks += 1
        if s.prefill_pos < tp:
            return
        # prompt fully prefilled: token 1 (the raw gen_seed key, as the
        # unslotted prefill picks it)
        t1 = self.model.pick_first(logits)
        self._tok_vec[s.slot] = t1[0]
        self._gen_vec[s.slot] = 1
        t1_host = int(t1[0])
        now = self.clock()
        with self._lock:
            s.prompt_dev = None
            if s.finished:  # cancelled during prefill
                return
            s.gen = 1
            self.tokens_total += 1  # token 1 comes from the prefill pick
            s.last_token_ts = now
            s.pending.append(np.array([[t1_host]], np.int32))
            s.pending_n = 1
            if s.max_new <= 1:
                self._finish(s, "done")
            else:
                s.state = "decoding"
                self._emit_boundary(s)

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

* **shared-prefix KV cache** (:class:`PrefixCache`, optional): a joining
  prompt attaches the published KV pages of its longest cached run of
  grain chunks and prefills from the first uncached token; as its own
  prefill crosses grain boundaries it publishes copies of the pages it
  wrote.  The grain is a multiple of ``prefill_chunk``, so a warm stream's
  remaining chunks fall on the grid a cold prefill uses and its tokens are
  a cold run's.

* **device-resource resilience**: every model call runs inside
  ``resilience.device_call`` (the ``device.oom`` / ``device.lost`` fault
  sites, torch's OOM and sticky CUDA errors typed).  An OOM sheds the
  lowest-priority occupant (its emitted tokens kept, a typed final chunk
  with ``evicted: oom``) and retries the step on the smaller set; a device
  loss hands every live stream off (``evicted: device_lost``) and calls
  the ``on_device_lost`` hook, or re-raises without one.  The cache is
  written in place, so each step's write positions are saved before it
  and restored when it fails: the retry writes where the failed step did.

:class:`SimSlotModel` is a host-only model with the slot model's interface
and a token oracle, for driving the scheduler without a transformer; its
chaos twins (``fail_next``, ``oom_at_step``, ``lost_at_step``) raise the
typed device errors.

* **stream continuity** (``core/continuity.py``): with a resume signature
  armed, every chunk carries resume state, and a shed, device-lost or
  drained stream's final chunk is a resumable hand-off (``goaway`` meta)
  the client migrates.  :meth:`SlotEngine.begin_goaway` hands every live
  stream off at the next token boundary (a drain, or a slot-width resize,
  which :meth:`SlotEngine.end_goaway` rescinds when the rebuild fails).  A
  RESUME join prefills prompt + prefix[:-1] (the prefix comes to the card
  once, on the pump thread, with the prompt) and decodes on from the
  prefix's last token at the absolute step R, so the remaining tokens are
  an uninterrupted run's.  :meth:`SlotEngine.adopt_ledger` carries the
  cumulative counters into a rebuilt engine.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .continuity import GOAWAY_META, PREFIX_GRAIN, RESUME_META, prefix_digests, prompt_digest
from .liveness import DEADLINE_META, ThreadBeat
from .log import get_logger
from .resilience import DeviceLostError, DeviceOomError, device_call

log = get_logger("slots")

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


class PrefixEntry:
    """One published grain chunk of a shared prefix: the page blob (a copy,
    never a view into a live slot) of prompt positions ``[index * grain,
    (index + 1) * grain)``, keyed by its chain digest, with the refcount
    that fences its reclamation."""

    __slots__ = ("digest", "index", "pages", "tokens", "nbytes", "refs", "last_used")

    def __init__(self, digest: str, index: int, pages, tokens: int, nbytes: int, now: float):
        self.digest = digest
        self.index = int(index)
        self.pages = pages          # model-opaque blob (attach interprets it)
        self.tokens = int(tokens)
        self.nbytes = int(nbytes)
        self.refs = 0
        self.last_used = now


class PrefixCache:
    """Refcounted pool of shared-prefix KV pages.

    * keyed by chain digests (:func:`~.continuity.prefix_digests`): entry
      *i* is valid only under the prefix that produced chunks ``0..i-1``;
    * :meth:`publish` stores copies exported at a grain boundary (the
      publishing slot keeps its own pages);
    * :meth:`acquire` pins (``refs += 1``) the longest run of consecutive
      cached chunks from index 0; the engine holds the pins for the
      stream's slot occupancy, so eviction (LRU past ``cap_entries`` or
      ``cap_bytes``) and :meth:`trim` only take entries with ``refs == 0``.

    Accounting is exact: one hit (and its ``hit_tokens``) or one miss per
    eligible lookup, one publish per entry stored, one eviction per entry
    reclaimed.  Bytes are the pages' tensors' ``nbytes``."""

    def __init__(self, grain: int = PREFIX_GRAIN, cap_entries: int = 256, cap_bytes: int = 0,
                 clock: Callable[[], float] = time.monotonic):
        self.grain = max(1, int(grain))
        self.cap_entries = max(1, int(cap_entries))
        self.cap_bytes = max(0, int(cap_bytes))
        self.clock = clock
        self._lock = threading.Lock()
        self._entries: "OrderedDict[str, PrefixEntry]" = OrderedDict()
        self.bytes = 0
        # exact counters (lock-held writes, GIL-atomic reads)
        self.hits = 0
        self.misses = 0
        self.publishes = 0
        self.evictions = 0
        self.hit_tokens = 0   # prefill tokens skipped by attaching

    @staticmethod
    def _nbytes(pages) -> int:
        """Bytes of a page blob (dicts and lists of tensors or arrays;
        anything else counts a nominal 8)."""
        n = 0
        stack = [pages]
        while stack:
            x = stack.pop()
            if isinstance(x, dict):
                stack.extend(x.values())
            elif isinstance(x, (list, tuple)):
                stack.extend(x)
            else:
                n += int(getattr(x, "nbytes", 8))
        return n

    def acquire(self, digests: List[str]) -> List[PrefixEntry]:
        """Pin the longest run of consecutive cached chunks from index 0.
        Counts one hit (and its tokens) for a non-empty run, else one miss.
        Balance with :meth:`release` exactly once."""
        with self._lock:
            run: List[PrefixEntry] = []
            for i, d in enumerate(digests):
                e = self._entries.get(d)
                if e is None or e.index != i:
                    break
                run.append(e)
            if run:
                now = self.clock()
                for e in run:
                    e.refs += 1
                    e.last_used = now
                    self._entries.move_to_end(e.digest)
                self.hits += 1
                self.hit_tokens += sum(e.tokens for e in run)
            else:
                self.misses += 1
            return run

    def release(self, entries: List[PrefixEntry]) -> None:
        with self._lock:
            for e in entries:
                e.refs = max(0, e.refs - 1)

    def contains(self, digest: str) -> bool:
        with self._lock:
            return digest in self._entries

    def publish(self, digest: str, index: int, pages, tokens: int) -> bool:
        """Store one exported grain chunk.  False (not stored) when the
        digest is present, or every evictable entry is pinned and the caps
        leave no room."""
        nbytes = self._nbytes(pages)
        with self._lock:
            if digest in self._entries or not self._make_room_locked(nbytes):
                return False
            self._entries[digest] = PrefixEntry(digest, index, pages, tokens, nbytes,
                                                self.clock())
            self.bytes += nbytes
            self.publishes += 1
            return True

    def _make_room_locked(self, incoming: int) -> bool:
        def over() -> bool:
            return (len(self._entries) + 1 > self.cap_entries
                    or (self.cap_bytes > 0 and self.bytes + incoming > self.cap_bytes))

        while over():
            victim = next((e for e in self._entries.values() if e.refs == 0), None)
            if victim is None:
                return False  # everything pinned: refuse, never reclaim
            self._evict_locked(victim)
        return True

    def _evict_locked(self, e: PrefixEntry) -> None:
        del self._entries[e.digest]
        self.bytes -= e.nbytes
        self.evictions += 1

    def trim(self) -> int:
        """Reclaim every entry with ``refs == 0``; returns how many."""
        with self._lock:
            cold = [e for e in self._entries.values() if e.refs == 0]
            for e in cold:
                self._evict_locked(e)
            return len(cold)

    def clear(self) -> int:
        """Drop every entry, pinned ones too."""
        with self._lock:
            n = len(self._entries)
            self.evictions += n
            self._entries.clear()
            self.bytes = 0
            return n

    def hot_digests(self, k: int = 8) -> List[str]:
        """The ``k`` most recently used digests, cut to 12 characters."""
        with self._lock:
            es = sorted(self._entries.values(), key=lambda e: -e.last_used)[:k]
            return [e.digest[:12] for e in es]

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "prefix_hits": self.hits,
                "prefix_misses": self.misses,
                "prefix_publishes": self.publishes,
                "prefix_evictions": self.evictions,
                "prefix_entries": len(self._entries),
                "prefix_refs": sum(e.refs for e in self._entries.values()),
                "prefix_bytes": self.bytes,
                "prefix_hit_tokens": self.hit_tokens,
            }


class GenStream:
    """One generation stream: a prompt waiting for or occupying a slot.

    ``frame`` is the source TensorFrame (emitted chunks inherit its meta
    through ``with_tensors``); tokens accumulate in ``pending`` until a
    chunk boundary or a terminal event flushes them."""

    __slots__ = (
        "sid", "frame", "prompt", "prompt_dev", "max_new", "chunk", "tenant",
        "priority", "deadline_ts", "token_budget_s", "state", "slot",
        "prefill_pos", "gen", "pending", "pending_n", "chunk_index",
        "tokens_out", "last_token_ts", "submitted_ts", "joined_ts", "evict_reason",
        # shared-prefix cache: the chain digests of the prompt's eligible
        # chunks, the pinned entries it attached (released with the slot),
        # and the next chunk index to publish as prefill crosses a boundary
        "prefix_digests", "prefix_entries", "prefix_pub_i",
        # stream continuity: what the prefill runs over (the prompt, or the
        # prompt + prefix[:-1] of a resume), the checkpoint a resume decodes
        # on from, and the resume state stamped into emitted meta
        "prefill_src", "resume_tok", "resume_gen", "resume_info",
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
        self.submitted_ts = now  # the TTFT origin
        self.joined_ts: Optional[float] = None  # when it took its slot
        self.evict_reason: Optional[str] = None
        self.prefix_digests: List[str] = []
        self.prefix_entries: List[PrefixEntry] = []
        self.prefix_pub_i = 0
        self.prefill_src = prompt         # prompt (+ prefix[:-1] on resume)
        self.resume_tok = 0               # the prefix's last token (resume)
        self.resume_gen = 0               # tokens already delivered (resume)
        self.resume_info: Optional[Dict[str, Any]] = None

    @property
    def finished(self) -> bool:
        return self.state in DONE_STATES


class SimSlotModel:
    """A host-only simulated slot model: :class:`SlotEngine`'s model
    interface over a token recurrence with modelled step costs (each
    decode call pays a base that does not depend on the batch plus a small
    increment per active slot), so the scheduler runs without a
    transformer or a card.

    Token oracle: token 1 = ``sum(prompt) % vocab``, token j+1 = ``(31 *
    t_j + 17) % vocab``.  A slot's "pages" are its position and the
    running prompt sum of its chunked prefill.

    Chaos twins: decode ATTEMPT ``oom_at_step`` / ``lost_at_step`` (0-based;
    the counter advances on faulted attempts, so the engine's retry
    proceeds) raises ``DeviceOomError`` / ``DeviceLostError`` once, and
    ``fail_next("oom"|"lost")`` arms the next attempt.  A fault fires
    before any state changes."""

    device = torch.device("cpu")

    def __init__(self, slots: int, vocab: int = 997, step_base_ms: float = 1.0,
                 step_per_slot_ms: float = 0.05, prefill_ms_per_token: float = 0.02,
                 sleep=time.sleep, oom_at_step: Optional[int] = None,
                 lost_at_step: Optional[int] = None):
        self.slots = int(slots)
        self.vocab = int(vocab)
        self.step_base_s = step_base_ms * 1e-3
        self.step_per_slot_s = step_per_slot_ms * 1e-3
        self.prefill_s_per_token = prefill_ms_per_token * 1e-3
        self._sleep = sleep
        # running prompt sum per slot: token 1 covers the whole prompt
        # across chunk boundaries
        self._prefill_carry: Dict[int, int] = {}
        self.oom_at_step = oom_at_step
        self.lost_at_step = lost_at_step
        self._attempts = 0
        self._pending_fault: Optional[str] = None

    def fail_next(self, kind: str) -> None:
        """Arm the NEXT decode attempt to raise the typed device error
        (``"oom"`` | ``"lost"``), race-free against a running pump."""
        if kind not in ("oom", "lost"):
            raise ValueError(f"fail_next({kind!r}): want oom|lost")
        self._pending_fault = kind

    def init_cache(self):
        return {"pos": np.zeros((self.slots,), np.int64)}

    def reset_slot(self, cache, slot):
        cache = {"pos": cache["pos"].copy()}
        cache["pos"][int(slot)] = 0
        self._prefill_carry[int(slot)] = 0
        return cache

    def export_prefix(self, cache, slot, start: int, stop: int):
        """The pages of ``[start, stop)``: the carry at ``stop`` (the engine
        exports when ``prefill_pos == stop``, where the carry covers
        ``[0, stop)``)."""
        del cache, start
        return {"carry": int(self._prefill_carry.get(int(slot), 0)), "n": int(stop)}

    def attach_prefix(self, cache, slot, pages_list, n: int):
        """Restore the last chunk's carry and set the slot's position to
        ``n``: a cold prefill paused at ``prefill_pos == n``."""
        cache = {"pos": cache["pos"].copy()}
        cache["pos"][int(slot)] = n
        self._prefill_carry[int(slot)] = int(pages_list[-1]["carry"])
        return cache

    def prefill_fn(self, n: int):
        def fn(cache, toks, slot):
            toks = np.asarray(toks)
            self._sleep(self.prefill_s_per_token * toks.shape[1])
            cache = {"pos": cache["pos"].copy()}
            cache["pos"][int(slot)] += toks.shape[1]
            tot = (self._prefill_carry.get(int(slot), 0) + int(toks.sum())) % self.vocab
            self._prefill_carry[int(slot)] = tot
            logits = torch.zeros((1, self.vocab))  # one-hot at token 1
            logits[0, tot] = 1.0
            return cache, logits

        return fn

    def pick_first(self, logits: torch.Tensor) -> torch.Tensor:
        return logits.argmax(dim=-1).to(torch.int32)

    def step_token(self, t: int) -> int:
        return (31 * int(t) + 17) % self.vocab

    def decode_fn(self, k: int):
        def fn(cache, tok, gen, active):
            idx = self._attempts
            self._attempts += 1
            pending, self._pending_fault = self._pending_fault, None
            if pending == "lost" or (self.lost_at_step is not None and idx == self.lost_at_step):
                raise DeviceLostError("sim: simulated device loss", device_ids=(0,))
            if pending == "oom" or (self.oom_at_step is not None and idx == self.oom_at_step):
                raise DeviceOomError("sim: simulated card-memory exhaustion")
            act = np.asarray(active)
            self._sleep(k * (self.step_base_s + self.step_per_slot_s * int(act.sum())))
            tok = np.array(tok)
            gen = np.array(gen)
            toks = np.zeros((self.slots, k), np.int32)
            for step in range(k):
                for slot in range(self.slots):
                    if act[slot]:
                        tok[slot] = self.step_token(tok[slot])
                        toks[slot, step] = tok[slot]
                gen = gen + act
            cache = {"pos": cache["pos"] + k * act.astype(np.int64)}
            return (cache, torch.from_numpy(tok), torch.from_numpy(gen.astype(np.int32)),
                    torch.from_numpy(toks))

        return fn


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
    #: at the deadline.  Evictions happen between decode calls, so a call
    #: is cut (fewer tokens, :meth:`_deadline_k`) to end before the nearest
    #: deadline less this margin, reckoned by :meth:`decode_call_s`; a
    #: stream that a one-token call would carry past it is evicted at this
    #: boundary.  Before the first measurement the margin is this constant
    #: alone, as in the JAX engine.
    EVICT_MARGIN_S = 0.05

    def __init__(self, model, *, max_seq: int, chunk: int = 8,
                 prefill_chunk: int = 32, prefill_priority: int = 1,
                 token_budget_s: float = 0.0,
                 clock: Callable[[], float] = time.monotonic,
                 name: str = "slots",
                 prefix_cache: Optional[PrefixCache] = None,
                 on_device_lost: Optional[Callable[..., Any]] = None,
                 slo=None, resume_sig: Optional[str] = None):
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
        # shared-prefix page pool (None: off, no digests, attach, publish or
        # snapshot keys).  The grain must land on the prefill chunk grid,
        # or a warm stream's chunks would differ from a cold run's
        self.prefix = prefix_cache
        if prefix_cache is not None and prefix_cache.grain % self.prefill_chunk != 0:
            raise ValueError(
                f"prefix grain {prefix_cache.grain} must be a multiple of prefill_chunk "
                f"{self.prefill_chunk} (a warm stream must prefill on a cold run's chunks)")
        # the pump beats once per loop: pending work with a stale beat
        # means a wedged pump (stuck in a device call)
        self.heartbeat = ThreadBeat(f"{name}-slots", clock=clock)
        # ``on_device_lost(err) -> model | None`` rebuilds the model after a
        # device loss (None: recovered in place); without a hook, or when
        # it raises, the loss is sticky and supervision restarts the element
        self.on_device_lost = on_device_lost
        # per-stream SLO accounting (telemetry.SloTracker): one TTFT at the
        # first-token pick, one record_n per decode call, one outcome per
        # finished stream, all on the pump thread (the tracker's single
        # writer); None costs nothing
        self.slo = slo
        # stream continuity: with a signature, every chunk carries resume
        # state and a drain hands live streams off resumably; None: no
        # stamping, and a drain lets streams finish in place
        self.resume_sig = resume_sig
        self._goaway = False

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
        # EWMA of a decode call's wall seconds, by its token count k
        self.decode_call_wall: Dict[int, float] = {}
        self.deadline_cut_calls = 0    # decode calls cut short for a deadline
        self.resumes = 0              # streams joined by a RESUME request
        self.goaway_evicted = 0       # live streams handed off on a drain
        self.oom_retries = 0          # device steps retried after an OOM
        self.oom_sheds = 0            # slots shed to relieve card memory
        self.device_lost = 0          # device-loss events seen
        self.device_lost_evicted = 0  # live streams handed off on a loss
        self.remeshes = 0             # models rebuilt after a loss

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> None:
        self._stop.clear()
        self._error = None
        self._goaway = False
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
            for s in self._streams.values():
                self._release_prefix(s)
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
               deadline_ts: Optional[float] = None,
               resume: Optional[Dict[str, Any]] = None) -> GenStream:
        """Queue one prompt for a slot.  ``prompt`` is host int32 (1, Tp),
        already validated against ``max_seq`` by the caller.

        ``resume`` = ``{"prefix": (1, R) host int32, "tokens_done": R}``
        joins a checkpointed stream: the prefill runs over prompt +
        prefix[:-1], decode goes on from the prefix's last token at the
        absolute step R, and emitted ``tokens_done`` and ``chunk_index``
        continue from R.  The caller validated signature, digest and
        shape; R = 0 is a fresh join (the client drops the overlap)."""
        with self._lock:
            if self._error is not None:
                raise self._error
            self._sid += 1
            s = GenStream(
                self._sid, frame, prompt, max_new, chunk,
                tenant=tenant, priority=priority, deadline_ts=deadline_ts,
                token_budget_s=self.token_budget_s, now=self.clock(),
            )
            if self.resume_sig is not None:
                s.resume_info = {"v": 1, "sig": self.resume_sig,
                                 "digest": prompt_digest(prompt), "chunk": int(s.chunk)}
            if resume is not None:
                self.resumes += 1
                r = int(resume.get("tokens_done", 0))
                if r > 0:
                    prefix = np.asarray(resume["prefix"], dtype=np.int32)
                    s.prefill_src = (np.concatenate([prompt, prefix[:, :r - 1]], axis=1)
                                     .astype(np.int32) if r > 1 else prompt)
                    s.resume_tok = int(prefix[0, r - 1])
                    s.resume_gen = r
                    s.tokens_out = r
                    s.chunk_index = r // s.chunk
            self._streams[s.sid] = s
            self._waiting.append(s)
            self._work.notify_all()
            return s

    def begin_goaway(self) -> None:
        """Drain hand-off: from the next token boundary on, every live
        stream (decoding, prefilling or waiting) ends with a resumable final
        chunk (partial tokens, resume state, the ``goaway`` marker) and
        frees its slot, so its client migrates it.  Without a resume
        signature this only warns: a hand-off the client cannot resume
        would cut the stream short."""
        if self.resume_sig is None:
            log.warning("%s: drain without resume state armed: live streams finish in "
                        "place instead of migrating", self.name)
            return
        with self._work:
            self._goaway = True
            self._work.notify_all()

    def end_goaway(self) -> None:
        """Rescind a hand-off (a resize whose rebuild failed keeps this
        engine serving): streams already handed off resume here or
        elsewhere; new joins are no longer swept."""
        with self._work:
            self._goaway = False

    #: the cumulative counters that survive a rebuild in place (a slot-width
    #: resize): a server's digests and the fleet's exact totals read them,
    #: so they never move backwards
    _LEDGER_ATTRS = (
        "joins", "completions", "evictions", "cancellations",
        "decode_steps", "prefill_chunks", "tokens_total", "resumes",
        "goaway_evicted", "oom_retries", "oom_sheds", "device_lost",
        "device_lost_evicted", "remeshes",
    )

    def adopt_ledger(self, other: "SlotEngine") -> None:
        """Carry ``other``'s cumulative counters into this engine (before
        :meth:`start`): a resize replaces the engine, not the server."""
        for attr in self._LEDGER_ATTRS:
            setattr(self, attr, getattr(other, attr))
        self.tokens_per_step = other.tokens_per_step
        self.decode_call_wall = dict(other.decode_call_wall)

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
            snap = {
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
                "gen_jit_buckets": len(self._prefill_lru) + len(self._decode_lru),
                "gen_resumes": self.resumes,
                "gen_goaway_evicted": self.goaway_evicted,
                "gen_oom_retries": self.oom_retries,
                "gen_oom_sheds": self.oom_sheds,
                "gen_device_lost": self.device_lost,
                "gen_device_lost_evicted": self.device_lost_evicted,
                "gen_remeshes": self.remeshes,
            }
        if self.prefix is not None:
            snap.update(self.prefix.snapshot())
        return snap

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
        if s.resume_info is not None:
            # every chunk is a checkpoint: its tokens so far plus this state
            # rebuild the stream on any server with the same signature
            out.meta[RESUME_META] = s.resume_info
        if extra_meta:
            out.meta.update(extra_meta)
            if extra_meta.get("deadline_expired"):
                # the typed expiry IS the answer to the deadline: no element
                # downstream may drop it as late (late-policy)
                out.meta.pop(DEADLINE_META, None)
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

    def _release_prefix(self, s: GenStream) -> None:
        """Unpin the stream's attached prefix entries, exactly once (lock
        held)."""
        if self.prefix is not None and s.prefix_entries:
            self.prefix.release(s.prefix_entries)
            s.prefix_entries = []

    def _attach_prefix(self, s: GenStream) -> None:
        """First-touch lookup (pump thread, after the slot reset): digest
        the prefill source at grain boundaries, pin the longest cached run
        and write its pages into the slot, so prefill starts at the first
        uncached token.  At most ``(tp - 1) // grain`` chunks: the last
        token always prefills (its logits pick token 1).  A source with no
        such chunk is neither a hit nor a miss.  A resume's source starts
        with the prompt's bytes, so it attaches the same pages."""
        pc = self.prefix
        max_chunks = (int(s.prefill_src.shape[1]) - 1) // pc.grain
        if max_chunks <= 0:
            return
        s.prefix_digests = prefix_digests(s.prefill_src, pc.grain)[:max_chunks]
        entries = pc.acquire(s.prefix_digests)
        s.prefix_pub_i = len(entries)
        if not entries:
            return
        n = sum(e.tokens for e in entries)
        self._cache = self.model.attach_prefix(self._cache, s.slot, [e.pages for e in entries], n)
        with self._lock:
            s.prefix_entries = entries
        s.prefill_pos = n

    def _publish_prefix(self, s: GenStream) -> None:
        """After a prefill piece: when ``prefill_pos`` lands on the next
        unpublished grain boundary, export that chunk's pages (a copy) and
        publish them under its chain digest.  Every boundary is reached,
        since the grain is a ``prefill_chunk`` multiple."""
        pc = self.prefix
        g = pc.grain
        while s.prefix_pub_i < len(s.prefix_digests):
            i = s.prefix_pub_i
            if (i + 1) * g != s.prefill_pos:
                return  # boundary not (yet) reached
            d = s.prefix_digests[i]
            if not pc.contains(d):
                pc.publish(d, i, self.model.export_prefix(self._cache, s.slot, i * g, (i + 1) * g),
                           g)
            s.prefix_pub_i += 1

    def _free_slot(self, s: GenStream) -> None:
        """Release the stream's slot (lock held); the idle mask clears at
        the next decode call."""
        if s.slot is not None:
            self._occupants[s.slot] = None
        self._release_prefix(s)
        s.prompt_dev = None
        self._streams.pop(s.sid, None)

    def _finish(self, s: GenStream, state: str,
                extra_meta: Optional[Dict[str, Any]] = None) -> None:
        s.state = state
        if state == "done":
            self.completions += 1
            self._slo_stream(s, "good")
            self._emit_terminal(s)
        elif state == "evicted":
            self.evictions += 1
            # typed expiry (deadline or pace): the SLO ledger counts it
            # expired, never goodput
            self._slo_stream(s, "expired")
            self._emit_terminal(s, extra_meta=extra_meta or {})
        # cancelled: the consumer is gone — nothing to emit
        self._free_slot(s)

    def decode_call_s(self, k: int) -> float:
        """The reckoned wall seconds of a ``k``-token decode call (lock
        held): ``a + b*k``, a fixed cost per call (the host's loop and
        sync) plus a cost per token, fitted by least squares over the
        measured wall of each k the engine has run (:attr:`decode_call_wall`).
        With one k measured the two cannot be told apart, so the whole wall
        counts as fixed below that k and as per-token above it: a bound no
        call of the linear model exceeds.  0.0 before any measurement."""
        pts = self.decode_call_wall
        if len(pts) < 2:
            if not pts:
                return 0.0
            (k0, t0), = pts.items()
            return t0 * max(1.0, k / k0)
        ks, ts = np.array(list(pts.keys()), np.float64), np.array(list(pts.values()))
        dk = ks - ks.mean()
        b = max(0.0, float(dk @ (ts - ts.mean()) / (dk @ dk)))
        a = float(ts.mean()) - b * float(ks.mean())
        if a < 0.0:  # through the origin: no call is free
            a, b = 0.0, float(ks @ ts / (ks @ ks))
        return a + b * k

    def _deadline_k(self, k: int, now: float) -> int:
        """``k`` decode tokens, cut so the call (reckoned by
        :meth:`decode_call_s`) ends before the nearest live deadline less
        :attr:`EVICT_MARGIN_S`; at least 1 (lock held).  The tokens are the
        same: a stream's chunks are cut by its own grain, not by the call."""
        nearest = min((s.deadline_ts for s in self._streams.values()
                       if not s.finished and s.deadline_ts is not None), default=None)
        if nearest is None or not self.decode_call_wall:
            return k
        end = nearest - self.EVICT_MARGIN_S - now
        fit = k
        while fit > 1 and self.decode_call_s(fit) > end:
            fit -= 1
        if fit < k:
            self.deadline_cut_calls += 1
        return fit

    def _slo_stream(self, s: GenStream, outcome: str) -> None:
        if self.slo is not None:
            self.slo.note_stream(s.tenant, outcome)

    def _sweep_deadlines(self, now: float) -> None:
        """Evict streams whose request deadline is blown, waiting ones
        included (lock held).  The typed-expiry chunk keeps partial
        tokens."""
        for s in list(self._streams.values()):
            if s.finished:
                continue
            # a one-token call must still end inside the margin
            if not (s.deadline_ts is not None
                    and now + self.decode_call_s(1) >= s.deadline_ts - self.EVICT_MARGIN_S):
                continue
            if s.state == "waiting":
                self._waiting.remove(s)
            self._evict(s, "deadline")

    def _evict(self, s: GenStream, reason: str) -> None:
        """Typed-expiry eviction (lock held): partial tokens flush with the
        eviction meta, the slot frees at this boundary."""
        s.evict_reason = reason
        self._finish(s, "evicted", extra_meta={
            "evicted": reason, "deadline_expired": True,
        })
        log.warning("%s: stream %d evicted (%s) after %d token(s)",
                    self.name, s.sid, reason, s.tokens_out)

    def _handoff_one(self, s: GenStream, reason: str) -> None:
        """Close ONE live stream with a resumable final chunk and free its
        slot (lock held): a migration, not a failure, so no
        ``deadline_expired`` marker; partial tokens ride the chunk with
        ``evicted: reason``, and with a resume signature the ``goaway``
        marker and the resume state let the client continue elsewhere.
        Without one the chunk still closes the stream typed."""
        if s.state == "waiting":
            try:
                self._waiting.remove(s)
            except ValueError:
                pass
        s.state = "evicted"
        s.evict_reason = reason
        extra: Dict[str, Any] = {"evicted": reason}
        if self.resume_sig is not None:
            extra[GOAWAY_META] = True  # the client migrates; tokens survive
        self._emit_terminal(s, extra_meta=extra)
        self._free_slot(s)

    def _sweep_goaway(self) -> None:
        """Drain hand-off (lock held): every live stream ends with a
        resumable GOAWAY final chunk and frees its slot.  Runs at every
        boundary while draining, so streams admitted during the drain hand
        off too."""
        for s in list(self._streams.values()):
            if s.finished:
                continue
            self._handoff_one(s, "goaway")
            self.goaway_evicted += 1
            log.info("%s: stream %d handed off on drain after %d token(s)",
                     self.name, s.sid, s.tokens_out)

    # -- device-resource resilience (degrade, don't die) ---------------------
    def _device_step(self, fn, *args):
        """Every model call of the pump goes through the classification
        boundary (``device_call``): the recovery below keys on types."""
        return device_call(fn, *args)

    def _save_positions(self):
        """The cache's write positions before a step (a failed step may
        have advanced them part-way: the cache is written in place)."""
        save = getattr(self.model, "save_positions", None)
        return save(self._cache) if save is not None else self._cache

    def _restore_positions(self, saved) -> None:
        restore = getattr(self.model, "restore_positions", None)
        if restore is not None:
            restore(self._cache, saved)
        else:
            self._cache = saved  # a functional cache: the step made a new one

    def _handle_oom(self) -> None:
        """Card memory ran out mid-step: shed the LOWEST-priority occupant
        (the latest joined among equals) with its tokens so far, freeing
        its slot, then let the failed step retry on the smaller set.
        Never a restart, never a poisoned frame."""
        with self._lock:
            self.oom_retries += 1
            live = [s for s in self._occupants if s is not None and not s.finished]
            if not live:
                return  # nothing held: the bare retry is the relief
            victim = min(live, key=lambda s: (s.priority, -(s.joined_ts or 0.0)))
            self.oom_sheds += 1
            self._handoff_one(victim, "oom")
            log.warning("%s: device OOM: shed stream %d (priority %d, %d token(s) kept) and "
                        "retrying the step", self.name, victim.sid, victim.priority,
                        victim.tokens_out)

    def _reset_device_state(self) -> None:
        """Fresh cache and zeroed token and count vectors, after every
        occupant was handed off (device-loss recovery)."""
        self._cache = self.model.init_cache()
        with torch.inference_mode():
            self._tok_vec = torch.zeros(self.slots, dtype=torch.int32, device=self.device)
            self._gen_vec = torch.zeros(self.slots, dtype=torch.int32, device=self.device)
        self._active_host = None
        self._prefill_lru.clear()
        self._decode_lru.clear()
        if self.prefix is not None:
            self.prefix.clear()  # every reader was handed off: nothing pinned

    def _handle_device_lost(self, err: DeviceLostError) -> None:
        """The card was lost under the batch: hand EVERY live stream off,
        then rebuild through the ``on_device_lost`` hook and keep serving.
        Without a hook (or when it raises) the loss is sticky: the pump
        fails and supervision restarts the element."""
        handed = 0
        with self._lock:
            self.device_lost += 1
            for s in list(self._streams.values()):
                if s.finished:
                    continue
                self._handoff_one(s, "device_lost")
                self.device_lost_evicted += 1
                handed += 1
        hook = self.on_device_lost
        if hook is None:
            raise err
        replacement = hook(err)  # raises = unrecoverable: sticky error
        with self._lock:
            if replacement is not None:
                self.model = replacement
            self.remeshes += 1
        self._reset_device_state()
        log.warning("%s: device lost (%s): %d stream(s) handed off, model rebuilt (#%d)",
                    self.name, err, handed, self.remeshes)

    def _reap_cancelled(self) -> None:
        """Free slots of streams cancelled since the last boundary and drop
        cancelled entries still waiting (lock held)."""
        self._waiting = [w for w in self._waiting if w.state != "cancelled"]
        for s in list(self._streams.values()):
            if s.state == "cancelled":
                # classified here, on the pump thread, once per stream
                self._slo_stream(s, "evicted")
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
            s.joined_ts = now
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
                if self._goaway:
                    self._sweep_goaway()
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
            try:
                for s in prefilling[:budget]:
                    self._prefill_one(s)
            except DeviceOomError:
                # prefill is re-entrant (prefill_pos advances only on
                # success): shed a slot and re-run next iteration
                self._handle_oom()
                continue
            except DeviceLostError as e:
                self._handle_device_lost(e)
                continue

            # ---- decode: k tokens for every active slot in one call
            # (k = min(chunk, min remaining): every stream completes
            # exactly at a call boundary)
            with self._lock:
                # the prefill pieces above took time: a deadline they
                # brought within one token is answered now
                self._sweep_deadlines(self.clock())
                decoding = [
                    s for s in self._occupants
                    if s is not None and s.state == "decoding" and not s.finished
                ]
                if not decoding:
                    continue
                k = self._deadline_k(
                    max(1, min(self.chunk, min(s.max_new - s.gen for s in decoding))),
                    self.clock())
            active = np.zeros((self.slots,), np.int32)
            for s in decoding:
                active[s.slot] = 1
            if self._active_host is None or not np.array_equal(active, self._active_host):
                self._active_host, self._active = active, self._upload(active)
            saved = self._save_positions()
            t_call = self.clock()
            try:
                self._cache, self._tok_vec, self._gen_vec, toks = self._device_step(
                    self._decode_fn(k), self._cache, self._tok_vec, self._gen_vec,
                    self._active)
            except DeviceOomError:
                # tok/gen are reassigned only on success; the positions the
                # step advanced go back, then the lowest-priority slot is
                # shed and the step retries on the smaller batch
                self._restore_positions(saved)
                self._handle_oom()
                continue
            except DeviceLostError as e:
                self._handle_device_lost(e)
                continue
            # the one host copy per call: a yielded token must exist, not
            # merely be queued
            toks_host = toks.cpu().numpy()  # (slots, k)
            now = self.clock()
            with self._lock:
                a = 0.2  # EWMA horizon ~ last 5 calls
                wall, prev = max(0.0, now - t_call), self.decode_call_wall.get(k)
                self.decode_call_wall[k] = wall if prev is None else (1 - a) * prev + a * wall
                self.decode_steps += 1
                self.tokens_total += k * len(decoding)
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
                    # SLO per-token inter-arrival: the call's k tokens as k
                    # observations of the same pace (one bucket increment)
                    if self.slo is not None:
                        self.slo.note_tokens(s.tenant, max(0.0, now - s.last_token_ts), k)
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
        """One chunked-prefill step for a joining stream: reset its slot and
        attach its cached prefix on first touch, run one piece, publish the
        grain chunks it completed, pick token 1 when the prompt is done.
        Device work runs OUTSIDE the lock.

        A RESUME join prefills ``prefill_src`` (prompt + prefix[:-1]) on the
        same chunk grid, then skips the pick: the next decode input is the
        prefix's last token at the absolute step ``resume_gen``."""
        if s.prompt_dev is None:
            self._cache = self.model.reset_slot(self._cache, s.slot)
            s.prompt_dev = self._upload(s.prefill_src)
            if self.prefix is not None:
                self._attach_prefix(s)
        tp = s.prefill_src.shape[1]
        n = min(self.prefill_chunk, tp - s.prefill_pos)
        toks = s.prompt_dev[:, s.prefill_pos:s.prefill_pos + n]
        saved = self._save_positions()
        try:
            self._cache, logits = self._device_step(self._prefill_fn(n), self._cache, toks,
                                                    s.slot)
        except (DeviceOomError, DeviceLostError):
            self._restore_positions(saved)
            raise
        s.prefill_pos += n
        if self.prefix is not None:
            self._publish_prefix(s)
        with self._lock:
            self.prefill_chunks += 1
        if s.prefill_pos < tp:
            return
        if s.resume_gen:
            # a checkpointed restart: no pick and no token-1 chunk, the
            # client holds tokens 1..resume_gen already
            self._tok_vec[s.slot] = s.resume_tok
            self._gen_vec[s.slot] = s.resume_gen
            now = self.clock()
            with self._lock:
                s.prompt_dev = None
                if s.finished:  # cancelled or handed off during prefill
                    return
                s.gen = s.resume_gen
                s.last_token_ts = now
                if s.resume_gen >= s.max_new:
                    self._finish(s, "done")  # nothing left to decode
                else:
                    s.state = "decoding"
            return
        # prompt fully prefilled: token 1 (the raw gen_seed key, as the
        # unslotted prefill picks it)
        t1 = self.model.pick_first(logits)
        self._tok_vec[s.slot] = t1[0]
        self._gen_vec[s.slot] = 1
        t1_host = int(t1[0])
        now = self.clock()
        if self.slo is not None:  # one TTFT per first token
            self.slo.note_ttft(s.tenant, max(0.0, now - s.submitted_ts))
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

"""tensor_generator: streaming autoregressive generation.

Port of ``nnstreamer_tpu/elements/generator.py``: ONE prompt frame in,
token CHUNKS out as they decode; downstream elements run concurrently
with the next chunk's decode on their own threads.  The model is the zoo
transformer (``custom=`` in its dialect), built on the card unless
``accelerator=cpu`` (the filter's grammar; with no CUDA device and no cpu
wish ``start()`` raises, it never falls back).

* ``slots=0``: one request at a time.  The prefill fills a KV cache on the
  device, then each chunk is one decode call whose tokens come to the
  host once (``models/transformer.py`` ``make_stream_generate``).
* ``slots=N``: continuous batching (``core/slots.py``): many prompt
  streams share one N-wide slot batch, join at token boundaries through
  chunked prefill interleaved with decode, and leave as they finish, are
  cancelled or blow their deadline.  The engine decodes on its own pump
  thread; chunks are emitted on the element's dispatch thread
  (``handle_frame``/``handle_idle`` drain ``pop_ready``), and EOS waits
  for every live stream.  ``prefix-cache=on`` arms the engine's
  shared-prefix KV cache (``prefix-grain``, rounded up to a
  ``prefill-chunk`` multiple, and ``prefix-cap`` entries); a fresh pool
  per ``start()``.  ``custom=sim:1[,vocab:N,sim_step_ms:F,sim_per_slot_ms:F,
  sim_prefill_ms:F,seq:N]`` drives the engine with the host-only
  ``SimSlotModel`` instead of a transformer (no card needed);
  ``sim_oom_step:K`` / ``sim_lost_step:K`` make its decode attempt K raise
  the typed device error once (the chaos twins).
* Device resilience (slotted): an OOM sheds the lowest-priority stream and
  retries; a device loss hands every live stream off, then the simulated
  model recovers in place while a real (unsharded) model re-raises into
  supervision, whose restart re-opens the element on the card.
* ``late-policy`` defaults to ``deliver`` here: a request past its
  deadline reaches the engine, which answers it with the typed-expiry
  final chunk instead of the scheduler dropping it silently.

Sampling (greedy, temperature, top-k, per-step key folding) is the
one-shot ``generate:<N>`` path's, so a stream's tokens are that path's.
Each chunk frame carries tokens (1, n) int32 and meta ``stream_seq``
(source frame seq), ``chunk_index``, ``tokens_done`` and ``final``;
evicted streams add ``evicted``/``deadline_expired`` (the typed expiry).

Per-stream SLOs (slotted): ``slo-ttft-p95``, ``slo-token-p99`` and
``slo-availability`` arm a :class:`~..core.telemetry.SloTracker` the
engine feeds on its pump thread (one TTFT per first token, one per-token
record per decode call, one outcome per finished stream); burn rates and
status are computed at scrape time and exported per tenant as
``nns.slo.*`` (``health_info``'s ``slo`` rows, ``histograms_info``).
``health_info`` also carries the engine's counters (``nns.gen.*``) and
its pump's thread census; a wedged pump is a flight-recorder incident.
Behind a query server, :meth:`note_stream_cancel` (the serversink's
client-gone feedback) cancels the dead client's stream, freeing its slot.

Stream continuity (slotted, ``core/continuity.py``): ``start()`` arms a
resume signature of everything that decides the tokens (the model's
dialect, seeds and dtype, the sampling rule, ``max-new``), signed with
this package's own kinds, ``torch-transformer`` and ``torch-sim``: the
JAX package's sampled tokens may differ at near-ties, so neither package
resumes the other's streams.  Every chunk then carries resume state; a
RESUME request is checked against the signature, the prompt's digest and
the prefix's shape (:meth:`_check_resume`) and joins from its checkpoint,
or gets the typed reject (``gen_resume_rejects``).  The unslotted path
refuses every RESUME request.  :meth:`note_stream_drain` (the serversrc's
drain, ``Pipeline.stream_drain_feedback``) hands the live streams off as
resumable GOAWAY chunks.  :meth:`request_resize` (the autoscaler's
resize, fenced by the controller's lease epoch) hands them off the same
way and rebuilds the engine at the new width on the dispatch thread once
it is idle, the old cache freed before the new one is allocated, the
weights and the prefix pool shared and the counters carried over
(``adopt_ledger``); a failed build rolls back (``end_goaway``) and keeps
the old width.  :meth:`prefix_digest_info` is the prefix pool's line of
the server's telemetry digest (``core/fleet.py``).

Not ported: ``mesh=`` (ROADMAP A11).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ..backends.base import parse_accelerator
from ..backends.torch_cuda import pick_device
from ..core.buffer import BatchFrame
from ..core.autoscale import FencingToken
from ..core.continuity import (
    PREFIX_GRAIN,
    RESUME_REJECT_META,
    RESUME_REQ_META,
    prompt_digest,
    resume_signature,
)
from ..core.liveness import (
    DEADLINE_META,
    PRIORITY_MAX,
    PRIORITY_META,
    TENANT_META,
    clamp_priority,
    thread_census,
)
from ..core.telemetry import SloTracker
from ..core.types import FORMAT_FLEXIBLE, StreamSpec
from ..models import transformer
from ..pipeline.element import Element, ElementError, Property, element, enum_prop_check

#: the zoo dialect's keys that decide a stream's tokens (the resume
#: signature's; chunk size and timing knobs shape latency, not tokens)
_SIG_KEYS = ("vocab", "d_model", "heads", "layers", "d_ff", "seq", "seed", "dtype",
             "gen_seed", "temperature", "top_k")


def _custom_props(text: str) -> Dict[str, str]:
    props = {}
    for part in text.split(","):
        if ":" in part:
            k, _, v = part.partition(":")
            props[k.strip()] = v.strip()
    props.pop("arch", None)  # tolerated for zoo-dialect symmetry
    return props


@element("tensor_generator")
class TensorGenerator(Element):
    # a block of prompts streams each logical prompt in order (lazy chain)
    BATCH_AWARE = True

    PROPERTIES = {
        "custom": Property(
            str, "",
            "zoo-transformer dialect: vocab:N,d_model:N,heads:N,layers:N,"
            "d_ff:N,seq:N,seed:N,dtype:T[,temperature:F,top_k:N,gen_seed:N]"),
        "max-new": Property(int, 32, "tokens to generate per prompt"),
        "chunk": Property(int, 8, "tokens per streamed chunk frame"),
        "max-buffers": Property(int, 0, "mailbox depth override"),
        "slots": Property(
            int, 0,
            "continuous-batching slot width: concurrent prompt streams share one "
            "decode batch (0 = serve requests one at a time)"),
        "prefill-chunk": Property(
            int, 32,
            "prompt tokens prefilled per engine iteration when joining a slot "
            "(chunked prefill interleaves with decode)"),
        "prefill-priority": Property(
            int, 1,
            "prefill chunks interleaved per decode call (0 = joining prompts "
            "prefill only while nothing is decoding)"),
        "token-budget-s": Property(
            float, 0.0,
            "per-token pace budget: a slotted stream slower than this between "
            "tokens is evicted with the typed expiry (0 = off; the request's "
            "own deadline is always honored)"),
        "accelerator": Property(
            str, "", "ordered wish list 'true:gpu.N,cpu' or 'cpu' (empty = cuda:0)"),
        "prefix-cache": Property(
            str, "off",
            "shared-prefix KV page pool: 'on' publishes each prompt's prefix pages at "
            "grain boundaries and attaches them to later prompts sharing the prefix "
            "(slots >= 1; warm streams give a cold run's tokens)"),
        "prefix-grain": Property(
            int, 0,
            "prefix chunk grain in tokens (0 = 64); rounded up to a prefill-chunk "
            "multiple so warm and cold runs prefill on the same chunk grid"),
        "prefix-cap": Property(
            int, 256,
            "max cached prefix entries (LRU among unpinned entries past the cap)"),
        # per-stream SLO accounting (core/telemetry.py SloTracker, engine
        # side): 0 = objective not armed
        "slo-ttft-p95": Property(
            float, 0.0,
            "TTFT objective: 95% of fresh streams must emit their first token within this "
            "many seconds (0 = off)"),
        "slo-token-p99": Property(
            float, 0.0,
            "per-token objective: 99% of token inter-arrivals must be under this many "
            "seconds (0 = off)"),
        "slo-availability": Property(
            float, 0.0,
            "goodput objective, e.g. 0.999: completed streams / classified streams "
            "(shed+evicted+expired+errors are the error budget; 0 = off)"),
        # not ported: set, it raises at start() naming the ROADMAP item
        "mesh": Property(str, "", "tensor-parallel decode mesh (not ported: ROADMAP A11)"),
        "late-policy": Property(
            str, "deliver",
            "requests past their deadline: deliver (the engine answers with the typed "
            "expiry, default here) | drop (the scheduler drops them uncounted by the engine)",
            convert=enum_prop_check("late-policy", "drop", "deliver")),
    }

    def __init__(self, name=None):
        super().__init__(name)
        self._prefill = None
        self._decode = None
        self._max_seq = 0
        self._device = None
        self._engine = None
        self._prefix_pool = None
        self._sim = False
        self._slo = None  # SloTracker (slo-* properties; slotted only)
        self._resume_sig = None  # token-sequence signature (slotted)
        self._resume_rejects = 0
        self._props: Dict[str, str] = {}  # the parsed custom (resize rebuilds)
        self._slots = 0
        # autoscale resize: the requested width, applied on the dispatch
        # thread at the next idle boundary after every live stream handed off
        self._resize_target = 0
        self._resizes = 0
        # fenced actuation: a resize carrying a stale lease epoch is refused
        self._fence = FencingToken()

    def start(self):
        props = _custom_props(self.props["custom"])
        slots = int(self.props["slots"])
        if slots < 0:
            raise ElementError(f"{self.name}: slots must be >= 0")
        if self.props["mesh"]:
            raise ElementError(
                f"{self.name}: mesh= is not ported to nnstreamer_tpu_torch yet (ROADMAP A11)")
        sim = props.get("sim", "") not in ("", "0", "false")
        self._sim = sim
        self._props = props
        self._resize_target = 0
        # slotted mode needs its OWN mailbox and thread: the scheduler's
        # idle hook and pending_frames poll, which release the engine's
        # chunks between input frames, run for chain heads only
        self.THREAD_BOUNDARY = slots > 0
        if slots > 0:
            from ..core.slots import SimSlotModel

            max_new = int(self.props["max-new"])
            if sim:
                self._resume_sig = resume_signature(
                    "torch-sim", vocab=int(props.get("vocab", "997")), max_new=max_new)
            else:
                self._resume_sig = resume_signature(
                    "torch-transformer", max_new=max_new,
                    **{k: props.get(k, "") for k in _SIG_KEYS})
            if sim:  # host-only: no card, no transformer
                model = SimSlotModel(
                    slots, vocab=int(props.get("vocab", "997")),
                    step_base_ms=float(props.get("sim_step_ms", "1.0")),
                    step_per_slot_ms=float(props.get("sim_per_slot_ms", "0.05")),
                    prefill_ms_per_token=float(props.get("sim_prefill_ms", "0.02")),
                    oom_at_step=(int(props["sim_oom_step"]) if "sim_oom_step" in props
                                 else None),
                    lost_at_step=(int(props["sim_lost_step"]) if "sim_lost_step" in props
                                  else None))
                self._device = model.device
                self._max_seq = int(props.get("seq", str(1 << 30)))
            else:
                enabled, wishes = parse_accelerator(self.props["accelerator"])
                self._device = pick_device(wishes if enabled else ["cpu"])
                model, self._max_seq = transformer.build_slot_stream(props, slots, self._device)
            self._prefix_pool = self._build_prefix_pool()
            self._slo = self._build_slo()
            self._slots = slots
            self._engine = self._new_engine(model)
            self._engine.start()
            return
        if self.props["prefix-cache"] == "on":
            raise ElementError(
                f"{self.name}: prefix-cache=on needs slots >= 1 (the pool lives in the slot "
                "engine)")
        if sim:
            raise ElementError(
                f"{self.name}: custom sim: needs slots >= 1 (the simulated model drives the "
                "slot engine; slots=1 is the request-serial baseline)")
        enabled, wishes = parse_accelerator(self.props["accelerator"])
        self._device = pick_device(wishes if enabled else ["cpu"])
        self._prefill, self._decode, self._max_seq = transformer.build_stream(
            props, self._device)

    def _new_engine(self, model):
        """A slot engine over ``model`` with this element's knobs, its resume
        signature, SLO tracker and prefix pool."""
        from ..core.slots import SlotEngine

        return SlotEngine(
            model,
            max_seq=self._max_seq,
            chunk=max(1, int(self.props["chunk"])),
            prefill_chunk=int(self.props["prefill-chunk"]),
            prefill_priority=int(self.props["prefill-priority"]),
            token_budget_s=float(self.props["token-budget-s"]),
            name=self.name,
            prefix_cache=self._prefix_pool,
            on_device_lost=self._rebuild_on_device_loss,
            slo=self._slo,
            resume_sig=self._resume_sig,
        )

    def _rebuild_on_device_loss(self, err):
        """The engine's ``on_device_lost`` hook (pump thread, after every
        live stream was handed off).  The simulated model recovers in place;
        a real model is unsharded (ROADMAP A11) and has no surviving device
        to move to, so the loss re-raises into supervision, whose restart
        re-opens the element on the card."""
        if self._sim:
            return None
        self.log.error("device lost (%s): an unsharded model has no survivor to move to; "
                       "escalating to supervision", err)
        raise err

    def _build_slo(self):
        """SloTracker from the slo-* properties (None when no objective is
        armed: the engine's record paths then cost nothing)."""
        try:
            tracker = SloTracker(
                ttft_p95_s=float(self.props["slo-ttft-p95"]),
                token_p99_s=float(self.props["slo-token-p99"]),
                availability=float(self.props["slo-availability"]))
        except ValueError as e:
            raise ElementError(f"{self.name}: {e}") from None
        return tracker if tracker.armed else None

    def _build_prefix_pool(self):
        """The PrefixCache of the prefix-* properties (None: off).  The
        grain rounds up to a prefill-chunk multiple; a fresh pool per
        ``start()``, so a restart is cache-cold."""
        from ..core.slots import PrefixCache

        mode = self.props["prefix-cache"]
        if mode not in ("off", "on"):
            raise ElementError(f"{self.name}: prefix-cache={mode!r}: want off|on")
        if mode != "on":
            return None
        pchunk = max(1, int(self.props["prefill-chunk"]))
        grain = int(self.props["prefix-grain"]) or PREFIX_GRAIN
        grain = -(-max(1, grain) // pchunk) * pchunk
        cap = int(self.props["prefix-cap"])
        if cap < 1:
            raise ElementError(f"{self.name}: prefix-cap must be >= 1, got {cap}")
        return PrefixCache(grain=grain, cap_entries=cap)

    def trim_prefix_cache(self) -> int:
        """Memory-pressure trim hook (``Pipeline.enable_memory_monitor``
        runs it first): drop every unreferenced cached prefix.  Returns
        the entries freed."""
        pool = self._prefix_pool
        return pool.trim() if pool is not None else 0

    def prefix_digest_info(self) -> Optional[Dict[str, Any]]:
        """The prefix pool's part of the server's telemetry digest
        (``core/fleet.py``): exact hit and miss counters for the fleet
        rollup and the hottest entries' digests.  None with the cache
        off."""
        pool = self._prefix_pool
        if pool is None:
            return None
        snap = pool.snapshot()
        return {"hits": snap["prefix_hits"], "misses": snap["prefix_misses"],
                "entries": snap["prefix_entries"], "hot": pool.hot_digests()}

    # -- autoscale resize ----------------------------------------------------
    def request_resize(self, slots: int, epoch: Optional[int] = None) -> None:
        """Arm a zero-loss slot-width resize (any thread): live streams are
        handed off as resumable GOAWAY chunks (their clients resume them
        here or elsewhere; the signature leaves the width out), then the
        engine is rebuilt at the new width on the dispatch thread's next
        idle boundary.  :attr:`resize_pending` and ``gen_resizes`` tell
        when it landed.  A stale lease ``epoch`` raises
        :class:`~..core.autoscale.StaleEpochError` before any stream is
        touched (None: an operator's command, never fenced)."""
        self._fence.check(epoch)
        slots = int(slots)
        if slots < 1:
            raise ElementError(f"{self.name}: resize slots must be >= 1")
        if self._engine is None:
            raise ElementError(f"{self.name}: resize needs the slotted path (slots >= 1)")
        if slots == self._slots:
            return
        self._resize_target = slots
        self._engine.begin_goaway()

    @property
    def resize_pending(self) -> bool:
        """True while a requested resize has not landed."""
        return bool(self._resize_target)

    def _build_slot_model(self, slots: int):
        """The slot model at the requested width: the same transformer (its
        weights stay where they are) or a fresh simulated model without the
        one-shot chaos knobs (a resize must not replay a scripted fault)."""
        if self._sim:
            from ..core.slots import SimSlotModel

            props = self._props
            return SimSlotModel(
                slots, vocab=int(props.get("vocab", "997")),
                step_base_ms=float(props.get("sim_step_ms", "1.0")),
                step_per_slot_ms=float(props.get("sim_per_slot_ms", "0.05")),
                prefill_ms_per_token=float(props.get("sim_prefill_ms", "0.02")))
        return self._engine.model.at_width(slots)

    def _apply_resize(self) -> None:
        """On the dispatch thread with the engine idle: build the model
        first (a failed build rolls back to the old width), stop the old
        engine (its cache goes before the new width's is allocated), start
        the new one with the old one's counters.  ``resize_pending`` stays
        set until the swap or the rollback has landed."""
        target = self._resize_target
        old = self._engine
        try:
            model = self._build_slot_model(target)
        except Exception:  # noqa: BLE001 — roll back to the old width
            self.log.exception("resize to %d slots failed building the model; keeping %d",
                               target, self._slots)
            old.end_goaway()
            p = self._pipeline
            if p is not None:
                p.incident("resize_failed", self.name,
                           f"slot resize {self._slots}->{target} model build failed; serving "
                           "at the old width")
            if self._resize_target == target:
                self._resize_target = 0
            return
        old.stop()
        new = self._new_engine(model)
        new.adopt_ledger(old)
        new.start()
        self._engine = new
        self.log.info("slot width resized %d -> %d (live streams handed off resumably)",
                      self._slots, target)
        self._slots = target
        # a supervision restart rebuilds at the actuated width
        self.props["slots"] = target
        self._resizes += 1
        if self._resize_target == target:  # a newer request may have raced the swap
            self._resize_target = 0

    def stop(self):
        if self._engine is not None:
            self._engine.stop()
            self._engine = None
        self._prefix_pool = None  # a restart is cache-cold
        self._prefill = self._decode = None

    # -- negotiation --------------------------------------------------------
    def accept_spec(self, pad, spec):
        return spec

    def derive_spec(self, pad=0):
        # chunk length varies (tail chunk): flexible stream
        return StreamSpec((), FORMAT_FLEXIBLE)

    # -- telemetry ------------------------------------------------------------
    def health_info(self) -> Dict:
        """The slot engine's counters (exported as ``nns.gen.*`` and
        ``nns.prefix.*``), the pump's thread census and the per-tenant SLO
        rows (``nns.slo.*``), merged into ``Pipeline.health()``."""
        info: Dict = {"gen_resume_rejects": self._resume_rejects,
                      "gen_resizes": self._resizes,
                      "gen_stale_epoch_rejects": self._fence.rejects,
                      "gen_fence_epoch": self._fence.epoch}
        eng = self._engine
        if eng is not None:
            info.update(eng.snapshot())
            info["threads"] = thread_census(eng.heartbeat)
        if self._slo is not None:
            info["slo"] = self._slo.snapshot()
        return info

    def histograms_info(self):
        """Per-tenant TTFT and inter-token log2 histograms."""
        return self._slo.hist_rows() if self._slo is not None else []

    # -- continuous-batching hooks ------------------------------------------
    def pending_frames(self) -> int:
        """Streams parked in the slot engine plus undelivered chunks."""
        return self._engine.pending() if self._engine is not None else 0

    def handle_idle(self):
        """Drain the chunks the engine finished since the last call:
        emission happens here, on the dispatch thread.  Also the pump's
        liveness check: a pump holding work that stopped beating is wedged
        in a device call, which no error will ever report."""
        eng = self._engine
        if eng is None:
            return []
        if eng.pending() > 0 and eng.heartbeat.check_stall(busy=True):
            self.log.warning(
                "slot pump %s wedged: no heartbeat for %.1fs with %d stream(s)/chunk(s) "
                "pending", eng.heartbeat.name, eng.heartbeat.age_s(), eng.pending())
            p = self._pipeline
            if p is not None:
                p.incident("thread_stall", self.name,
                           f"{eng.heartbeat.name} wedged ({eng.heartbeat.age_s():.1f}s, "
                           f"pending={eng.pending()})")
        chunks = eng.pop_ready()
        if self._resize_target and eng.idle():
            # the idle boundary: every live stream handed off and every
            # ready chunk drained; on this thread no frame races the swap
            self._apply_resize()
        return chunks

    def note_stream_drain(self) -> None:
        """The query serversrc of this pipeline began its drain: hand the
        live streams off as resumable GOAWAY chunks, so their clients
        migrate them instead of the drain waiting out whole generations."""
        if self._engine is not None:
            self._engine.begin_goaway()

    def note_stream_cancel(self, meta: Dict) -> None:
        """Downstream feedback (the query serversink): the consumer of this
        stream is gone; free its slot now instead of decoding tokens nobody
        will read."""
        if self._engine is None:
            return
        cid = meta.get("client_id")
        if cid is not None:
            self._engine.cancel(client_id=cid)

    def handle_eos(self, pad):
        """Slotted mode: the stream ends only once every live generation
        has completed — flush the engine through the dispatch thread."""
        eng = self._engine
        if eng is None:
            return []

        def flush():
            while True:
                yield from eng.pop_ready()
                if eng.idle():
                    return
                if self._pipeline is not None and self._pipeline._stop_flag.is_set():
                    return
                eng.wait_progress(0.05)

        return flush()

    # -- processing ---------------------------------------------------------
    def handle_frame(self, pad, frame):
        if self._engine is not None:
            return self._handle_slotted(frame)
        if self._prefill is None:
            raise ElementError(f"{self.name} not started")
        logical = frame.to_host().split() if isinstance(frame, BatchFrame) else [frame]

        def multi():
            # one stream per logical prompt, lazily: chunks of prompt j
            # leave before prompt j+1 starts decoding
            for lf in logical:
                if lf.meta.get(RESUME_REQ_META) is not None:
                    yield self._resume_reject(
                        lf, "resume requires a slotted generator (slots >= 1)")
                else:
                    yield from self._stream_one(lf)

        return multi()

    def _validated_prompt(self, frame, max_new: int) -> np.ndarray:
        prompt = np.asarray(frame.tensors[0])
        if prompt.ndim == 1:
            prompt = prompt[None]
        if prompt.ndim != 2 or prompt.dtype.kind not in "iu":
            raise ElementError(
                f"{self.name}: prompt must be int tokens (B, Tp) or (Tp,), "
                f"got {prompt.shape} {prompt.dtype}")
        if prompt.shape[1] + max_new > self._max_seq:
            # positions past max_seq have no embedding and no cache page:
            # fail loud instead of indexing out of range on the device
            raise ElementError(
                f"{self.name}: prompt {prompt.shape[1]} + max-new {max_new} exceeds the "
                f"model's seq {self._max_seq}")
        return prompt

    def _handle_slotted(self, frame):
        """Submit the prompt(s) to the slot engine and drain whatever
        chunks are ready: new prompts join live decoding at the next token
        boundary instead of queueing behind it."""
        max_new = int(self.props["max-new"])
        chunk = max(1, int(self.props["chunk"]))
        logical = frame.to_host().split() if isinstance(frame, BatchFrame) else [frame]
        rejects = []
        for lf in logical:
            prompt = self._validated_prompt(lf, max_new)
            if prompt.shape[0] != 1:
                raise ElementError(
                    f"{self.name}: slots>0 serves one prompt per stream; got a "
                    f"(B={prompt.shape[0]}) prompt batch — push a block of single "
                    "prompts instead")
            if max_new <= 0:
                continue
            meta = lf.meta
            resume = None
            rs = meta.get(RESUME_REQ_META)
            if rs is not None:
                resume, reason = self._check_resume(lf, prompt, max_new, rs)
                if resume is None:
                    rejects.append(self._resume_reject(lf, reason))
                    continue
            self._engine.submit(
                lf, prompt.astype(np.int32), max_new, chunk,
                tenant=str(meta.get(TENANT_META, "") or ""),
                priority=clamp_priority(meta.get(PRIORITY_META, PRIORITY_MAX)),
                deadline_ts=meta.get(DEADLINE_META),
                resume=resume,
            )
        return rejects + self._engine.pop_ready()

    def _check_resume(self, lf, prompt, max_new: int, rs):
        """Check one RESUME request against this server's signature and the
        prompt it came with: ``(engine resume dict, None)`` or ``(None,
        reason)``; a mismatch refuses the one stream, never the pipeline.
        The prefix stays a host array here (the pump thread uploads it)."""
        try:
            sig = str(rs["sig"])
            r = int(rs["tokens_done"])
        except (KeyError, TypeError, ValueError):
            return None, "malformed resume state"
        if sig != self._resume_sig:
            return None, "model/sampling signature mismatch"
        if str(rs.get("digest", "")) != prompt_digest(prompt.astype(np.int32)):
            return None, "prompt digest mismatch"
        if not 0 <= r < max_new:
            return None, f"tokens_done {r} outside [0, {max_new})"
        if r == 0:
            return {"tokens_done": 0}, None
        if len(lf.tensors) < 2:
            return None, "resume request lacks the prefix tensor"
        prefix = np.asarray(lf.tensors[1])
        if prefix.ndim == 1:
            prefix = prefix[None]
        if prefix.ndim != 2 or prefix.shape != (1, r) or prefix.dtype.kind not in "iu":
            return None, f"prefix {prefix.shape} {prefix.dtype} != (1, {r}) int"
        return {"tokens_done": r, "prefix": prefix.astype(np.int32)}, None

    def _resume_reject(self, lf, reason: str):
        """Typed terminal refusal of one RESUME request: a tensor-less final
        chunk naming the reason; the other streams go on."""
        self.log.warning("resume refused: %s", reason)
        self._resume_rejects += 1
        out = lf.with_tensors([])
        out.meta.update(stream_seq=lf.seq, chunk_index=0, tokens_done=0, final=True)
        out.meta[RESUME_REJECT_META] = reason
        return (0, out)

    def _stream_one(self, frame):
        max_new = int(self.props["max-new"])
        prompt = self._validated_prompt(frame, max_new)
        chunk = max(1, int(self.props["chunk"]))
        if max_new <= 0:
            return
        cache, tok = self._prefill(torch.from_numpy(prompt.astype(np.int32)).to(self._device))
        done = idx = 0
        pending = [tok.cpu().numpy()[:, None]]  # token 1 (from the prefill)
        pending_n = t = 1
        while True:
            if pending_n >= chunk or t >= max_new:
                toks = np.concatenate(pending, axis=1)
                done += toks.shape[1]
                out = frame.with_tensors([toks.astype(np.int32)])
                out.meta.update(stream_seq=frame.seq, chunk_index=idx, tokens_done=done,
                                final=bool(t >= max_new))
                idx += 1
                pending, pending_n = [], 0
                yield (0, out)
            if t >= max_new:
                return
            n = min(chunk - pending_n, max_new - t)
            cache, tok, toks = self._decode(cache, tok, t, n)
            # to the host before the chunk leaves: emission means "these
            # tokens exist", not "their computation was queued"
            pending.append(toks.cpu().numpy())
            pending_n += n
            t += n

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

Not ported: ``mesh=`` (ROADMAP A11), resume (A7.3: a RESUME request is
answered with the typed reject), resize (A13.3).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..backends.base import parse_accelerator
from ..backends.torch_cuda import pick_device
from ..core.buffer import BatchFrame
from ..core.continuity import PREFIX_GRAIN
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

#: frame.meta key of a RESUME request and of the typed refusal it gets
#: (``nnstreamer_tpu/core/continuity.py``)
RESUME_REQ_META = "_nns_resume_req"
RESUME_REJECT_META = "resume_reject"


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
        self._resume_rejects = 0

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
        # slotted mode needs its OWN mailbox and thread: the scheduler's
        # idle hook and pending_frames poll, which release the engine's
        # chunks between input frames, run for chain heads only
        self.THREAD_BOUNDARY = slots > 0
        if slots > 0:
            from ..core.slots import SimSlotModel, SlotEngine

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
            self._engine = SlotEngine(
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
            )
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
        info: Dict = {"gen_resume_rejects": self._resume_rejects}
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
        return eng.pop_ready()

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
            if lf.meta.get(RESUME_REQ_META) is not None:
                rejects.append(self._resume_reject(
                    lf, "resume is not ported to nnstreamer_tpu_torch (ROADMAP A7)"))
                continue
            meta = lf.meta
            self._engine.submit(
                lf, prompt.astype(np.int32), max_new, chunk,
                tenant=str(meta.get(TENANT_META, "") or ""),
                priority=clamp_priority(meta.get(PRIORITY_META, PRIORITY_MAX)),
                deadline_ts=meta.get(DEADLINE_META),
            )
        return rejects + self._engine.pop_ready()

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

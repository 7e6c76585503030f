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
  for every live stream.

Sampling (greedy, temperature, top-k, per-step key folding) is the
one-shot ``generate:<N>`` path's, so a stream's tokens are that path's.
Each chunk frame carries tokens (1, n) int32 and meta ``stream_seq``
(source frame seq), ``chunk_index``, ``tokens_done`` and ``final``;
evicted streams add ``evicted``/``deadline_expired`` (the typed expiry).

Not ported (ROADMAP A7): ``mesh=`` (A11), ``prefix-cache=on``, the ``sim``
model, resume (a RESUME request is answered with the typed reject),
resize, SLO tracking and device-loss recovery.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..backends.base import parse_accelerator
from ..backends.torch_cuda import pick_device
from ..core.buffer import BatchFrame
from ..core.liveness import (
    DEADLINE_META,
    PRIORITY_MAX,
    PRIORITY_META,
    TENANT_META,
    clamp_priority,
)
from ..core.types import FORMAT_FLEXIBLE, StreamSpec
from ..models import transformer
from ..pipeline.element import Element, ElementError, Property, element

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
        # not ported: set, they raise at start() naming the ROADMAP item
        "mesh": Property(str, "", "tensor-parallel decode mesh (not ported: ROADMAP A11)"),
        "prefix-cache": Property(str, "off", "shared-prefix KV cache (not ported: ROADMAP A7)"),
    }

    def __init__(self, name=None):
        super().__init__(name)
        self._prefill = None
        self._decode = None
        self._max_seq = 0
        self._device = None
        self._engine = None

    def start(self):
        props = _custom_props(self.props["custom"])
        slots = int(self.props["slots"])
        if slots < 0:
            raise ElementError(f"{self.name}: slots must be >= 0")
        if self.props["mesh"]:
            raise ElementError(
                f"{self.name}: mesh= is not ported to nnstreamer_tpu_torch yet (ROADMAP A11)")
        if self.props["prefix-cache"] != "off":
            raise ElementError(
                f"{self.name}: prefix-cache={self.props['prefix-cache']} is not ported to "
                "nnstreamer_tpu_torch yet (ROADMAP A7)")
        if props.get("sim", "") not in ("", "0", "false"):
            raise ElementError(
                f"{self.name}: custom sim: (the simulated slot model) is not ported to "
                "nnstreamer_tpu_torch yet (ROADMAP A7)")
        enabled, wishes = parse_accelerator(self.props["accelerator"])
        self._device = pick_device(wishes if enabled else ["cpu"])
        # slotted mode needs its OWN mailbox and thread: the scheduler's
        # idle hook and pending_frames poll, which release the engine's
        # chunks between input frames, run for chain heads only
        self.THREAD_BOUNDARY = slots > 0
        if slots > 0:
            from ..core.slots import SlotEngine

            model, self._max_seq = transformer.build_slot_stream(props, slots, self._device)
            self._engine = SlotEngine(
                model,
                max_seq=self._max_seq,
                chunk=max(1, int(self.props["chunk"])),
                prefill_chunk=int(self.props["prefill-chunk"]),
                prefill_priority=int(self.props["prefill-priority"]),
                token_budget_s=float(self.props["token-budget-s"]),
                name=self.name,
            )
            self._engine.start()
            return
        self._prefill, self._decode, self._max_seq = transformer.build_stream(
            props, self._device)

    def stop(self):
        if self._engine is not None:
            self._engine.stop()
            self._engine = None
        self._prefill = self._decode = None

    # -- negotiation --------------------------------------------------------
    def accept_spec(self, pad, spec):
        return spec

    def derive_spec(self, pad=0):
        # chunk length varies (tail chunk): flexible stream
        return StreamSpec((), FORMAT_FLEXIBLE)

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
        return eng.pop_ready()

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

"""Stream continuity: resumable generation streams, and prompt digests
for the shared-prefix KV cache.

Port of ``nnstreamer_tpu/core/continuity.py``.  A generation stream
outlives the server it started on:

* every chunk a slotted :class:`~.slots.SlotEngine` with a resume
  signature emits carries resume state in meta (:data:`RESUME_META`: the
  model and sampling signature, the prompt digest, the chunk size) beside
  its ``tokens_done`` and ``chunk_index``.  The sampling key of a step is
  folded at the absolute token index, so prompt + generated prefix is a
  whole checkpoint: another server with the same signature re-prefills it
  and decodes the remaining tokens;
* the query client keeps the delivered tokens of each stream in a
  :class:`StreamContinuity` ledger.  On a break mid-stream, or a draining
  server's GOAWAY hand-off chunk (:data:`GOAWAY_META`), it builds a RESUME
  request (:data:`RESUME_REQ_META` + [prompt, prefix]) for a healthy
  server;
* a resume point snaps down to the last full chunk, so the resumed
  server's chunks fall on an uninterrupted run's grid; the ledger drops
  the re-decoded overlap by ``tokens_done`` (exactly once) and numbers the
  emitted chunks contiguously across servers.

The resume state is JSON meta and the prefix an int32 tensor, so both
transports carry it unchanged, byte-equal to the JAX package's.  The two
packages sign with different ``kind`` values (:func:`resume_signature`):
their sampled tokens may differ at near-ties, so neither resumes the
other's stream.

The digests (:func:`prompt_digest`, :func:`prefix_digests`,
:func:`prefix_route_key`) are byte-equal to the JAX package's for the same
prompt, so a fleet that mixes both packages sends one prompt to one prefix
owner.
"""

from __future__ import annotations

import hashlib
from typing import Any, Dict, Optional

import numpy as np

#: chunk meta: the resume state stamped on every resumable chunk
RESUME_META = "_nns_resume"
#: request meta: marks a stream request as a RESUME of an earlier one
RESUME_REQ_META = "_nns_resume_req"
#: chunk meta: a draining server handed this stream off (a resumable
#: final chunk: a migration, not a failure)
GOAWAY_META = "goaway"
#: chunk meta: the server refused a RESUME request with a typed terminal
#: chunk naming the reason
RESUME_REJECT_META = "resume_reject"


def _tokens(prompt) -> np.ndarray:
    """The prompt as a contiguous int32 (1, Tp) array (a 1-D prompt is
    one row)."""
    return np.ascontiguousarray(np.asarray(prompt, dtype=np.int32)).reshape(1, -1)


def prompt_digest(prompt) -> str:
    """Stable digest of a normalized (1, Tp) int32 prompt: its shape, then
    its bytes."""
    a = np.ascontiguousarray(np.asarray(prompt, dtype=np.int32))
    h = hashlib.sha1()
    h.update(str(a.shape).encode())
    h.update(a.tobytes())
    return h.hexdigest()


#: default shared-prefix grain in tokens, a multiple of the slot engine's
#: default ``prefill_chunk`` (32): an attach leaves the rest of the prompt
#: on the chunk grid a cold prefill uses
PREFIX_GRAIN = 64


def prefix_digests(prompt, grain: int) -> list:
    """Chain digests at every full ``grain``-token boundary of a (1, Tp)
    int32 prompt: ``d_0 = H(g, 0, chunk_0)``, ``d_i = H(d_{i-1}, g, i,
    chunk_i)``.  Each digest names its chunk and all of its left context
    (the KV pages of a chunk depend on every token before it); the
    trailing partial chunk gets none."""
    a = _tokens(prompt)
    g = max(1, int(grain))
    out = []
    prev = b""
    for i in range(int(a.shape[1]) // g):
        h = hashlib.sha1()
        h.update(prev)
        h.update(f"|g={g}|i={i}|".encode())
        h.update(a[:, i * g:(i + 1) * g].tobytes())
        d = h.hexdigest()
        out.append(d)
        prev = d.encode()
    return out


def prefix_route_key(prompt, grain: int = PREFIX_GRAIN, declared: int = 0) -> str:
    """Routing key of a prompt's shared-prefix region: the chain digest of
    its first ``declared`` tokens rounded down to the grain (0: the first
    grain), or the whole-prompt digest for a prompt shorter than one
    grain."""
    a = _tokens(prompt)
    g = max(1, int(grain))
    n = int(declared) if declared else g
    k = min(max(0, n), int(a.shape[1])) // g
    if k <= 0:
        return prompt_digest(a)
    return prefix_digests(a[:, :k * g], g)[-1]


def resume_signature(kind: str, **cfg: Any) -> str:
    """Opaque signature of what determines a stream's tokens (model family,
    weights seed, sampling rule, generation length).  Servers stamp it on
    chunks and check it on resume; two servers serve each other's streams
    only when their signatures match."""
    h = hashlib.sha1()
    h.update(kind.encode())
    for k in sorted(cfg):
        h.update(f"|{k}={cfg[k]}".encode())
    return h.hexdigest()


class ChunkVerdict:
    """What :meth:`StreamContinuity.accept` decided about one chunk: the
    frame to emit (or None), the duplicate tokens dropped, and whether it
    was a hand-off, a resume refusal or the stream's true end."""

    __slots__ = ("emit", "dup", "handoff", "finished", "reject")

    def __init__(self):
        self.emit = None
        self.dup = 0
        self.handoff = False
        self.finished = False
        self.reject: Optional[str] = None


class StreamContinuity:
    """Client-side ledger of one logical generation stream across servers.

    Every received chunk goes through :meth:`accept`.  Chunks without
    :data:`RESUME_META` pass untouched (``capable`` stays False: no
    replay).  Once a chunk carries it, the ledger latches the signature,
    digest and chunk size, keeps the delivered tokens, numbers emitted
    chunks contiguously and drops re-decoded overlap after a resume.
    :meth:`build_resume_frame` makes the next attempt's RESUME request."""

    __slots__ = (
        "frame", "capable", "sig", "digest", "chunk", "delivered",
        "duplicates_dropped", "emit_idx", "_tokens", "_stream_seq", "_handoff",
    )

    def __init__(self, frame):
        self.frame = frame
        self.capable = False
        self.sig = ""
        self.digest = ""
        self.chunk = 1
        self.delivered = 0          # tokens delivered downstream
        self.duplicates_dropped = 0
        self.emit_idx = 0           # contiguous downstream chunk numbering
        self._tokens = []           # (1, n) pieces, their concat == delivered
        self._stream_seq = None     # one seq for the whole stream
        self._handoff = False

    def accept(self, ans) -> ChunkVerdict:
        """Classify one received chunk and compute what to emit: tokens past
        ``delivered`` are new (emitted and kept), tokens at or below it are
        overlap of a resume (dropped and counted)."""
        v = ChunkVerdict()
        meta = ans.meta
        rj = meta.get(RESUME_REJECT_META)
        if rj is not None:
            v.reject = str(rj)
            return v
        rs = meta.get(RESUME_META)
        if rs is not None and not self.capable:
            try:
                self.sig = str(rs["sig"])
                self.digest = str(rs["digest"])
                self.chunk = max(1, int(rs["chunk"]))
                self.capable = True
            except (KeyError, TypeError, ValueError):
                self.capable = False
        if not self.capable:
            v.emit = ans
            v.finished = bool(meta.get("final", True))
            return v
        toks = None
        n = 0
        if ans.tensors:
            toks = np.asarray(ans.tensors[0])
            if toks.ndim == 1:
                toks = toks[None]
            n = int(toks.shape[1])
        done = meta.get("tokens_done")
        done = int(done) if done is not None else self.delivered + n
        start = done - n  # this chunk covers tokens (start, done]
        final = bool(meta.get("final", True))
        handoff = final and bool(meta.get(GOAWAY_META))
        dup = min(max(0, self.delivered - start), n)
        if dup:
            self.duplicates_dropped += dup
            v.dup = dup
            toks = toks[:, dup:]
            n -= dup
        if n > 0:
            self._tokens.append(np.ascontiguousarray(toks, dtype=np.int32))
            if done > self.delivered:
                self.delivered = done
        v.handoff = handoff
        if handoff:
            self._handoff = True
        v.finished = final and not handoff
        if n > 0 or v.finished:
            out = ans.with_tensors([np.ascontiguousarray(toks, dtype=np.int32)] if n > 0
                                   else [])
            # one downstream view across migrations: one chunk numbering,
            # one stream_seq, cumulative tokens_done; the hand-off markers
            # never leave the client
            out.meta["chunk_index"] = self.emit_idx
            self.emit_idx += 1
            out.meta["tokens_done"] = self.delivered
            out.meta["final"] = v.finished
            if self._stream_seq is None:
                self._stream_seq = out.meta.get("stream_seq")
            elif "stream_seq" in out.meta:
                out.meta["stream_seq"] = self._stream_seq
            if handoff:
                out.meta.pop(GOAWAY_META, None)
                out.meta.pop("evicted", None)
            v.emit = out
        return v

    def take_handoff(self) -> bool:
        """True once after a hand-off chunk arrived (the migration trigger)."""
        h, self._handoff = self._handoff, False
        return h

    def resume_point(self) -> int:
        """The last full chunk boundary at or below ``delivered``: the
        resumed server's chunk grid stays an uninterrupted run's, and the
        overlap past it is re-decoded and dropped by :meth:`accept`."""
        return (self.delivered // self.chunk) * self.chunk

    def build_resume_frame(self):
        """The RESUME request of the next attempt: tensors [prompt, prefix
        (1, R)] (no prefix for R = 0, since the wire refuses (1, 0)
        shapes), meta the original request's plus :data:`RESUME_REQ_META`."""
        from .buffer import TensorFrame

        if not self.capable:
            raise RuntimeError("stream carries no resume state")
        total = (np.concatenate(self._tokens, axis=1) if self._tokens
                 else np.zeros((1, 0), np.int32))
        if int(total.shape[1]) != self.delivered:
            # out-of-order or gapped chunks: resuming could deliver a token
            # twice or never, so refuse loudly
            self.capable = False
            raise RuntimeError(
                f"resume ledger incoherent: {total.shape[1]} tokens held "
                f"vs {self.delivered} delivered")
        r = self.resume_point()
        meta: Dict[str, Any] = dict(self.frame.meta)
        meta[RESUME_REQ_META] = {
            "v": 1, "sig": self.sig, "digest": self.digest,
            "chunk": int(self.chunk), "tokens_done": int(r),
        }
        tensors = [np.asarray(self.frame.tensors[0])]
        if r > 0:
            tensors.append(np.ascontiguousarray(total[:, :r], dtype=np.int32))
        return TensorFrame(tensors, meta=meta)

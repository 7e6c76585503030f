"""Multi-stream time-synchronization policies.

A copy of ``nnstreamer_tpu/core/sync.py`` (pure Python; the port keeps its
own so the two packages share no module).

Reference: ``gst/nnstreamer/tensor_common.h:62-182`` (enum
``tensor_time_sync_mode``: NOSYNC / SLOWEST / BASEPAD / REFRESH) and the
collect-pads engine ``gst_tensor_time_sync_buffer_from_collectpad``
(``nnstreamer_plugin_api_impl.c:101-533``); behavior documented in
``Documentation/synchronization-policies-at-mux-merge.md``.

Used by the N:1 elements (mux / merge).  The reference implements this over
GstCollectPads; here it is a small pure-Python collator that the threaded
pipeline runtime drives — deterministic and unit-testable without a pipeline.

Policies:

* ``nosync``  — combine one frame per pad in arrival order.
* ``slowest`` — output timestamps follow the slowest pad: a set is emitted at
  the max of the head timestamps; faster pads drop frames older than the base.
* ``basepad`` — option ``"<pad>:<duration>"``: the designated pad drives
  output; other pads contribute their newest frame within ``duration`` seconds
  of the base timestamp (reference option is in nanoseconds; here seconds).
* ``refresh`` — any new frame on any pad triggers output; other pads re-use
  their most recent frame.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Deque, List, Optional, Sequence

from .buffer import TensorFrame

NOSYNC = "nosync"
SLOWEST = "slowest"
BASEPAD = "basepad"
REFRESH = "refresh"
MODES = (NOSYNC, SLOWEST, BASEPAD, REFRESH)


@dataclass
class SyncPolicy:
    mode: str = NOSYNC
    base_pad: int = 0  # basepad only
    window: Optional[float] = None  # basepad tolerance, seconds; None = unlimited

    @classmethod
    def from_string(cls, mode: str, option: str = "") -> "SyncPolicy":
        mode = (mode or NOSYNC).strip().lower()
        if mode not in MODES:
            raise ValueError(f"unknown sync mode {mode!r}")
        if mode == BASEPAD and option:
            pad_s, _, dur_s = option.partition(":")
            return cls(mode, int(pad_s), float(dur_s) if dur_s else None)
        return cls(mode)


def _pts(f: TensorFrame) -> float:
    return f.pts if f.pts is not None else 0.0


class Collator:
    """Collects frames from N pads and emits synchronized frame-sets."""

    def __init__(self, num_pads: int, policy: SyncPolicy):
        if num_pads < 1:
            raise ValueError("need at least one pad")
        self.num_pads = num_pads
        self.policy = policy
        self.queues: List[Deque[TensorFrame]] = [deque() for _ in range(num_pads)]
        self.last: List[Optional[TensorFrame]] = [None] * num_pads
        self.eos = [False] * num_pads
        self._refresh_dirty = [False] * num_pads

    # -- input --------------------------------------------------------------
    def push(self, pad: int, frame: TensorFrame) -> None:
        self.queues[pad].append(frame)
        self._refresh_dirty[pad] = True

    def mark_eos(self, pad: int) -> None:
        self.eos[pad] = True

    @property
    def all_eos(self) -> bool:
        """Whether the combined stream is finished, per policy:

        * SLOWEST — ends when the slowest pad ends (reference semantics:
          stream is over once any pad is EOS with nothing queued).
        * BASEPAD — ends when the base pad is drained.
        * NOSYNC / REFRESH — ends only when every pad is drained (EOS pads
          repeat their last frame while others still flow).
        """
        drained = [e and not q for e, q in zip(self.eos, self.queues)]
        if self.policy.mode == SLOWEST:
            return any(drained)
        if self.policy.mode == BASEPAD:
            return drained[self.policy.base_pad]
        return all(drained)

    # -- output -------------------------------------------------------------
    def collect(self) -> Optional[List[TensorFrame]]:
        """Return one synchronized set of frames (index = pad), or None if
        not ready yet.  Call repeatedly until None to drain."""
        mode = self.policy.mode
        if mode == NOSYNC:
            return self._collect_nosync()
        if mode == SLOWEST:
            return self._collect_slowest()
        if mode == BASEPAD:
            return self._collect_basepad()
        if mode == REFRESH:
            return self._collect_refresh()
        raise AssertionError(mode)

    def _collect_nosync(self) -> Optional[List[TensorFrame]]:
        if not all(self.queues[i] for i in range(self.num_pads) if not self.eos[i]):
            return None
        if not any(self.queues):
            return None
        out = []
        for i, q in enumerate(self.queues):
            if q:
                f = q.popleft()
                self.last[i] = f
            elif self.last[i] is not None:  # EOS pad: repeat last
                f = self.last[i]
            else:
                return None
            out.append(f)
        return out

    def _collect_slowest(self) -> Optional[List[TensorFrame]]:
        active = [i for i in range(self.num_pads) if not (self.eos[i] and not self.queues[i])]
        if not active or not all(self.queues[i] for i in active):
            return None
        base = max(_pts(self.queues[i][0]) for i in active)
        # a frame <= base is superseded once a NEWER frame <= base is queued
        # behind it — keep only the newest candidate per pad (safe eager
        # drop: the outcome can never change)
        for i in active:
            q = self.queues[i]
            while len(q) > 1 and _pts(q[1]) <= base:
                q.popleft()
        # plan the full set before popping anything (no partial consumption).
        # A pad whose head is STALE (< base) with no queued successor and no
        # EOS must wait — a better frame may still arrive (the reference pops
        # the stale head to pad->buffer and returns "need more data",
        # nnstreamer_plugin_api_impl.c:289-327; once a newer head exists the
        # remembered frame is the pad's contribution).  Phase-offset streams
        # therefore emit continuously one set per slowest-pad frame.
        pops = []
        for i in range(self.num_pads):
            q = self.queues[i]
            if i in active and q and _pts(q[0]) <= base:
                if _pts(q[0]) < base and len(q) == 1 and not self.eos[i]:
                    return None
                pops.append(i)
            elif self.last[i] is None:
                return None
        out: List[Optional[TensorFrame]] = [None] * self.num_pads
        for i in range(self.num_pads):
            if i in pops:
                self.last[i] = self.queues[i].popleft()
            out[i] = self.last[i]
        return [f for f in out if f is not None]

    def _collect_basepad(self) -> Optional[List[TensorFrame]]:
        b = self.policy.base_pad
        if not self.queues[b]:
            return None
        base_frame = self.queues[b].popleft()
        self.last[b] = base_frame
        base = _pts(base_frame)
        out: List[Optional[TensorFrame]] = [None] * self.num_pads
        out[b] = base_frame
        for i in range(self.num_pads):
            if i == b:
                continue
            q = self.queues[i]
            # take the newest frame not newer than base+window
            window = self.policy.window if self.policy.window is not None else float("inf")
            picked = None
            while q and _pts(q[0]) <= base + window:
                picked = q.popleft()
                if q and _pts(q[0]) > base:
                    break
            if picked is not None:
                self.last[i] = picked
            if self.last[i] is None:
                # need at least one frame ever seen on every pad
                self.queues[b].appendleft(base_frame)
                return None
            out[i] = self.last[i]
        return [f for f in out if f is not None]

    def _collect_refresh(self) -> Optional[List[TensorFrame]]:
        if not any(self._refresh_dirty):
            return None
        for i, q in enumerate(self.queues):
            while q:
                self.last[i] = q.popleft()
        if any(f is None for f in self.last):
            return None
        self._refresh_dirty = [False] * self.num_pads
        return list(self.last)  # type: ignore[arg-type]

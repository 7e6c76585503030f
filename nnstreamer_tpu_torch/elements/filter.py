"""tensor_filter: run a model on every frame or micro-batch of a stream.

Port of ``nnstreamer_tpu/elements/filter.py`` for the serving path: the
backend is resolved from ``framework=`` and opened with the element's
properties; ``max-batch`` > 1 makes the scheduler hand micro-batches
(``handle_frame_batch``) that run as one ``invoke_batch``; a decoder's
device half can be folded into the backend (``fuse_device_postprocess``),
after which the filter emits each micro-batch as ONE device-resident
``BatchFrame`` (batch-through).

The asynchronous device feed (``core/feed.py``) keeps the dispatch thread
out of device I/O:

* ``ingest-lane`` (auto|on|off): host frames are stacked into pooled
  (pinned, on CUDA) staging buffers and copied to the device on a lane
  thread, one batch ahead: batch k is dispatched when k+1 is submitted.
* ``dispatch-depth`` N > 1: up to N micro-batches stay in flight; each
  one's device-to-host copy is queued at dispatch time and a reaper
  thread waits for it, while this thread stacks and dispatches the next.

Both keep FIFO order: every boundary (EOS, the scheduler's idle hook, any
event) dispatches the staged batch and drains the window first.  ``Flush``
discards both.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..backends import find_backend, parse_accelerator
from ..backends.base import FilterBackend
from ..core.buffer import (
    BatchFrame,
    Flush,
    TensorFrame,
    _is_torch,
    concat_tensors,
    materialize,
    start_host_copies,
)
from ..core.feed import CompletionWindow, HostStagingLane, StagedBatch
from ..core.types import ANY, StreamSpec
from ..pipeline.element import ElementError, Property, TransformElement, element


def _concat(pieces: List[Any]):
    """Concatenate batch pieces on axis 0 (torch when any piece is)."""
    return pieces[0] if len(pieces) == 1 else concat_tensors(pieces, 0)


def _batched_tensors(frames: Sequence[TensorFrame]) -> List[Any]:
    """ONE batched tensor list for a mixed plain/BatchFrame list: plain
    frames gain a length-1 batch axis, blocks pass through."""
    pieces = [
        list(f.tensors) if isinstance(f, BatchFrame) else [t[None] for t in f.tensors]
        for f in frames
    ]
    return [_concat([p[t] for p in pieces]) for t in range(len(pieces[0]))]


def _logical_infos(frames: Sequence[TensorFrame]) -> List[Tuple[Any, Any, Dict[str, Any]]]:
    """(pts, duration, meta) per LOGICAL frame, in stream order."""
    infos = []
    for f in frames:
        if isinstance(f, BatchFrame):
            infos.extend(f.frames_info)
        else:
            infos.append((f.pts, f.duration, f.meta))
    return infos


@element("tensor_filter")
class TensorFilter(TransformElement):
    BATCH_AWARE = True  # consumes the batch axis (micro-batching)

    PROPERTIES = {
        "framework": Property(str, "torch-cuda", "backend name"),
        "model": Property(str, "", "model registry key, or any name with custom=arch:<zoo-name>"),
        "custom": Property(str, "", "backend-specific options 'k1:v1,k2:v2'"),
        "accelerator": Property(
            str, "", "ordered wish list 'true:gpu.N,cpu' or 'cpu' (empty = cuda:0)"),
        "max-batch": Property(int, 1, "micro-batch up to N queued frames into one invoke"),
        "batch-timeout": Property(
            int, 0, "ms to wait filling a micro-batch (0 = only drain queued)"),
        "dispatch-depth": Property(
            int, 4,
            "micro-batches kept in flight in the completion-driven dispatch "
            "window (a reaper thread waits for each batch's device-to-host "
            "copy; the dispatch thread keeps stacking and dispatching; "
            "1 = synchronous)"),
        "ingest-lane": Property(
            str, "auto",
            "auto|on|off — double-buffered host-to-device staging: host frames "
            "are stacked into pooled (pinned) staging buffers and copied to the "
            "device from a lane thread, one batch ahead, so the copy overlaps "
            "the previous batch's compute (auto = on when the backend supports "
            "staged placement and max-batch>1)"),
        "batch-through": Property(
            bool, False,
            "emit micro-batches as ONE BatchFrame (device-resident) instead of "
            "per-frame outputs (set automatically by the device-fusion pass)"),
    }

    def __init__(self, name=None):
        super().__init__(name)
        self.backend: Optional[FilterBackend] = None
        self._model_in: Optional[StreamSpec] = None
        self._model_out: Optional[StreamSpec] = None
        # output schemas the backend derived, per input schema (negotiation
        # and the caps event ask for the same one)
        self._derived: Dict[StreamSpec, StreamSpec] = {}
        # set by the pipeline's device-fusion pass for one run
        self._auto_batch_through = False
        self.invokes = 0  # backend calls (one per micro-batch or frame)
        # the depth-N dispatch window (made at start() under the element's
        # final name: its reaper thread is "<name>-reaper")
        self._inflight = CompletionWindow(self.name)
        # the ingest lane and the one-batch deferral that double-buffers it
        self._lane: Optional[HostStagingLane] = None
        self._staged: Optional[Tuple[StagedBatch, List[TensorFrame]]] = None
        # do the backend's outputs support the async copy? latched per backend
        self._win_async: Optional[bool] = None

    @property
    def batch_through_active(self) -> bool:
        return bool(self.props["batch-through"]) or self._auto_batch_through

    # -- device fusion (pipeline pass) --------------------------------------
    @property
    def can_fuse_postprocess(self) -> bool:
        return self.backend is not None and hasattr(self.backend, "append_postprocess")

    def fuse_device_postprocess(self, fn) -> None:
        """Fold ``fn`` (operates on the model's output list, on device) into
        the backend call; the cached output schema no longer holds."""
        if not self.can_fuse_postprocess:
            raise ElementError(f"{self.name}: backend cannot fuse a postprocess")
        self.backend.append_postprocess(fn)
        self._model_out = None
        self._derived.clear()

    # -- batching hook for the scheduler ------------------------------------
    @property
    def preferred_batch(self) -> int:
        be = self.backend
        if be is not None and be.supports_batch:
            return max(1, int(self.props["max-batch"]))
        return 1

    @property
    def batch_wait_s(self) -> float:
        return max(0, int(self.props["batch-timeout"])) / 1000.0

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> None:
        self._auto_batch_through = False  # re-set by the fusion pass, or not
        lane_mode = str(self.props["ingest-lane"] or "auto").lower()
        if lane_mode not in ("auto", "on", "off"):
            raise ElementError(f"{self.name}: ingest-lane={lane_mode!r} (want auto|on|off)")
        fw = self.props["framework"]
        try:
            backend_cls = find_backend(fw)
        except KeyError:
            raise ElementError(f"{self.name}: unknown framework {fw!r}") from None
        props = dict(self.props)
        enabled, wishes = parse_accelerator(self.props["accelerator"])
        props["accelerators"] = wishes if enabled else ["cpu"]
        be = backend_cls()
        be.open(self.props["model"] or None, props)
        self.backend = be
        self._model_in, self._model_out = be.get_model_info()
        self._derived = {}
        # async device feed, armed for the fresh backend
        self._inflight = CompletionWindow(self.name)
        self._win_async = None
        self._staged = None
        self._lane = None
        if lane_mode != "off" and self.preferred_batch > 1:
            if be.SUPPORTS_STAGING:
                self._lane = HostStagingLane(
                    be.to_device, name=self.name, placement=be.staging_placement())
            elif lane_mode == "on":
                self.stop()
                raise ElementError(
                    f"{self.name}: ingest-lane=on but backend {fw!r} does not support "
                    "staged host->device placement")
        elif lane_mode == "on":
            self.stop()
            raise ElementError(
                f"{self.name}: ingest-lane=on requires max-batch>1 "
                "(staging overlaps per-micro-batch copies)")

    def stop(self) -> None:
        self._discard_staged()
        self._inflight.close()  # drops parked batches and stops the reaper
        if self._lane is not None:
            self._lane.close()
            self._lane = None
        if self.backend is not None:
            self.backend.close()
            self.backend = None

    # -- negotiation --------------------------------------------------------
    def accept_spec(self, pad, spec):
        if self._model_in is not None and spec.tensors and not self._model_in.is_compatible(spec):
            raise ElementError(
                f"{self.name}: stream schema {spec.to_string()} does not match "
                f"model input {self._model_in.to_string()}")
        return spec

    def derive_spec(self, pad=0):
        if self._model_out is not None:
            return self._model_out
        in_spec = self.sink_specs.get(0, ANY)
        if self.backend is not None and in_spec.tensors:
            if in_spec not in self._derived:
                self._derived[in_spec] = self.backend.set_input_info(in_spec)
            return self._derived[in_spec]
        return ANY

    # -- processing ---------------------------------------------------------
    def pending_frames(self) -> int:
        """Logical frames parked in the dispatch window plus the staged (not
        yet dispatched) ingest batch."""
        n = sum(sum(getattr(f, "batch_size", 1) for f in frames)
                for frames in self._inflight.payloads())
        staged = self._staged
        if staged is not None:
            n += len(staged[1])
        return n

    def transform(self, frame: TensorFrame) -> TensorFrame:
        # a pre-batched block on the per-frame path: its batch axis still
        # means "batch", and the block stays whole
        invoke = self.backend.invoke_batch if isinstance(frame, BatchFrame) else self.backend.invoke
        self.invokes += 1
        return frame.with_tensors(invoke(list(frame.tensors)))

    def handle_frame_batch(
        self, pad: int, frames: List[TensorFrame]
    ) -> List[Tuple[int, TensorFrame]]:
        """Micro-batched path: the scheduler hands N frames; they run as
        invoke_batch calls of at most max-batch logical frames each."""
        if any(isinstance(f, BatchFrame) for f in frames):
            # block ingest: the batch axis already exists; a staged lane
            # batch is older, so it goes first
            return self._flush_staged() + self._handle_prebatched(frames)
        if len(frames) == 1:
            # a queue-starved moment: release the staged batch and drain the
            # window first, so this frame cannot overtake them
            results = self._flush_staged()
            results.extend(self._drain_inflight())
            results.append((0, self.transform(frames[0])))
            return results
        if self._lane is not None and type(frames[0].tensors[0]) is np.ndarray:
            # host ingest: stacking and the copy to the device move to the
            # lane thread, and dispatch is DEFERRED BY ONE BATCH: by the time
            # batch k's device tensors are needed, its copy has overlapped
            # batch k-1's compute
            job = self._lane.submit([list(f.tensors) for f in frames])
            prev, self._staged = self._staged, (job, frames)
            if prev is None:
                return []
            return self._run_batch(self._staged_result(prev[0]), prev[1])
        results = self._flush_staged()  # a mixed stream keeps FIFO
        results.extend(self._run_batch(_batched_tensors(frames), frames))
        return results

    def _handle_prebatched(self, frames: List[TensorFrame]) -> List[Tuple[int, TensorFrame]]:
        """Frames that carry a batch axis (possibly mixed with plain ones):
        one concatenation, chunked so max-batch keeps bounding the invoke's
        batch axis."""
        batched = _batched_tensors(frames)
        infos = _logical_infos(frames)
        mb = max(1, int(self.props["max-batch"]))
        if len(infos) <= mb:
            return self._run_batch(batched, frames)
        results = []
        for k in range(0, len(infos), mb):
            cinfos = infos[k:k + mb]
            chunk = BatchFrame(
                tensors=[t[k:k + mb] for t in batched], pts=cinfos[0][0],
                duration=cinfos[0][1], meta=dict(cinfos[0][2]), frames_info=list(cinfos))
            results.extend(self._run_batch(chunk.tensors, [chunk]))
        return results

    def _run_batch(
        self, batched: List[Any], frames: List[TensorFrame]
    ) -> List[Tuple[int, TensorFrame]]:
        """One invoke_batch, then batch-through (the whole micro-batch leaves
        as ONE frame, outputs still on the device; the next host boundary
        splits it) or the dispatch window."""
        out_b = self.backend.invoke_batch(batched)
        self.invokes += 1
        if self.batch_through_active:
            infos = _logical_infos(frames)
            p, d, m = infos[0]
            return [(0, BatchFrame(tensors=list(out_b), pts=p, duration=d,
                                   meta=dict(m), frames_info=infos))]
        return self._dispatch_or_park(out_b, frames)

    def _dispatch_or_park(
        self, out_b: List[Any], frames: List[TensorFrame]
    ) -> List[Tuple[int, TensorFrame]]:
        """Depth-N dispatch: start this batch's device-to-host copies right
        behind its launches, park it in the window (its reaper waits for
        the copies), then emit whatever COMPLETED at the front.  A full
        window waits for its oldest entry's completion, never on the
        device."""
        depth = max(1, int(self.props["dispatch-depth"]))
        if self._win_async is None:
            # latched once per backend: the hot path never re-probes
            self._win_async = any(
                _is_torch(o) or hasattr(o, "copy_to_host_async") for o in out_b)
            if not self._win_async and depth > 1:
                self.log.info(
                    "dispatch-depth=%d requested but %r outputs are host-resident: "
                    "the dispatch window degrades to the synchronous path",
                    depth, self.props["framework"])
        if depth > 1 and self._win_async:
            self._inflight.park(start_host_copies(out_b), frames)
            results = self._pop_ready()
            while len(self._inflight) > depth - 1:
                self._wait_window_oldest()
                results.extend(self._pop_ready())
            return results
        # synchronous: batches parked while the window was active go first
        return self._drain_inflight() + self._emit_batch(materialize(out_b), frames)

    @staticmethod
    def _emit_batch(out_np: List[np.ndarray], frames: List[TensorFrame]
                    ) -> List[Tuple[int, TensorFrame]]:
        """One frame per logical input frame, each a view of its rows."""
        return [
            (0, TensorFrame([o[b] for o in out_np], pts=p, duration=d, meta=dict(m)))
            for b, (p, d, m) in enumerate(_logical_infos(frames))
        ]

    def _pop_ready(self) -> List[Tuple[int, TensorFrame]]:
        results: List[Tuple[int, TensorFrame]] = []
        for mats, frames in self._inflight.pop_ready():
            results.extend(self._emit_batch(mats, frames))
        return results

    def _check_stopping(self, what: str) -> None:
        pipe = self._pipeline
        if pipe is not None and pipe._stop_flag.is_set():
            raise ElementError(f"{self.name}: pipeline stopped while waiting on {what}")

    def _wait_window_oldest(self) -> None:
        """Bounded wait for the oldest parked batch's completion; gives up
        when the pipeline stops."""
        while not self._inflight.wait_oldest(timeout=0.05):
            self._check_stopping("the dispatch window")

    def _drain_inflight(self) -> List[Tuple[int, TensorFrame]]:
        results = self._pop_ready()
        while len(self._inflight):
            self._wait_window_oldest()
            results.extend(self._pop_ready())
        return results

    def _staged_result(self, job: StagedBatch) -> List[Any]:
        """A staging job's device tensors (bounded waits); re-raises the
        lane's error here, on the dispatch thread."""
        while not job.wait(timeout=0.05):
            self._check_stopping("the ingest lane")
        return job.result()

    def _discard_staged(self) -> None:
        """Drop the staged batch unseen (Flush, stop)."""
        if self._staged is not None:
            self._staged[0].discard()
            self._staged = None

    def _flush_staged(self) -> List[Tuple[int, TensorFrame]]:
        """Dispatch the deferred (staged) ingest batch, if any.  Called
        BEFORE draining the window at a boundary: the dispatch parks into
        the window, so the drain that follows emits everything in order."""
        if self._staged is None:
            return []
        job, frames = self._staged
        self._staged = None
        return self._run_batch(self._staged_result(job), frames)

    def handle_eos(self, pad: int) -> List[Tuple[int, TensorFrame]]:
        """Release the staged batch and drain the window before EOS
        propagates."""
        return self._flush_staged() + self._drain_inflight()

    def handle_idle(self) -> List[Tuple[int, TensorFrame]]:
        """Scheduler idle hook: the input went quiet, so overlap has
        nothing left to win: release the staged batch and the window
        instead of holding a live stream's tail until the next frame."""
        return self._flush_staged() + self._drain_inflight()

    def handle_event(self, pad, ev):
        if isinstance(ev, Flush):
            # a flush drops queued frames; the staged batch and the parked
            # window are frames too
            self._discard_staged()
            self._inflight.clear()
            return super().handle_event(pad, ev)
        # any other event must not overtake parked frames
        return self._flush_staged() + self._drain_inflight() + list(
            super().handle_event(pad, ev))

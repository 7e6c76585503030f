"""Application source and sink, and the thread-boundary queue.

Port of ``AppSrc``, ``TensorSink`` and ``Queue`` from
``nnstreamer_tpu/elements/basic.py``: ``appsrc`` is fed by the application
(``push``, ``push_block``, ``end_of_stream``); ``tensor_sink`` stores
frames and calls the ``connect_new_data`` callbacks, splitting
micro-batches back into frames; ``queue`` ends a fused streaming thread.
"""

from __future__ import annotations

import queue as _queue
from typing import Any, Callable, Iterator, List, Optional, Sequence

import numpy as np

from ..core.buffer import BatchFrame, TensorFrame
from ..core.types import ANY, StreamSpec
from ..pipeline.element import Property, SinkElement, SourceElement, TransformElement, element


def _as_tensor(a: Any) -> Any:
    return a if hasattr(a, "shape") else np.asarray(a)


@element("appsrc")
class AppSrc(SourceElement):
    """Push-model source: the application feeds frames via ``push()``."""

    PROPERTIES = {
        "max-buffers": Property(int, 64, "internal queue depth (a full queue blocks push)"),
    }

    def __init__(self, name=None):
        super().__init__(name)
        self._q: _queue.Queue = _queue.Queue(maxsize=self.PROPERTIES["max-buffers"].default)
        self._spec: StreamSpec = ANY

    def start(self):
        depth = int(self.props["max-buffers"])
        if self._q.maxsize != depth and self._q.empty():
            self._q = _queue.Queue(maxsize=depth)

    def set_spec(self, spec: StreamSpec) -> None:
        """Declare the schema of the frames this source will push (the
        CapsEvent it sends first; downstream negotiates against it)."""
        self._spec = spec

    def output_spec(self) -> StreamSpec:
        return self._spec

    def push(self, frame_or_arrays: Any, pts: Optional[float] = None) -> None:
        """Queue one frame: a TensorFrame, one tensor, or a list of tensors
        (numpy arrays or torch tensors, kept as they are)."""
        if isinstance(frame_or_arrays, TensorFrame):
            frame = frame_or_arrays
        else:
            arrays = (
                list(frame_or_arrays) if isinstance(frame_or_arrays, (list, tuple))
                else [frame_or_arrays]
            )
            frame = TensorFrame([_as_tensor(a) for a in arrays], pts=pts)
        self._q.put(frame)

    def push_block(self, arrays: Any, pts: Optional[Sequence[Optional[float]]] = None) -> None:
        """Push N logical frames as ONE stream item (a BatchFrame): the
        LEADING axis of every tensor is the frame axis."""
        tensors = [_as_tensor(t) for t in (arrays if isinstance(arrays, (list, tuple)) else [arrays])]
        n = int(tensors[0].shape[0])
        if any(int(t.shape[0]) != n for t in tensors[1:]):
            raise ValueError("push_block: tensors disagree on the frame axis")
        if pts is not None and len(pts) != n:
            raise ValueError(f"push_block: {len(pts)} pts for {n} frames")
        if n == 0:
            return
        pts = list(pts) if pts is not None else [None] * n
        self._q.put(BatchFrame(tensors=tensors, pts=pts[0],
                               frames_info=[(p, None, {}) for p in pts]))

    def end_of_stream(self) -> None:
        self._q.put(None)

    def frames(self) -> Iterator[TensorFrame]:
        while True:
            try:
                item = self._q.get(timeout=0.1)
            except _queue.Empty:
                p = self._pipeline
                if p is not None and p._stop_flag.is_set():
                    return
                continue
            if item is None:
                return
            yield item


@element("tensor_sink", "appsink")
class TensorSink(SinkElement):
    """Terminal sink storing frames and emitting new-data callbacks."""

    BATCH_AWARE = True  # splits blocks itself (split-batches prop)

    PROPERTIES = {
        "max-stored": Property(int, 0, "retain at most N frames (0 = all)"),
        "split-batches": Property(
            bool, True,
            "fan incoming BatchFrames back out to per-frame callbacks "
            "(false = deliver the block whole)"),
    }

    def __init__(self, name=None):
        super().__init__(name)
        self.frames: List[TensorFrame] = []
        self._callbacks: List[Callable[[TensorFrame], None]] = []

    def connect_new_data(self, cb: Callable[[TensorFrame], None]) -> None:
        self._callbacks.append(cb)

    def render(self, frame: TensorFrame) -> None:
        if isinstance(frame, BatchFrame) and self.props["split-batches"]:
            for f in frame.split():
                self.render(f)
            return
        frame = frame.to_host()
        self.frames.append(frame)
        limit = self.props["max-stored"]
        if limit and len(self.frames) > limit:
            self.frames.pop(0)
        for cb in self._callbacks:
            cb(frame)


@element("queue")
class Queue(TransformElement):
    """Thread-boundary element (≙ GstQueue): the explicit way to break a
    fused streaming thread.  A linear chain shares ONE worker thread under
    the scheduler's fusion pass; a ``queue`` ends the segment, giving the
    downstream half its own thread and a bounded mailbox of
    ``max-buffers`` items, where pipeline parallelism pays (a slow stage
    that should overlap its neighbours).  The ``leaky`` modes are not
    ported yet (ROADMAP A4.2)."""

    BATCH_AWARE = True  # batch-transparent pass-through
    THREAD_BOUNDARY = True  # the explicit fusion boundary

    PROPERTIES = {
        "max-buffers": Property(int, 16, "bounded queue depth (backpressure)"),
    }

    def transform(self, frame):
        return frame

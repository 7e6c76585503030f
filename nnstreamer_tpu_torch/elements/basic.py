"""Sources, sinks and the stream utilities.

Port of ``nnstreamer_tpu/elements/basic.py``: ``appsrc`` is fed by the
application (``push``, ``push_block``, ``push_event``,
``end_of_stream``); ``videotestsrc`` makes seeded RGB pattern frames;
``tensor_sink`` stores frames and calls the ``connect_new_data``
callbacks, splitting micro-batches back into frames; ``queue`` ends a
fused streaming thread (``leaky`` drops frames at a full queue);
``identity`` passes frames on; ``tee`` fans out to every branch;
``capsfilter`` constrains the schema; ``join`` forwards whichever input
comes first.  Payloads pass through as they are (numpy arrays or torch
tensors on any device): only ``tensor_sink`` brings them to the host.
"""

from __future__ import annotations

import queue as _queue
import time
from fractions import Fraction
from typing import Any, Callable, Iterator, List, Optional, Sequence

import numpy as np

from ..core.buffer import BatchFrame, TensorFrame
from ..core.types import ANY, FORMAT_STATIC, StreamSpec, TensorSpec
from ..pipeline.element import (
    Element,
    ElementError,
    Property,
    SinkElement,
    SourceElement,
    TransformElement,
    element,
)


def _as_tensor(a: Any) -> Any:
    return a if hasattr(a, "shape") else np.asarray(a)


def _frame_interval(framerate: str) -> float:
    """Seconds per frame from an "n/d" framerate string ("30" == "30/1")."""
    n, _, d = framerate.partition("/")
    return float(Fraction(int(d or 1), int(n)))


@element("appsrc")
class AppSrc(SourceElement):
    """Push-model source: the application feeds frames via ``push()``."""

    PROPERTIES = {
        "max-buffers": Property(int, 64, "internal queue depth (a full queue blocks push)"),
        "framerate": Property(str, "", "n/d framerate stamped on frames without pts"),
    }

    def __init__(self, name=None):
        super().__init__(name)
        self._q: _queue.Queue = _queue.Queue(maxsize=self.PROPERTIES["max-buffers"].default)
        self._spec: StreamSpec = ANY
        self._count = 0

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
        if frame.pts is None and self.props["framerate"]:
            frame.pts = self._count * _frame_interval(self.props["framerate"])
        self._count += 1
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
        if pts is None and self.props["framerate"]:
            dt = _frame_interval(self.props["framerate"])
            pts = [(self._count + i) * dt for i in range(n)]
        pts = list(pts) if pts is not None else [None] * n
        self._count += n
        self._q.put(BatchFrame(tensors=tensors, pts=pts[0],
                               frames_info=[(p, None, {}) for p in pts]))

    def push_event(self, event) -> None:
        """Queue an in-band event (``Flush``, a custom event) into the
        stream in arrival order."""
        self._q.put(event)

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


@element("videotestsrc")
class VideoTestSrc(SourceElement):
    """Synthetic video source: deterministic RGB pattern frames, byte-equal
    to the JAX package's for the same properties (``random`` draws from
    ``numpy.random.default_rng(seed)``)."""

    PROPERTIES = {
        "num-buffers": Property(int, 10, "number of frames to emit (-1 = unlimited)"),
        "width": Property(int, 224),
        "height": Property(int, 224),
        "framerate": Property(str, "30/1"),
        "pattern": Property(str, "gradient", "gradient|solid|random"),
        "seed": Property(int, 0),
    }

    def output_spec(self) -> StreamSpec:
        h, w = self.props["height"], self.props["width"]
        n, _, d = self.props["framerate"].partition("/")
        return StreamSpec((TensorSpec((h, w, 3), np.uint8, "video"),), FORMAT_STATIC,
                          Fraction(int(n), int(d or 1)))

    def frames(self) -> Iterator[TensorFrame]:
        h, w = self.props["height"], self.props["width"]
        dt = _frame_interval(self.props["framerate"])
        rng = np.random.default_rng(self.props["seed"])
        count = self.props["num-buffers"]
        i = 0
        while count < 0 or i < count:
            if self.props["pattern"] == "random":
                img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            elif self.props["pattern"] == "solid":
                img = np.full((h, w, 3), (i * 8) % 256, np.uint8)
            else:  # gradient, phase-shifted per frame
                row = (np.arange(w, dtype=np.uint32) * 255 // max(w - 1, 1) + i * 3) % 256
                img = np.broadcast_to(row[None, :, None], (h, w, 3)).astype(np.uint8)
            yield TensorFrame([img], pts=i * dt, duration=dt)
            i += 1


@element("tensor_sink", "appsink")
class TensorSink(SinkElement):
    """Terminal sink storing frames and emitting new-data callbacks."""

    BATCH_AWARE = True  # splits blocks itself (split-batches prop)

    PROPERTIES = {
        "max-stored": Property(int, 0, "retain at most N frames (0 = all)"),
        "to-host": Property(bool, True, "bring torch payloads to host numpy arrays on render "
                            "(false = store and call back with them where they live)"),
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
            if self.props["to-host"]:
                frame = frame.to_host()  # one copy per tensor, not per row
            for f in frame.split():
                self.render(f)
            return
        if self.props["to-host"]:
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
    that should overlap its neighbours).  ``leaky`` (≙ GstQueue leaky):
    a full queue drops frames instead of blocking the producer,
    ``upstream`` the incoming frame, ``downstream`` the oldest queued one;
    events are never dropped."""

    BATCH_AWARE = True  # batch-transparent pass-through
    THREAD_BOUNDARY = True  # the explicit fusion boundary

    PROPERTIES = {
        "max-buffers": Property(int, 16, "bounded queue depth (backpressure)"),
        "leaky": Property(str, "", "''|no|upstream|downstream: a full queue drops frames "
                          "instead of blocking (upstream: incoming; downstream: oldest)"),
    }

    def start(self):
        mode = (self.props["leaky"] or "no").lower()
        if mode not in ("", "no", "upstream", "downstream"):
            raise ElementError(f"{self.name}: leaky must be ''|no|upstream|downstream, "
                               f"got {self.props['leaky']!r}")

    @property
    def leaky_policy(self) -> str:
        mode = (self.props["leaky"] or "no").lower()
        return "" if mode in ("", "no") else mode

    def transform(self, frame):
        return frame


@element("identity")
class Identity(TransformElement):
    BATCH_AWARE = True  # batch-transparent; sleep scales per logical frame

    PROPERTIES = {
        "sleep": Property(float, 0.0, "artificial per-frame delay, seconds (tests)"),
    }

    def transform(self, frame):
        if self.props["sleep"]:
            time.sleep(self.props["sleep"] * getattr(frame, "batch_size", 1))
        return frame


@element("tee")
class Tee(Element):
    """1:N fan-out: every frame goes to every src pad (payloads are shared,
    not copied: downstream must not mutate them in place)."""

    BATCH_AWARE = True  # batch-transparent fan-out
    NUM_SRC_PADS = None  # request pads

    def derive_spec(self, pad=0):
        return self.sink_specs.get(0, ANY)

    def handle_frame(self, pad, frame):
        return [(i, frame) for i in range(len(self.srcpads))]


@element("capsfilter")
class CapsFilter(TransformElement):
    """Constrain the stream schema (≙ capsfilter with other/tensors caps).
    The parser makes one of a bare schema string between ``!`` links."""

    BATCH_AWARE = True  # batch-transparent

    PROPERTIES = {"caps": Property(str, "", "tensors schema string")}

    def _target(self) -> StreamSpec:
        text = self.props["caps"]
        return StreamSpec.from_string(text) if text else ANY

    def accept_spec(self, pad, spec):
        merged = self._target().intersect(spec)
        if merged is None:
            raise ElementError(
                f"{self.name}: schema {spec.to_string()} does not satisfy {self.props['caps']}")
        return merged

    def derive_spec(self, pad=0):
        return self.sink_specs.get(0, self._target())

    def transform(self, frame):
        return frame


@element("join")
class Join(Element):
    """N:1 first-come forwarding without synchronization (≙ gstjoin):
    whichever sink pad receives a frame pushes it through."""

    BATCH_AWARE = True  # batch-transparent forwarding
    NUM_SINK_PADS = None

    def derive_spec(self, pad=0):
        for spec in self.sink_specs.values():
            return spec
        return ANY

    def handle_frame(self, pad, frame):
        return [(0, frame)]

    def handle_eos(self, pad):
        return []  # the scheduler emits EOS once every pad ended

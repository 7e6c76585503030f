"""Pipeline runtime: a threaded scheduler over a graph of elements.

Port of ``nnstreamer_tpu/pipeline/pipeline.py``, reduced to the
scheduling core: static schema negotiation (``_negotiate``), the device
fusion pass that folds a decoder's device half into the upstream filter
(``_fuse_device_chains``), one worker thread per element with a bounded
mailbox between threads (backpressure; an element's ``max-buffers``
property sets its depth), micro-batch draining for elements that batch
(``preferred_batch`` > 1, filled for up to ``batch_wait_s``), the idle
hook (``handle_idle``, called when the mailbox is empty, and
``pending_frames``, which shortens the poll while the element holds
work), and EOS propagation.

Not ported yet (see ROADMAP.md): telemetry, watchdog, flight recorder,
memory monitor, deadline QoS, supervision/restart, drain, hot reload and
streaming-thread fusion.  A failing element stops the pipeline and
``wait()`` re-raises its error.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Set

from ..core.buffer import EOS, BatchFrame, CapsEvent, Event, TensorFrame
from .element import Element, ElementError, SourceElement

_STOP = object()  # mailbox sentinel: the worker exits


class Pipeline:
    """A running graph of elements."""

    def __init__(self, name: str = "pipeline", default_queue_size: int = 16):
        self.name = name
        self.log = logging.getLogger(f"nnstreamer_tpu_torch.{name}")
        self.elements: Dict[str, Element] = {}
        self.default_queue_size = default_queue_size
        self.errors: List[BaseException] = []
        self._threads: List[threading.Thread] = []
        self._stop_flag = threading.Event()
        self._sinks_done = threading.Event()
        self._sink_lock = threading.Lock()
        self._pending_sinks = 0
        self._started = False

    # -- construction -------------------------------------------------------
    def add(self, *elements: Element) -> Element:
        for el in elements:
            if el.name in self.elements and self.elements[el.name] is not el:
                raise ElementError(f"duplicate element name {el.name!r}")
            self.elements[el.name] = el
            el._pipeline = self
        return elements[-1]

    def __getitem__(self, name: str) -> Element:
        return self.elements[name]

    def _incoming(self) -> Dict[str, Set[int]]:
        """Linked sink pads of every element."""
        pads: Dict[str, Set[int]] = {n: set() for n in self.elements}
        for el in self.elements.values():
            for pad in el.srcpads:
                for dst, sink_pad in pad.links:
                    pads[dst.name].add(sink_pad)
        return pads

    # -- schema negotiation (static pass, ≙ initial caps negotiation) -------
    def _negotiate(self) -> None:
        """Propagate output schemas topologically and let each element
        validate them via accept_spec; fails fast at start()."""
        in_degree: Dict[str, int] = {n: 0 for n in self.elements}
        for el in self.elements.values():
            for pad in el.srcpads:
                for dst, _ in pad.links:
                    in_degree[dst.name] += 1
        ready = [self.elements[n] for n, d in in_degree.items() if d == 0]
        seen = 0
        while ready:
            el = ready.pop()
            seen += 1
            for i, pad in enumerate(el.srcpads):
                pad.spec = el.output_spec() if isinstance(el, SourceElement) else el.derive_spec(i)
                for dst, sink_pad in pad.links:
                    dst.set_sink_spec(sink_pad, pad.spec)
                    in_degree[dst.name] -= 1
                    if in_degree[dst.name] == 0:
                        ready.append(dst)
        if seen != len(self.elements):
            raise ElementError("pipeline graph has a cycle through pad links")

    # -- device fusion pass --------------------------------------------------
    def _fuse_device_chains(self) -> None:
        """Fold a decoder's device half into its upstream filter's model
        call and switch the pair to device-resident batch-through flow.

        Conditions (else the chain runs unfused): the filter can fuse a
        postprocess; its single src pad feeds exactly one tensor_decoder
        whose subplugin has a device half and whose only input is this
        filter.  Runs after element start() (subplugins exist) and before
        negotiation (fused schemas propagate)."""
        incoming = self._incoming()
        for el in self.elements.values():
            if not getattr(el, "can_fuse_postprocess", False):
                continue
            if len(el.srcpads) != 1 or len(el.srcpads[0].links) != 1:
                continue
            dst, _ = el.srcpads[0].links[0]
            if not getattr(dst, "can_fuse_device", False) or len(incoming[dst.name]) != 1:
                continue
            el.fuse_device_postprocess(dst._dec.device_fn)
            dst.enable_fused()
            if el.preferred_batch > 1:
                el._auto_batch_through = True
            self.log.info("device-fused %s -> %s", el.name, dst.name)

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "Pipeline":
        if self._started:
            return self
        started: List[Element] = []
        try:
            # start (open models) BEFORE negotiation so elements can expose
            # model-derived schemas
            for el in self.elements.values():
                el.start()
                started.append(el)
            self._fuse_device_chains()
            self._negotiate()
        except BaseException:
            for el in started:
                try:
                    el.stop()
                except Exception:
                    self.log.exception("stop() failed for %s", el.name)
            raise
        incoming = self._incoming()
        self._pending_sinks = sum(
            1 for el in self.elements.values()
            if not isinstance(el, SourceElement) and not any(p.is_linked for p in el.srcpads)
        )
        self.errors = []
        self._stop_flag.clear()
        self._sinks_done.clear()
        if self._pending_sinks == 0:
            self._sinks_done.set()
        for el in self.elements.values():
            if isinstance(el, SourceElement):
                target, args = self._run_source, (el,)
            else:
                # a micro-batching element needs its full batch to fit in
                # the mailbox or batches can never form at max-batch size
                size = max(self.default_queue_size, getattr(el, "preferred_batch", 1))
                if el.props.get("max-buffers"):
                    size = int(el.props["max-buffers"])
                el._mailbox = queue.Queue(maxsize=size)
                target, args = self._run_element, (el, incoming[el.name] or {0})
            self._threads.append(
                threading.Thread(target=target, args=args, name=el.name, daemon=True))
        for t in self._threads:
            t.start()
        self._started = True
        return self

    def stop(self) -> None:
        """Tear the pipeline down; frames still queued are abandoned."""
        self._stop_flag.set()
        for el in self.elements.values():
            box = el._mailbox
            if box is None:
                continue
            try:
                box.put_nowait((0, _STOP))
            except queue.Full:
                try:  # make room: the evicted frame is abandoned anyway
                    box.get_nowait()
                    box.put_nowait((0, _STOP))
                except (queue.Empty, queue.Full):
                    pass
        for t in self._threads:
            t.join(timeout=5.0)
        for el in self.elements.values():
            try:
                el.stop()
            except Exception:
                self.log.exception("stop() failed for %s", el.name)
            el._mailbox = None
        self._threads.clear()
        self._started = False

    def wait(self, timeout: Optional[float] = None) -> None:
        """Block until EOS reached every sink; re-raise the first element
        error.  A timed-out wait tears the pipeline down before raising
        ``TimeoutError``, so no worker thread outlives it."""
        finished = self._sinks_done.wait(timeout)
        if self.errors:
            raise self.errors[0]
        if not finished:
            self.stop()
            if self.errors:
                raise self.errors[0]
            raise TimeoutError(f"pipeline {self.name!r} did not finish in {timeout}s")

    # -- worker runtime ------------------------------------------------------
    def _fail(self, el: Element, e: BaseException) -> None:
        """Record a fatal element failure and stop the stream."""
        self.log.error("element %s failed", el.name, exc_info=e)
        self.errors.append(e)
        self._stop_flag.set()
        self._sinks_done.set()  # unblock wait()

    def _push(self, el: Element, src_pad: int, item) -> bool:
        """Push one item downstream with backpressure; False if stopping."""
        for dst, sink_pad in el.srcpads[src_pad].links:
            while True:
                if self._stop_flag.is_set():
                    return False
                try:
                    dst._mailbox.put((sink_pad, item), timeout=0.1)
                    break
                except queue.Full:
                    continue
        return True

    def _push_all(self, el: Element, outs) -> bool:
        for sp, out in outs or ():
            if not self._push(el, sp, out):
                return False
        return True

    def _finish_eos(self, el: Element) -> None:
        """EOS arrived on every connected pad: forward it, or end the
        stream at a terminal element."""
        if any(p.is_linked for p in el.srcpads):
            for i in range(len(el.srcpads)):
                self._push(el, i, EOS())
            return
        with self._sink_lock:
            self._pending_sinks -= 1
            if self._pending_sinks <= 0:
                self._sinks_done.set()

    def _run_source(self, el: SourceElement) -> None:
        try:
            for i in range(len(el.srcpads)):
                if not self._push(el, i, CapsEvent(el.output_spec())):
                    return
            for frame in el.frames():
                if self._stop_flag.is_set():
                    return
                outs = el.handle_event(0, frame) if isinstance(frame, Event) else [(0, frame)]
                if not self._push_all(el, outs):
                    return
            for i in range(len(el.srcpads)):
                self._push(el, i, EOS())
        except BaseException as e:  # noqa: BLE001 — worker boundary
            self._fail(el, e)

    def _run_element(self, el: Element, connected: Set[int]) -> None:
        try:
            self._element_loop(el, connected)
        except BaseException as e:  # noqa: BLE001 — worker boundary
            self._fail(el, e)

    def _element_loop(self, el: Element, connected: Set[int]) -> None:
        box = el._mailbox
        want = getattr(el, "preferred_batch", 1)
        batching = want > 1 and hasattr(el, "handle_frame_batch")
        wait_s = getattr(el, "batch_wait_s", 0.0)
        # an element holding work outside its mailbox (the generator's slot
        # engine) is polled sooner while it has some, and its idle hook
        # releases what finished meanwhile
        pending = getattr(el, "pending_frames", None)
        idle = getattr(el, "handle_idle", None)
        caps_pads: Set[int] = set()
        eos_pads: Set[int] = set()
        # items popped while filling a batch that end it (an event, another
        # pad's frame): they run next, in order
        stash: deque = deque()
        while not self._stop_flag.is_set():
            if stash:
                pad, item = stash.popleft()
            else:
                try:
                    poll = 0.02 if pending is not None and pending() > 0 else 0.1
                    pad, item = box.get(timeout=poll)
                except queue.Empty:
                    if idle is not None and not self._push_all(el, idle()):
                        return
                    continue
            if item is _STOP:
                return
            if isinstance(item, TensorFrame):
                if batching:
                    outs = el.handle_frame_batch(
                        pad, self._fill_batch(box, stash, pad, item, want, wait_s))
                elif isinstance(item, BatchFrame) and not el.BATCH_AWARE:
                    outs = [o for f in item.split() for o in el.handle_frame(pad, f) or ()]
                else:
                    outs = el.handle_frame(pad, item)
                if not self._push_all(el, outs):
                    return
            elif isinstance(item, CapsEvent):
                el.set_sink_spec(pad, item.spec)
                caps_pads.add(pad)
                if caps_pads >= connected:
                    for i in range(len(el.srcpads)):
                        if not self._push(el, i, CapsEvent(el.derive_spec(i))):
                            return
            elif isinstance(item, EOS):
                eos_pads.add(pad)
                handle_eos = getattr(el, "handle_eos", None)
                if handle_eos is not None and not self._push_all(el, handle_eos(pad)):
                    return
                if eos_pads >= connected:
                    self._finish_eos(el)
                    return
            elif not self._push_all(el, el.handle_event(pad, item)):
                return

    @staticmethod
    def _fill_batch(box, stash: deque, pad: int, first: TensorFrame,
                    want: int, wait_s: float) -> List[TensorFrame]:
        """Micro-batch draining: gather queued frames of `pad` behind
        `first` until ``want`` logical frames (a BatchFrame counts as its
        batch_size), waiting up to ``wait_s`` for the batch to fill.  An
        event or another pad's frame ends the batch and is stashed."""
        frames = [first]
        nlog = getattr(first, "batch_size", 1)
        deadline = time.monotonic() + wait_s
        while nlog < want:
            if stash:
                p2, nxt = stash[0]
                if not (isinstance(nxt, TensorFrame) and p2 == pad):
                    break
                stash.popleft()
            else:
                try:
                    wait = deadline - time.monotonic()
                    p2, nxt = box.get(timeout=wait) if wait > 0 else box.get_nowait()
                except queue.Empty:
                    break
                if not (isinstance(nxt, TensorFrame) and p2 == pad):
                    stash.append((p2, nxt))
                    break
            frames.append(nxt)
            nlog += getattr(nxt, "batch_size", 1)
        return frames

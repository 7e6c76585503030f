"""Pipeline runtime: a threaded scheduler over a graph of elements.

Port of ``nnstreamer_tpu/pipeline/pipeline.py``, reduced to the
scheduling core: static schema negotiation (``_negotiate``), the device
fusion pass that folds a decoder's device half into the upstream filter
(``_fuse_device_chains``), the streaming-thread fusion pass
(``_compute_segments``: each maximal fusable linear chain runs on ONE
worker thread, its later elements inline on the head's thread, with a
bounded mailbox only at the head; ``fuse=False`` or ``NNS_FUSE=0`` gives
one thread per element), backpressure between threads (an element's
``max-buffers`` property sets its mailbox depth), micro-batch draining
for elements that batch (``preferred_batch`` > 1, filled for up to
``batch_wait_s``), the idle hook (``handle_idle``, called when the head's
mailbox is empty, and ``pending_frames``, which shortens the poll while
the element holds work), fan-out (a pad with several links, request src
pads), N:1 EOS (an element finishes once every connected sink pad saw
EOS), leaky mailboxes (``queue leaky=upstream|downstream``: a full box
drops frames, never events), ``Flush`` (a head drops the frames still in
its mailbox and keeps the events, in order), and EOS propagation.

Not ported yet (see ROADMAP.md): telemetry, watchdog, flight recorder,
memory monitor, deadline QoS, supervision/restart, drain and hot reload.
A failing element stops the pipeline and ``wait()`` re-raises its error.
"""

from __future__ import annotations

import logging
import os
import queue
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Set

from ..core.buffer import EOS, BatchFrame, CapsEvent, Event, Flush, TensorFrame
from .element import Element, ElementError, SourceElement

_STOP = object()  # mailbox sentinel: the worker exits


class _LeakyMailbox:
    """Bounded mailbox with GstQueue leaky semantics, every decision taken
    under one lock: a frame arriving at a full box either replaces the
    oldest queued FRAME (``downstream``; events keep their position) or is
    itself discarded (``upstream``).  Events go through ``put`` with a
    bounded timeout, and callers retry, so events are never dropped or
    reordered."""

    def __init__(self, maxsize: int, policy: str):
        self._dq: deque = deque()
        self._max = max(1, maxsize)
        self.policy = policy  # "upstream" | "downstream"
        self._mtx = threading.Lock()
        self._not_empty = threading.Condition(self._mtx)
        self._not_full = threading.Condition(self._mtx)

    def put_frame(self, item) -> None:
        """Non-blocking frame delivery under the leaky policy."""
        with self._mtx:
            if len(self._dq) >= self._max:
                if self.policy == "upstream":
                    return  # the newest frame is the loss
                for i, old in enumerate(self._dq):  # downstream: the oldest frame
                    if isinstance(old[1], TensorFrame):
                        del self._dq[i]
                        break
                else:
                    return  # only events queued: the incoming frame is the loss
            self._dq.append(item)
            self._not_empty.notify()

    def put(self, item, timeout: Optional[float] = None) -> None:
        if timeout is None:  # no stop-flag escape here: callers loop
            raise ValueError("_LeakyMailbox.put requires a bounded timeout")
        with self._mtx:
            if len(self._dq) >= self._max:
                self._not_full.wait_for(lambda: len(self._dq) < self._max, timeout=timeout)
                if len(self._dq) >= self._max:
                    raise queue.Full
            self._dq.append(item)
            self._not_empty.notify()

    def put_nowait(self, item) -> None:
        self.put(item, timeout=0.0)

    def get(self, timeout: Optional[float] = None):
        with self._mtx:
            if not self._dq:
                self._not_empty.wait_for(lambda: bool(self._dq), timeout=timeout)
                if not self._dq:
                    raise queue.Empty
            item = self._dq.popleft()
            self._not_full.notify()
            return item

    def get_nowait(self):
        return self.get(timeout=0.0)

    def qsize(self) -> int:
        with self._mtx:
            return len(self._dq)


class _ElemState:
    """Per-element dispatch state inside one streaming-thread worker: the
    connected sink pads, the pads that saw caps and EOS, and the in-segment
    route (the fused downstream element's state, the src pad carrying that
    link and the sink pad it lands on; None = outputs leave through
    mailboxes)."""

    __slots__ = ("el", "connected", "eos_pads", "caps_pads", "finished",
                 "next_state", "next_pad", "out_pad")

    def __init__(self, el: Element):
        self.el = el
        self.connected: Set[int] = {0}
        self.eos_pads: Set[int] = set()
        self.caps_pads: Set[int] = set()
        self.finished = False
        self.next_state: Optional["_ElemState"] = None
        self.next_pad = 0
        self.out_pad = 0


class _Seg:
    """One streaming thread: a maximal fusable linear chain of elements.

    ``chain[0]`` is the head (a source, or the one element with a mailbox);
    every later element receives its input inline on the head's thread —
    GStreamer semantics: elements share a streaming thread unless an
    explicit ``queue`` boundary is inserted."""

    __slots__ = ("chain", "states", "stash")

    def __init__(self, chain: List[Element]):
        self.chain = chain
        self.states: Dict[str, _ElemState] = {}
        # items popped from the head mailbox while filling a batch that end
        # it (an event, another pad's frame): they run next, in order
        self.stash: deque = deque()


def _env_fuse() -> bool:
    return os.environ.get("NNS_FUSE", "1").lower() not in ("0", "false", "no")


class Pipeline:
    """A running graph of elements."""

    def __init__(self, name: str = "pipeline", default_queue_size: int = 16,
                 fuse: Optional[bool] = None):
        self.name = name
        self.log = logging.getLogger(f"nnstreamer_tpu_torch.{name}")
        self.elements: Dict[str, Element] = {}
        self.default_queue_size = default_queue_size
        # streaming-thread fusion (None = the NNS_FUSE default, on)
        self._fuse = _env_fuse() if fuse is None else bool(fuse)
        self._segments: List[_Seg] = []
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

    def chain(self, *elements: Element) -> Element:
        """Add and link elements in order; returns the last."""
        self.add(*elements)
        for a, b in zip(elements, elements[1:]):
            a.link(b)
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

    # -- streaming-thread fusion pass ----------------------------------------
    def _compute_segments(self) -> List[_Seg]:
        """Partition the element graph into streaming threads: each maximal
        fusable linear chain becomes ONE worker (its inner mailboxes are
        elided).  An edge up->down fuses iff:

        * fusion is enabled (``fuse=``/``NNS_FUSE``),
        * ``up``'s ONLY outgoing link is to ``down`` and ``down``'s only
          input is ``up`` (branches keep thread boundaries),
        * ``down`` does not declare ``THREAD_BOUNDARY`` (``queue``, a
          slotted ``tensor_generator``; they still drive their own fused
          downstream),
        * ``up`` does not declare ``FUSE_DOWNSTREAM = False``,
        * ``down`` has no leaky policy (a drop decision needs a queue),
        * neither side micro-batches (``preferred_batch > 1`` needs a
          mailbox to drain batches from, and its downstream boundary is
          what overlaps invoke with decode).

        Runs after element start() (``preferred_batch`` needs live
        backends) and after negotiation."""
        incoming: Dict[str, int] = {n: 0 for n in self.elements}
        for el in self.elements.values():
            for pad in el.srcpads:
                for dst, _ in pad.links:
                    incoming[dst.name] += 1

        def total_out(el: Element) -> int:
            return sum(len(p.links) for p in el.srcpads)

        def fusable(up: Element, down: Element) -> bool:
            if not self._fuse or isinstance(down, SourceElement):
                return False
            if total_out(up) != 1 or incoming[down.name] != 1:
                return False
            if getattr(down, "THREAD_BOUNDARY", False):
                return False
            if not getattr(up, "FUSE_DOWNSTREAM", True):
                return False
            if getattr(down, "leaky_policy", ""):
                return False
            return not (getattr(up, "preferred_batch", 1) > 1
                        or getattr(down, "preferred_batch", 1) > 1)

        fused_up: Dict[str, Element] = {}  # down name -> its fused upstream
        for el in self.elements.values():
            if total_out(el) == 1:
                for pad in el.srcpads:
                    for dst, _ in pad.links:
                        if fusable(el, dst):
                            fused_up[dst.name] = el
        segs: List[_Seg] = []
        for el in self.elements.values():
            if el.name in fused_up:
                continue  # not a head
            chain = [el]
            cur = el
            while True:
                nxt = None
                for pad in cur.srcpads:
                    for dst, _ in pad.links:
                        if fused_up.get(dst.name) is cur:
                            nxt = dst
                if nxt is None:
                    break
                chain.append(nxt)
                cur = nxt
            seg = _Seg(chain)
            for e in chain:
                st = _ElemState(e)
                st.connected = {
                    pad for other in self.elements.values() for sp in other.srcpads
                    for d, pad in sp.links if d is e
                } or {0}
                seg.states[e.name] = st
            for a, b in zip(chain, chain[1:]):  # in-segment routing links
                sa = seg.states[a.name]
                for i, pad in enumerate(a.srcpads):
                    for dst, sink_pad in pad.links:
                        if dst is b:
                            sa.next_state = seg.states[b.name]
                            sa.out_pad = i
                            sa.next_pad = sink_pad
            segs.append(seg)
        if self._fuse and any(len(s.chain) > 1 for s in segs):
            self.log.info("fused %d elements onto %d streaming thread(s): %s",
                          len(self.elements), len(segs),
                          " | ".join("+".join(e.name for e in s.chain) for s in segs))
        return segs

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
        self._segments = self._compute_segments()
        self._pending_sinks = sum(
            1 for el in self.elements.values()
            if not isinstance(el, SourceElement) and not any(p.is_linked for p in el.srcpads)
        )
        self.errors = []
        self._stop_flag.clear()
        self._sinks_done.clear()
        if self._pending_sinks == 0:
            self._sinks_done.set()
        for seg in self._segments:
            head = seg.chain[0]
            if isinstance(head, SourceElement):
                target = self._run_source
            else:
                # a micro-batching element needs its full batch to fit in
                # the mailbox or batches can never form at max-batch size
                size = max(self.default_queue_size, getattr(head, "preferred_batch", 1))
                if head.props.get("max-buffers"):
                    size = int(head.props["max-buffers"])
                leaky = getattr(head, "leaky_policy", "")
                head._mailbox = (_LeakyMailbox(size, leaky) if leaky
                                 else queue.Queue(maxsize=size))
                target = self._run_chain_head
            self._threads.append(
                threading.Thread(target=target, args=(seg,), name=head.name, daemon=True))
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

    def run(self, timeout: Optional[float] = None) -> None:
        """start + wait + stop."""
        self.start()
        try:
            self.wait(timeout)
        finally:
            self.stop()

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
    def _fail(self, el: Element, e: BaseException) -> bool:
        """Record a fatal element failure and stop the stream; False (the
        worker must exit)."""
        self.log.error("element %s failed", el.name, exc_info=e)
        self.errors.append(e)
        self._stop_flag.set()
        self._sinks_done.set()  # unblock wait()
        return False

    def _push(self, el: Element, src_pad: int, item) -> bool:
        """Push one item into the mailboxes downstream of a segment, with
        backpressure; False if stopping.  A frame bound for a leaky
        mailbox never blocks (the box drops a frame instead); events always
        take the blocking path."""
        is_frame = isinstance(item, TensorFrame)
        for dst, sink_pad in el.srcpads[src_pad].links:
            box = dst._mailbox
            if is_frame and isinstance(box, _LeakyMailbox):
                box.put_frame((sink_pad, item))
                continue
            while True:
                if self._stop_flag.is_set():
                    return False
                try:
                    dst._mailbox.put((sink_pad, item), timeout=0.1)
                    break
                except queue.Full:
                    continue
        return True

    def _route_one(self, seg: _Seg, st: _ElemState, sp: int, item) -> bool:
        """Route one output item: inline into the fused downstream element
        when the link stays inside the segment, else out through its
        mailbox.  False = the worker must exit."""
        nxt = st.next_state
        if nxt is not None:
            if sp == st.out_pad:
                return self._dispatch(seg, nxt, st.next_pad, item)
            return True  # an unlinked src pad: dropped, as _push drops it
        return self._push(st.el, sp, item)

    def _route_outs(self, seg: _Seg, st: _ElemState, outs) -> bool:
        """Route a call's outputs (a list, or a lazy iterable forwarded as
        it produces them)."""
        for sp, out in outs:
            if not self._route_one(seg, st, sp, out):
                return False
        return True

    def _finish_eos(self, seg: _Seg, st: _ElemState) -> bool:
        """``st.el`` consumed EOS on every connected pad: propagate it, or
        end the stream at a terminal element.  Returns False: the element,
        and through the inline EOS cascade everything downstream of it in
        this segment, is done."""
        el = st.el
        st.finished = True
        if any(p.is_linked for p in el.srcpads):
            for i in range(len(el.srcpads)):
                self._route_one(seg, st, i, EOS())
        else:
            with self._sink_lock:
                self._pending_sinks -= 1
                if self._pending_sinks <= 0:
                    self._sinks_done.set()
        return False

    def _dispatch(self, seg: _Seg, st: _ElemState, pad: int, item) -> bool:
        """Process one in-band item on ``st.el``, inline on the segment's
        thread; an error is the element's own.  False = the worker must
        exit (error recorded, stopping, or the stream finished)."""
        el = st.el
        try:
            if isinstance(item, TensorFrame):
                if isinstance(item, BatchFrame) and not el.BATCH_AWARE:
                    # per-frame elements get logical frames, never a batch axis
                    for f in item.split():
                        if not self._route_outs(seg, st, el.handle_frame(pad, f) or ()):
                            return False
                    return True
                return self._route_outs(seg, st, el.handle_frame(pad, item) or ())
            if isinstance(item, CapsEvent):
                el.set_sink_spec(pad, item.spec)
                st.caps_pads.add(pad)
                if st.caps_pads >= st.connected:
                    for i in range(len(el.srcpads)):
                        if not self._route_one(seg, st, i, CapsEvent(el.derive_spec(i))):
                            return False
                return True
            if isinstance(item, EOS):
                st.eos_pads.add(pad)
                handle_eos = getattr(el, "handle_eos", None)
                if handle_eos is not None and not self._route_outs(
                        seg, st, handle_eos(pad) or ()):
                    return False
                if st.eos_pads >= st.connected:
                    return self._finish_eos(seg, st)
                return True
            if isinstance(item, Flush):
                self._flush_mailbox(el._mailbox, seg.stash)
            return self._route_outs(seg, st, el.handle_event(pad, item) or ())
        except BaseException as e:  # noqa: BLE001 — the element's boundary
            return self._fail(el, e)

    def _flush_mailbox(self, box, stash: deque) -> None:
        """Drop the frames queued behind a ``Flush`` in a head's mailbox
        (and in its batch-fill stash), keeping the events in order.  A
        fused element holds nothing in flight, so only heads have any."""
        if box is None:
            return
        kept = [e for e in stash if not isinstance(e[1], TensorFrame)]
        stash.clear()
        try:
            while True:
                entry = box.get_nowait()
                if not isinstance(entry[1], TensorFrame):
                    kept.append(entry)
        except queue.Empty:
            pass
        stash.extend(kept)  # run next, before anything queued after the flush

    def _run_source(self, seg: _Seg) -> None:
        el = seg.chain[0]
        st = seg.states[el.name]
        try:
            for i in range(len(el.srcpads)):
                if not self._route_one(seg, st, i, CapsEvent(el.output_spec())):
                    return
            for frame in el.frames():
                if self._stop_flag.is_set():
                    return
                if isinstance(frame, Event):
                    if not self._route_outs(seg, st, el.handle_event(0, frame) or ()):
                        return
                elif not self._route_one(seg, st, 0, frame):
                    return
            for i in range(len(el.srcpads)):
                # unchecked: a fused downstream finishing returns False
                self._route_one(seg, st, i, EOS())
        except BaseException as e:  # noqa: BLE001 — worker boundary
            self._fail(el, e)

    def _run_chain_head(self, seg: _Seg) -> None:
        el = seg.chain[0]
        try:
            self._chain_loop(seg)
        except BaseException as e:  # noqa: BLE001 — worker boundary
            self._fail(el, e)

    def _chain_loop(self, seg: _Seg) -> None:
        el = seg.chain[0]
        st = seg.states[el.name]
        box = el._mailbox
        want = getattr(el, "preferred_batch", 1)
        batching = want > 1 and hasattr(el, "handle_frame_batch")
        wait_s = getattr(el, "batch_wait_s", 0.0)
        # an element holding work outside its mailbox (the filter's window
        # and staged batch, the generator's slot engine) is polled sooner
        # while it has some, and its idle hook releases what finished
        pending = getattr(el, "pending_frames", None)
        idle = getattr(el, "handle_idle", None)
        # fused tails with deferred output get their idle flush too
        tail_idles = [(seg.states[e.name], e.handle_idle)
                      for e in seg.chain[1:] if hasattr(e, "handle_idle")]
        stash = seg.stash
        stash.clear()
        while not self._stop_flag.is_set():
            if stash:
                pad, item = stash.popleft()
            else:
                try:
                    poll = 0.02 if pending is not None and pending() > 0 else 0.1
                    pad, item = box.get(timeout=poll)
                except queue.Empty:
                    if idle is not None and not self._route_outs(seg, st, idle() or ()):
                        return
                    for t_st, t_idle in tail_idles:
                        try:
                            t_outs = t_idle() or ()
                        except BaseException as e:  # noqa: BLE001 — the tail's error
                            self._fail(t_st.el, e)
                            return
                        if not self._route_outs(seg, t_st, t_outs):
                            return
                    continue
            if item is _STOP:
                return
            if batching and isinstance(item, TensorFrame):
                frames = self._fill_batch(box, stash, pad, item, want, wait_s)
                if not self._route_outs(seg, st, el.handle_frame_batch(pad, frames) or ()):
                    return
            elif not self._dispatch(seg, st, pad, item):
                return
            if st.finished:
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

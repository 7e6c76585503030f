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

Supervision and liveness (ROADMAP A4.3): every frame call runs under its
element's ``error-policy`` (``_supervised``: fail-stop re-raises, skip
dead-letters the frame, restart stops and starts the element with backoff
and retries the call, isolating a poisoned frame of a micro-batch), with
per-element health records (:meth:`Pipeline.health`); the watchdog
(``stall-timeout``, ``frame-deadline``, ``stall-policy``) runs on a
sweeper thread only when an element arms it; frames past their deadline
are dropped before the call (``late-policy``) and every upstream
``tensor_rate`` hears of it (``_qos_feedback``); the memory watermark
monitor (:meth:`Pipeline.enable_memory_monitor`) polls on the same
sweeper; :meth:`Pipeline.drain` flushes in-flight frames to the sinks (a source
with ``OWNS_DRAIN``, the query serversrc, ends its own stream after its
GOAWAY drain, and ``pending_frames`` of the query client and serversrc
count in the drain's accounting) and :meth:`Pipeline.reload_model`
hot-swaps a filter's model.  :meth:`Pipeline.stream_cancel_feedback`
tells the generators upstream of a serversink that a stream's client is
gone, and :meth:`Pipeline.stream_drain_feedback` (a serversrc's drain)
that their live streams hand off.  :meth:`Pipeline.register_sweep` puts a
slow-cadence poller (a telemetry-digest publisher, an autoscale
controller) on the watchdog's sweeper thread.

Observability (ROADMAP A4.4): :meth:`Pipeline.enable_tracing` attaches a
:class:`~..core.tracer.PipelineTracer` that the scheduler feeds around
every handler call (``frame_begin``/``frame_out``), at every source
(``stamp_source``) and at every mailbox (``queue_level``, and
``queue_wait`` from the ``TL_QPUT_META`` stamp ``_push`` writes); with no
tracer each hook is one ``tracer is not None`` test per frame.
:meth:`Pipeline.enable_flight_recorder` rides the tracer, and
:meth:`Pipeline.incident` (watchdog stall, dead letter, swap rollback,
memory pressure, a wedged slot pump) dumps it and posts the dump's path on
the bus.  Every running pipeline registers a collector in the process-wide
metrics registry under a unique ``pipeline=`` label;
:meth:`Pipeline.metrics_snapshot` reads it and :meth:`Pipeline.serve_metrics`
(or ``NNS_METRICS_PORT``) serves it as Prometheus text on 127.0.0.1.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

from ..core.buffer import EOS, BatchFrame, CapsEvent, Event, Flush, TensorFrame
from ..core.liveness import DEADLINE_META, StallError, Watchdog, stamp_deadline
from ..core.log import get_logger
from ..core.resilience import FAULTS, RetryPolicy, is_transient
from ..core.telemetry import (
    REGISTRY,
    TL_QPUT_META,
    FlightRecorder,
    MetricsServer,
    TelemetrySnapshot,
    claim_pipeline_label,
    collect_pipeline,
    release_pipeline_label,
)
from ..core.tracer import META_SRC_TS, PipelineTracer, frame_nbytes
from .element import Element, ElementError, SinkElement, SourceElement

_STOP = object()  # mailbox sentinel: the worker exits
_SUPERVISED_STOPPING = object()  # _supervised's answer: the worker exits quietly


@dataclass
class BusMessage:
    """Out-of-band message to the application (≙ GstMessage)."""

    kind: str  # "error" | "eos" | "element" | "warning" | "health"
    source: str
    data: Any = None


@dataclass
class ElementHealth:
    """Supervision record for one element (see ``Pipeline.health()``).

    ``dead_letters`` counts every frame dropped under the ``skip`` policy
    for the element's lifetime; ``dlq`` keeps only the most recent
    ``dead-letter-max`` of them as ``(frame, error_repr)`` pairs, the
    frames as they were (a card-resident batch stays on the card)."""

    state: str = "idle"  # idle|running|restarting|degraded|failed|finished|stalled
    restarts: int = 0  # within the current restart-window (gates the budget)
    restarts_total: int = 0  # lifetime, for health reporting
    last_restart_ts: float = 0.0
    dead_letters: int = 0
    deadline_drops: int = 0  # frames expired before this element processed them
    last_error: str = ""
    dlq: deque = None  # type: ignore[assignment]

    def __post_init__(self):
        if self.dlq is None:
            self.dlq = deque(maxlen=16)


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
                 "next_state", "next_pad", "out_pad", "watch", "terminal",
                 "delivered", "in_call")

    def __init__(self, el: Element):
        self.el = el
        self.connected: Set[int] = {0}
        self.eos_pads: Set[int] = set()
        self.caps_pads: Set[int] = set()
        self.finished = False
        self.next_state: Optional["_ElemState"] = None
        self.next_pad = 0
        self.out_pad = 0
        self.watch = None  # liveness watch, bound at worker start
        # drain accounting: a terminal element (no linked src pad) counts
        # the logical frames it consumed; in_call counts the frames taken
        # off a queue and not yet routed (a halt mid-call abandons them)
        self.terminal = False
        self.delivered = 0
        self.in_call = 0


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
        self.log = get_logger(name)
        self.elements: Dict[str, Element] = {}
        self.default_queue_size = default_queue_size
        # streaming-thread fusion (None = the NNS_FUSE default, on)
        self._fuse = _env_fuse() if fuse is None else bool(fuse)
        self._segments: List[_Seg] = []
        self.errors: List[BaseException] = []
        self._threads: List[threading.Thread] = []
        self._stop_flag = threading.Event()
        # graceful drain: sources stop producing and flush EOS
        self._drain_flag = threading.Event()
        self._sinks_done = threading.Event()
        self._sink_lock = threading.Lock()
        self._pending_sinks = 0
        self._started = False
        self._bus_watchers: List[Callable[[BusMessage], None]] = []
        # supervision: per-element health records (error-policy)
        self.health_map: Dict[str, ElementHealth] = {}
        # liveness: built at start() iff an element arms stall-timeout or
        # frame-deadline (or a memory monitor wants the cadence); the
        # sweeper thread polls it
        self._watchdog: Optional[Watchdog] = None
        self._watches: Dict[str, Any] = {}
        self._wd_thread: Optional[threading.Thread] = None
        self._upstream: Dict[str, List[Element]] = {}  # QoS feedback routing
        self._qos_warn_ts: Dict[str, float] = {}  # per-element warn throttle
        self._mem_monitor = None
        # slow-cadence pollers on the watchdog sweeper (register_sweep: the
        # serversrc's digest publisher, an autoscale controller)
        self._sweep_hooks: List[Tuple[Callable[[], Any], float]] = []
        self._seg_of: Dict[str, _Seg] = {}
        self._halt_discarded = 0
        # GstShark-analog tracing (core/tracer.py): None = off, one branch
        # per frame; the flight recorder rides the tracer
        self.tracer: Optional[PipelineTracer] = None
        self._recorder = None
        # metrics registry (core/telemetry.py): the pipeline= label claimed
        # at start(), the scrape-time collector and the /metrics endpoint
        self._telemetry_label: Optional[str] = None
        self._collector = None
        self._metrics_server = None

    # -- the bus ------------------------------------------------------------
    def post(self, msg: BusMessage) -> None:
        """Hand `msg` to every bus watcher (the port keeps no queue of
        messages: nothing reads one yet)."""
        for cb in list(self._bus_watchers):
            try:
                cb(msg)
            except Exception:  # watcher bugs must not kill workers
                self.log.exception("bus watcher failed")

    def add_bus_watcher(self, cb: Callable[[BusMessage], None]) -> None:
        self._bus_watchers.append(cb)

    def to_dot(self) -> str:
        """Graphviz DOT of the element graph (≙ GStreamer's
        GST_DEBUG_DUMP_DOT_DIR dumps): one node per element (shape by
        role), one edge per pad link, negotiated schemas as edge labels
        when known."""
        def esc(s: str) -> str:  # DOT quoted strings: no raw double quotes
            return str(s).replace('"', "'")

        lines = ["digraph pipeline {", "  rankdir=LR;",
                 "  node [fontsize=10 shape=box style=rounded];"]
        for el in self.elements.values():
            shape = ("invhouse" if isinstance(el, SourceElement)
                     else "house" if isinstance(el, SinkElement) else "box")
            lines.append(f'  "{esc(el.name)}" [label="{esc(el.name)}\\n({type(el).__name__})" '
                         f'shape={shape}];')
        for el in self.elements.values():
            for sp_i, sp in enumerate(el.srcpads):
                for dst, sink_pad in sp.links:
                    spec = dst.sink_specs.get(sink_pad)
                    label = (esc(spec.to_string())
                             if spec is not None and getattr(spec, "tensors", None) else "")
                    lines.append(f'  "{esc(el.name)}" -> "{esc(dst.name)}" '
                                 f'[taillabel="{sp_i}" headlabel="{sink_pad}" '
                                 f'label="{label}" fontsize=8];')
        lines.append("}")
        return "\n".join(lines)

    def incident(self, kind: str, source: str, detail: Any = None) -> Optional[str]:
        """Incident hook (watchdog stall, dead letter, swap rollback, memory
        pressure, a wedged slot pump): dump the flight recorder and post the
        dump's path on the bus.  No-op without a recorder; rate-limited by
        the recorder.  Returns the dump's path, if one was written."""
        rec = self._recorder
        if rec is None:
            return None
        path = rec.dump(kind, source, detail, logger=self.log)
        if path is not None:
            self.post(BusMessage("warning", source, {"incident": kind, "flight_dump": path}))
        return path

    # -- observability (core/tracer.py, core/telemetry.py) -------------------
    def enable_tracing(self, detail: bool = False) -> PipelineTracer:
        """Attach a fresh PipelineTracer (before start()); returns it.
        ``detail=True`` also records per-call spans for
        ``export_chrome_trace``."""
        recorder = self.tracer.recorder if self.tracer is not None else None
        self.tracer = PipelineTracer(detail=detail, recorder=recorder)
        return self.tracer

    def enable_flight_recorder(self, capacity: int = 4096, dump_dir: Optional[str] = None,
                               min_dump_interval_s: float = 5.0,
                               profile_incidents: bool = True,
                               profile_duration_s: float = 0.2):
        """Attach a flight recorder: a bounded ring of recent per-frame span
        timelines, dumped (rate-limited, to the log and a JSON file in
        ``dump_dir``, else ``NNS_FLIGHT_DIR``, else the temp dir) on every
        :meth:`incident`.  It rides the tracer (one is attached if absent).
        ``profile_incidents`` adds a thread profile of the named framework
        threads over ``profile_duration_s`` to every dump.  Returns the
        recorder."""
        if self.tracer is None:
            self.enable_tracing()
        self._recorder = FlightRecorder(
            capacity=capacity, dump_dir=dump_dir, min_dump_interval_s=min_dump_interval_s,
            profile_incidents=profile_incidents, profile_duration_s=profile_duration_s)
        self.tracer.recorder = self._recorder
        return self._recorder

    @property
    def flight_recorder(self):
        return self._recorder

    @property
    def telemetry_label(self) -> str:
        """The ``pipeline=`` label of this pipeline's registry series: the
        name when it is unique among live pipelines, else ``name#N``.
        Claimed at start(), released at stop(); a pipeline that is not
        running reads as its bare name without claiming it."""
        return self._telemetry_label or self.name

    def metrics_snapshot(self):
        """Pollable telemetry snapshot of this pipeline: every signal
        source under its stable dotted name.  Reads host counters only."""
        return TelemetrySnapshot(collect_pipeline(self)
                                 + REGISTRY.collect_labeled(pipeline=self.telemetry_label))

    def telemetry_summary(self) -> Dict[str, float]:
        """Compact {metric_name: value} dump (counters summed across
        elements, gauges maxed)."""
        return self.metrics_snapshot().flat()

    def serve_metrics(self, port: int = 0, host: str = "127.0.0.1") -> int:
        """Open the Prometheus text endpoint (the process-wide registry:
        every running pipeline's series, labeled).  Returns the bound port;
        ``stop()`` shuts it down.  Also armed by ``NNS_METRICS_PORT`` at
        start()."""
        if self._metrics_server is not None:
            return self._metrics_server.port
        self._metrics_server = MetricsServer(port=port, host=host, name=self.name)
        return self._metrics_server.port

    @property
    def metrics_port(self) -> Optional[int]:
        srv = self._metrics_server
        return srv.port if srv is not None else None

    def _register_telemetry(self) -> None:
        if self._collector is None:
            self._collector = lambda: collect_pipeline(self)
            REGISTRY.register_collector(self._collector)
        env_port = os.environ.get("NNS_METRICS_PORT", "")
        if env_port and self._metrics_server is None:
            try:
                self.serve_metrics(int(env_port))
            except (OSError, ValueError) as e:
                # another pipeline already owns the port (its endpoint
                # serves the shared registry, so nothing is lost)
                self.log.info("NNS_METRICS_PORT=%s not bound by this pipeline: %s",
                              env_port, e)

    def _unregister_telemetry(self) -> None:
        if self._collector is not None:
            REGISTRY.unregister_collector(self._collector)
            self._collector = None
        if self._telemetry_label is not None:
            REGISTRY.remove_labeled(pipeline=self._telemetry_label)
            release_pipeline_label(self._telemetry_label)
            self._telemetry_label = None
        if self._metrics_server is not None:
            self._metrics_server.close()
            self._metrics_server = None

    def register_sweep(self, fn: Callable[[], Any], min_poll_s: float = 1.0) -> None:
        """Register a slow-cadence poller on the watchdog sweeper thread
        (from an element's ``start()``, before the sweeper is armed).
        ``fn`` limits its own rate; ``min_poll_s`` bounds the sweeper's
        wake-up interval.  The hooks end with the run."""
        self._sweep_hooks.append((fn, max(0.05, float(min_poll_s))))

    # -- memory-pressure watermarks (core/liveness.py) -----------------------
    def enable_memory_monitor(self, high: float = 0.90, low: float = 0.75,
                              sustain_s: float = 2.0, host_limit_bytes: int = 0,
                              sample=None, clock=None, min_poll_s: float = 0.25):
        """Attach a :class:`~..core.liveness.MemoryPressureMonitor`: card
        memory (and host RSS) watermarks polled on the watchdog sweeper's
        cadence, never on a per-frame path.  Crossing ``high`` runs the
        trim ladder: the generators' cold prefix entries first, then every
        filter backend's ``trim_caches`` (the caching allocator's free
        segments), then, only while the monitor reads host memory (no card
        in use), the process's staging-buffer pools, which hold host
        memory.  Each hook returns entries.  Returns the monitor
        (``sample``/``clock`` injectable for tests)."""
        from ..core.buffer import trim_staging_pools
        from ..core.liveness import MemoryPressureMonitor

        def trim_hook(attr: str, of_backend: bool):
            def trim() -> int:
                freed = 0
                for el in self.elements.values():
                    owner = getattr(el, "backend", None) if of_backend else el
                    fn = getattr(owner, attr, None)
                    if fn is not None:
                        try:
                            freed += int(fn() or 0)
                        except Exception:
                            self.log.exception("%s failed for %s", attr, el.name)
                return freed
            trim.__name__ = attr
            return trim

        def trim_staging_pools_on_host() -> int:
            return trim_staging_pools() if mon.bytes_limit <= 0 else 0

        kwargs = {}
        if sample is not None:
            kwargs["sample"] = sample
        if clock is not None:
            kwargs["clock"] = clock
        mon = MemoryPressureMonitor(
            high=high, low=low, sustain_s=sustain_s, min_poll_s=min_poll_s,
            host_limit_bytes=host_limit_bytes,
            on_pressure=lambda snap: self.incident("memory_pressure", self.name, snap),
            trim_hooks=(trim_hook("trim_prefix_cache", False), trim_hook("trim_caches", True),
                        trim_staging_pools_on_host),
            **kwargs)
        self._mem_monitor = mon
        if self._started and (self._wd_thread is None or not self._wd_thread.is_alive()):
            # armed mid-run with no sweeper: start one for the monitor
            self._wd_thread = threading.Thread(
                target=self._watchdog_loop, args=(mon.min_poll_s,),
                name=f"{self.name}-watchdog", daemon=True)
            self._wd_thread.start()
        return mon

    @property
    def memory_monitor(self):
        """The armed :class:`~..core.liveness.MemoryPressureMonitor`, or
        None (the query serversrc sheds BUSY while it reads pressure)."""
        return self._mem_monitor

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
                st.terminal = not isinstance(e, SourceElement) and not any(
                    p.is_linked for p in e.srcpads)
                self._seg_of[e.name] = seg
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
        # the registry label is settled before any element starts, and
        # claimed here, never at scrape time
        if self._telemetry_label is None:
            self._telemetry_label = claim_pipeline_label(self.name)
        started: List[Element] = []
        try:
            # start (open models) BEFORE negotiation so elements can expose
            # model-derived schemas; a fresh run re-decides device fusion
            for el in self.elements.values():
                clear = getattr(el, "clear_device_fusion", None)
                if clear is not None:
                    clear()
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
            release_pipeline_label(self._telemetry_label)
            self._telemetry_label = None
            raise
        self._seg_of = {}
        self._segments = self._compute_segments()
        self._pending_sinks = sum(
            1 for el in self.elements.values()
            if not isinstance(el, SourceElement) and not any(p.is_linked for p in el.srcpads)
        )
        self.errors = []
        self._stop_flag.clear()
        self._drain_flag.clear()
        self._sinks_done.clear()
        if self._pending_sinks == 0:
            self._sinks_done.set()
        self.health_map = {
            el.name: ElementHealth(state="running", dlq=deque(maxlen=self._dlq_maxlen(el)))
            for el in self.elements.values()
        }
        # upstream adjacency for deadline-QoS feedback
        self._upstream = {n: [] for n in self.elements}
        for el in self.elements.values():
            for pad in el.srcpads:
                for dst, _ in pad.links:
                    self._upstream[dst.name].append(el)
        for el in self.elements.values():
            el._interrupted.clear()
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
        self._arm_watchdog()  # after the mailboxes: watches read their depth
        self._register_telemetry()
        for t in self._threads:
            t.start()
        if self._wd_thread is not None:
            self._wd_thread.start()
        self._started = True
        return self

    @staticmethod
    def _dlq_maxlen(el: Element) -> int:
        v = el.props.get("dead-letter-max")
        # 0 is valid (count drops, keep no frame); only absent means 16
        return 16 if v is None else max(0, int(v))

    def _arm_watchdog(self) -> None:
        """Build the watchdog for every element that armed stall-timeout or
        frame-deadline; no thread and no hot-path cost when nothing is
        armed and no memory monitor or sweep hook wants the cadence."""
        self._watchdog = None
        self._watches = {}
        self._wd_thread = None
        armed = [el for el in self.elements.values()
                 if float(el.props.get("stall-timeout") or 0.0) > 0
                 or float(el.props.get("frame-deadline") or 0.0) > 0]
        extra = [s for _, s in self._sweep_hooks]
        if self._mem_monitor is not None:
            extra.append(self._mem_monitor.min_poll_s)
        if not armed:
            if extra:
                self._wd_thread = threading.Thread(
                    target=self._watchdog_loop, args=(min(extra),),
                    name=f"{self.name}-watchdog", daemon=True)
            return
        self._watchdog = Watchdog()
        for el in armed:
            # a fused element has no mailbox: its segment head's holds the
            # pending work (an appsrc head: its own queue)
            box = el._mailbox
            if box is None:
                seg = self._seg_of.get(el.name)
                head = seg.chain[0] if seg else el
                box = head._mailbox or getattr(head, "_q", None)
            qsize = box.qsize if hasattr(box, "qsize") else (lambda: 0)
            self._watches[el.name] = self._watchdog.register(
                el.name,
                stall_timeout=float(el.props.get("stall-timeout") or 0.0),
                frame_deadline=float(el.props.get("frame-deadline") or 0.0),
                policy=el.props.get("stall-policy", "warn"),
                qsize=qsize,
                on_event=lambda w, kind, elapsed, el=el: self._on_liveness(el, kind, elapsed))
        self._wd_thread = threading.Thread(
            target=self._watchdog_loop, args=(min([self._watchdog.min_interval()] + extra),),
            name=f"{self.name}-watchdog", daemon=True)

    def _watchdog_loop(self, interval: float) -> None:
        while not self._stop_flag.wait(interval):
            try:
                if self._watchdog is not None:
                    self._watchdog.check()
            except Exception:  # a sweep bug must never kill liveness
                self.log.exception("watchdog sweep failed")
            mon = self._mem_monitor
            if mon is not None:
                try:
                    mon.poll()  # rate-limited internally
                except Exception:
                    self.log.exception("memory-pressure poll failed")
            for fn, _ in list(self._sweep_hooks):
                try:
                    fn()  # rate-limited internally (register_sweep)
                except Exception:
                    self.log.exception("sweep hook %r failed", fn)

    def _on_liveness(self, el: Element, kind: str, elapsed: float) -> None:
        """Watchdog escalation (sweeper thread): a bus warning always;
        stall-policy restart or fail also interrupt the hung call
        cooperatively (the worker's StallError handling restarts: only the
        hung thread itself can retry its frame)."""
        policy = el.props.get("stall-policy", "warn")
        h = self.health_map.get(el.name)
        if h is not None:
            h.last_error = f"liveness: {kind} after {elapsed:.3f}s"
        self.post(BusMessage("warning", el.name, {
            "liveness": kind, "elapsed": elapsed, "policy": policy}))
        self.incident(f"watchdog_{kind}", el.name, {"elapsed": elapsed, "policy": policy})
        if policy == "warn":
            return
        el._interrupted.set()
        if policy == "fail":
            # the element may be wedged for good: surface the failure now
            err = StallError(f"{el.name}: {kind} after {elapsed:.3f}s (stall-policy=fail)")
            if h is not None:
                h.state = "stalled"
            self.errors.append(err)
            self.post(BusMessage("error", el.name, err))
            self._stop_flag.set()
            self._sinks_done.set()

    def _halt_workers(self) -> None:
        """Immediate worker shutdown: stop flag, mailbox sentinels, join.
        Frames still queued are abandoned (``_count_abandoned`` counts
        them before element state is torn down)."""
        self._stop_flag.set()
        self._halt_discarded = 0
        for el in self.elements.values():
            box = el._mailbox
            if box is None:
                continue
            try:
                box.put_nowait((0, _STOP))
            except queue.Full:
                try:  # make room: the evicted frame is abandoned too
                    _, item = box.get_nowait()
                    if isinstance(item, TensorFrame):
                        self._halt_discarded += getattr(item, "batch_size", 1)
                    box.put_nowait((0, _STOP))
                except (queue.Empty, queue.Full):
                    pass
        for t in self._threads:
            t.join(timeout=5.0)

    def stop(self, drain: bool = False, drain_timeout: Optional[float] = None) -> None:
        """Tear the pipeline down; frames still queued are abandoned.
        ``drain=True`` first flushes every in-flight frame to the sinks via
        :meth:`drain` (bounded by ``drain_timeout``)."""
        if drain and self._started and not self._stop_flag.is_set():
            self.drain(drain_timeout)
            if not self._started:
                return  # an expired drain already tore the pipeline down
        self._halt_workers()
        if self._wd_thread is not None:
            if self._wd_thread.is_alive():
                self._wd_thread.join(timeout=2.0)
            self._wd_thread = None
        for el in self.elements.values():
            try:
                el.stop()
            except Exception:
                self.log.exception("stop() failed for %s", el.name)
            el._mailbox = None
        # after the elements' stop: a scrape racing the shutdown still sees
        # consistent health; the endpoint's listener closes here
        self._unregister_telemetry()
        self._threads.clear()
        # sweep hooks end with the run: elements register them again at the
        # next start(), so a restart never piles up stale pollers
        self._sweep_hooks = []
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

    # -- zero-downtime operations (core/lifecycle.py) ------------------------
    @property
    def draining(self) -> bool:
        """True between ``drain()`` and completion or teardown: sources
        stop producing and flush EOS (a source waiting inside ``frames()``
        polls ``lifecycle.pipeline_quiescing``)."""
        return self._drain_flag.is_set()

    def delivered_frames(self) -> int:
        """Logical frames consumed by terminal elements since start()."""
        return sum(st.delivered for seg in self._segments for st in seg.states.values())

    def _count_abandoned(self) -> int:
        """Logical frames an immediate halt abandoned: whatever is still
        queued in mailboxes, parked in elements (``pending_frames``), taken
        off a queue mid-call or stashed.  Call after ``_halt_workers`` and
        before element ``stop()`` clears that state."""
        n = self._halt_discarded
        for el in self.elements.values():
            box = el._mailbox
            if box is not None:
                try:
                    while True:
                        _, item = box.get_nowait()
                        if isinstance(item, TensorFrame):
                            n += getattr(item, "batch_size", 1)
                except queue.Empty:
                    pass
            pending = getattr(el, "pending_frames", None)
            if pending is not None:
                try:
                    n += int(pending() or 0)
                except Exception:
                    self.log.exception("pending_frames failed for %s", el.name)
        for seg in self._segments:
            n += sum(st.in_call for st in seg.states.values())
            n += sum(getattr(item, "batch_size", 1) for _, item in seg.stash
                     if isinstance(item, TensorFrame))
        return n

    def drain(self, timeout: Optional[float] = None) -> Dict[str, Any]:
        """Graceful drain: quiesce every source, flush all in-flight frames
        through to the sinks via EOS, and return exact accounting:
        ``{"drained": frames delivered to terminal elements since the call,
        "dropped": frames abandoned because the deadline expired (the
        pipeline is then torn down), "elapsed": seconds}``.  A completed
        drain leaves the pipeline stopped at EOS; ``stop()`` releases it."""
        t0 = time.monotonic()
        if not self._started:
            return {"drained": 0, "dropped": 0, "elapsed": 0.0}
        base = self.delivered_frames()
        self._drain_flag.set()
        finished = self._sinks_done.wait(timeout)
        dropped = 0
        if not finished:
            self._halt_workers()
            dropped = self._count_abandoned()
        drained = self.delivered_frames() - base
        elapsed = time.monotonic() - t0
        self.post(BusMessage("element", self.name, {"drain": {
            "drained": drained, "dropped": dropped, "elapsed": elapsed,
            "completed": finished}}))
        if not finished:
            self.stop()  # finish the teardown (workers already joined)
        return {"drained": drained, "dropped": dropped, "elapsed": elapsed}

    def reload_model(self, element, model: str = ""):
        """Zero-downtime model rollout: stage, validate and warm ``model``
        on a second backend off the hot path, then hot-swap the named
        ``tensor_filter`` at a frame boundary (``core/lifecycle.py``).
        Returns the :class:`~..core.lifecycle.SwapTicket`."""
        el = self.elements[element] if isinstance(element, str) else element
        request = getattr(el, "request_reload", None)
        if request is None:
            raise ElementError(f"{el.name} does not support hot model reload")
        return request(model)

    # -- supervision ---------------------------------------------------------
    def health(self) -> Dict[str, Dict[str, Any]]:
        """Live supervision snapshot: per element its state, policy,
        restarts (lifetime and in the window), dead letters and their
        retained depth, deadline drops, watchdog counters when armed, and
        the element's own ``health_info()`` (the filter's OOM, device-loss
        and swap counters)."""
        out: Dict[str, Dict[str, Any]] = {}
        for name, el in self.elements.items():
            h = self.health_map.get(name) or ElementHealth()
            entry: Dict[str, Any] = {
                "state": h.state,
                "policy": el.props.get("error-policy", "fail-stop"),
                "restarts": h.restarts_total,
                "restarts_window": h.restarts,
                "dead_letters": h.dead_letters,
                "dead_letter_depth": len(h.dlq),
                "deadline_drops": h.deadline_drops,
                "last_error": h.last_error,
            }
            w = self._watches.get(name)
            if w is not None:
                entry["stalls"] = w.stalls
                entry["overruns"] = w.overruns
            info = getattr(el, "health_info", None)
            if info is not None:
                try:
                    entry.update(info() or {})
                except Exception:  # health must never kill the caller
                    self.log.exception("health_info failed for %s", name)
            out[name] = entry
        return out

    def post_health(self) -> None:
        self.post(BusMessage("health", self.name, self.health()))

    # -- deadline QoS ---------------------------------------------------------
    def _expire_late(self, el: Element, frames):
        """Deadline QoS: drop frames whose budget is exhausted before `el`
        processes them (``late-policy=drop``), counted in
        ``health()[el]["deadline_drops"]``, with a bus warning at most once
        a second and QoS feedback to every upstream throttler.  A frame
        with no deadline costs one dict lookup."""
        keep = None  # forked lazily: the no-drop path copies nothing
        now = time.monotonic()
        for i, f in enumerate(frames):
            ts = f.meta.get(DEADLINE_META)
            # delivered strictly before the deadline, dropped from now >= ts
            if ts is None or now < ts:
                if keep is not None:
                    keep.append(f)
                continue
            if keep is None:
                if el.props.get("late-policy", "drop") != "drop":
                    return frames
                keep = list(frames[:i])
            n = getattr(f, "batch_size", 1)
            h = self.health_map.get(el.name)
            if h is not None:
                h.deadline_drops += n
            lateness = now - ts
            if now - self._qos_warn_ts.get(el.name, float("-inf")) >= 1.0:
                self._qos_warn_ts[el.name] = now
                self.log.warning("%s: dropped %d frame(s) %.3fs past deadline "
                                 "(late-policy=drop)", el.name, n, lateness)
                self.post(BusMessage("warning", el.name, {
                    "qos": "deadline", "dropped": n, "lateness": lateness}))
            self._qos_feedback(el, f, lateness)
        return frames if keep is None else keep

    def _notify_upstream(self, el: Element, hook: str, *args) -> None:
        """Call ``hook(*args)`` on every element upstream of `el` that has
        it (each once; a failing hook is logged)."""
        seen = {el.name}
        stack = [el.name]
        while stack:
            for up in self._upstream.get(stack.pop(), ()):
                if up.name in seen:
                    continue
                seen.add(up.name)
                note = getattr(up, hook, None)
                if note is not None:
                    try:
                        note(*args)
                    except Exception:
                        self.log.exception("%s failed for %s", hook, up.name)
                stack.append(up.name)

    def _qos_feedback(self, el: Element, frame, lateness: float) -> None:
        """Tell every upstream throttler a deadline was missed (≙ QoS
        events travelling upstream to tensor_rate): elements exposing
        ``note_qos(pts, lateness)`` shed earlier, where dropping is
        cheapest."""
        self._notify_upstream(el, "note_qos", frame.pts, lateness)

    def degraded_feedback(self, source: str, detail: str = "") -> None:
        """An element of THIS pipeline lost a device and re-sharded onto
        survivors: every element exposing ``note_degraded`` (the query
        serversrc) hears of it, so the discovery plane announces
        ``degraded:true`` and fleet routing ranks this server below whole
        ones before its next failure.  Also posted on the bus."""
        self.post(BusMessage("warning", source, {"degraded": detail}))
        for el in self.elements.values():
            note = getattr(el, "note_degraded", None)
            if note is None:
                continue
            try:
                note(detail)
            except Exception:
                self.log.exception("note_degraded failed for %s", el.name)

    def stream_cancel_feedback(self, el: Element, meta: dict) -> None:
        """A consumer of a generation stream is gone (the serversink's
        client vanished mid-stream): every upstream element exposing
        ``note_stream_cancel(meta)`` hears of it, so a slot engine frees
        the dead stream's slot instead of decoding tokens nobody will
        read."""
        self._notify_upstream(el, "note_stream_cancel", meta)

    def stream_drain_feedback(self) -> None:
        """A query serversrc of this pipeline entered its drain: every
        element exposing ``note_stream_drain()`` (the slotted generator)
        hands its live generation streams off as resumable GOAWAY chunks,
        so clients migrate them instead of the drain waiting out whole
        generations.  A plain ``drain()`` without a serversrc never fires
        it: local streams flush, they do not migrate."""
        for el in self.elements.values():
            note = getattr(el, "note_stream_drain", None)
            if note is None:
                continue
            try:
                note()
            except Exception:
                self.log.exception("note_stream_drain failed for %s", el.name)

    def _dead_letter(self, el: Element, frames, err: BaseException) -> None:
        """skip policy: keep the dropped frame(s) as they are (no host
        copy of a card tensor) and warn on the bus."""
        h = self.health_map[el.name]
        frames = frames if isinstance(frames, list) else [frames]
        n = sum(getattr(f, "batch_size", 1) for f in frames)
        for f in frames:
            h.dlq.append((f, repr(err)))
        h.dead_letters += n
        h.last_error = repr(err)
        self.log.warning("%s: dropped %d poisoned frame(s) (error-policy=skip): %s",
                         el.name, n, err)
        # the bus keeps the error's text: the exception's traceback would pin
        # the failed call's card tensors for as long as the message lives
        self.post(BusMessage("warning", el.name, {"policy": "skip", "dropped": n,
                                                  "error": repr(err)}))
        self.incident("dead_letter", el.name, err)

    def _restart_element(self, el: Element, err: BaseException) -> str:
        """restart policy: stop and start `el` with exponential backoff.
        Returns "retry" (restarted: re-run the failed call), "degraded"
        (max-restarts exhausted, or start() itself failed, as after a
        sticky CUDA error: the caller falls back to fail-stop) or
        "stopping" (the pipeline shut down mid-backoff)."""
        h = self.health_map[el.name]
        el._interrupted.clear()  # a liveness interrupt is consumed here
        h.last_error = repr(err)
        limit = int(el.props.get("max-restarts", 3))
        window = float(el.props.get("restart-window", 60.0) or 0.0)
        now = time.monotonic()
        if window > 0 and h.last_restart_ts and now - h.last_restart_ts > window:
            h.restarts = 0  # sustained health since the last restart: refill
        h.last_restart_ts = now
        if h.restarts >= limit:
            h.state = "degraded"
            self.log.error("%s: max-restarts=%d exhausted; degrading to fail-stop",
                           el.name, limit)
            self.post(BusMessage("warning", el.name, {
                "policy": "restart", "degraded": True, "error": repr(err)}))
            self.post_health()
            return "degraded"
        h.restarts += 1
        h.restarts_total += 1
        h.state = "restarting"
        base = float(el.props.get("restart-backoff", 0.05) or 0.0)
        delay = (RetryPolicy(base_delay_s=base, max_delay_s=2.0, jitter=0.1)
                 .delay_for(h.restarts) if base > 0 else 0.0)
        self.log.warning("%s: restart %d/%d after error (backoff %.3fs): %s",
                         el.name, h.restarts, limit, delay, err)
        self.post(BusMessage("warning", el.name, {
            "policy": "restart", "restart": h.restarts, "error": repr(err)}))
        try:
            el.stop()
        except Exception:
            self.log.exception("%s: stop() during restart failed", el.name)
        if (delay > 0 and self._stop_flag.wait(delay)) or self._stop_flag.is_set():
            return "stopping"
        try:
            el.start()
        except Exception:  # interrupts must propagate, not "degrade"
            self.log.exception("%s: start() during restart failed", el.name)
            h.state = "degraded"
            self.post_health()
            return "degraded"
        h.state = "running"
        return "retry"

    def _skip_failed(self, el: Element, frames, err: BaseException, per_item) -> list:
        """skip semantics for a failed call: a micro-batch with a per-item
        re-call isolates the poison (each frame re-runs alone, so one bad
        frame does not take its batchmates to the dead-letter queue);
        otherwise the whole input is dead-lettered."""
        if per_item is not None and isinstance(frames, list) and len(frames) > 1:
            outs: list = []
            for f in frames:
                try:
                    outs.extend(per_item(f) or [])
                except (KeyboardInterrupt, SystemExit):
                    raise
                except BaseException as e2:  # noqa: BLE001 — policy boundary
                    self._dead_letter(el, [f], e2)
            return outs
        self._dead_letter(el, frames, err)
        return []

    def _fast_path(self, el: Element, watch) -> bool:
        """True when ``_supervised`` would change nothing for this call: no
        watchdog heartbeat, no fault armed, no pending interrupt,
        fail-stop and stall-policy warn."""
        return (watch is None and not FAULTS.is_armed() and not el._interrupted.is_set()
                and el.props.get("error-policy", "fail-stop") == "fail-stop"
                and el.props.get("stall-policy", "warn") == "warn")

    def _call(self, el: Element, st: _ElemState, call, frames, per_item=None):
        """One frame-processing call, supervised unless nothing would
        change (the answer may be ``_SUPERVISED_STOPPING``)."""
        if self._fast_path(el, st.watch):
            return call()
        return self._supervised(el, call, frames, per_item)

    def _supervised(self, el: Element, call, frames, per_item=None):
        """Run one frame-processing call under `el`'s error-policy.

        fail-stop re-raises (the worker boundary turns it into a pipeline
        error); skip dead-letters the poisoned frame(s), isolating them per
        frame via `per_item` when the call was a micro-batch; restart
        restarts the element and retries the same call (no frame lost to a
        transient fault), degrading to fail-stop once max-restarts is spent,
        and treats fatal (bad-input) errors like skip.  A StallError (a hung
        call the watchdog interrupted) follows stall-policy whatever the
        error-policy.  Elements with ``SUPERVISES_OWN_ERRORS`` run fail-stop:
        an error surfacing in one call may belong to another in flight."""
        policy = el.props.get("error-policy", "fail-stop")
        if getattr(el, "SUPERVISES_OWN_ERRORS", False):
            policy = "fail-stop"
        wd, watch = self._watchdog, self._watches.get(el.name)
        while True:
            try:
                if el._interrupted.is_set():
                    # a stale interrupt (the flagged call completed on its
                    # own) must not leak into this healthy call
                    el._interrupted.clear()
                if watch is not None:
                    wd.begin(watch)  # before the fault site: an injected
                    # hang lands inside the monitored window
                try:
                    if FAULTS.is_armed():
                        FAULTS.check(f"element.{el.name}.handle_frame",
                                     interrupt=lambda: el.interrupted)
                    result = call()
                    if policy != "fail-stop" and not isinstance(result, (list, tuple)):
                        result = list(result)  # lazy outputs raise while iterated
                finally:
                    if watch is not None:
                        wd.done(watch)
                return result
            except (KeyboardInterrupt, SystemExit):
                raise
            except BaseException as e:  # noqa: BLE001 — policy boundary
                if isinstance(e, StallError):
                    el._interrupted.clear()
                    sp = el.props.get("stall-policy", "warn")
                    if sp == "restart":
                        verdict = self._restart_element(el, e)
                        if verdict == "retry":
                            continue
                        if verdict == "stopping":
                            return _SUPERVISED_STOPPING
                        raise  # degraded: fail-stop
                    if sp == "fail":
                        raise
                if policy == "skip":
                    return self._skip_failed(el, frames, e, per_item)
                if policy == "restart":
                    if not is_transient(e):
                        # a restart cannot fix a bad frame: dead-letter it
                        return self._skip_failed(el, frames, e, per_item)
                    verdict = self._restart_element(el, e)
                    if verdict == "retry":
                        continue
                    if verdict == "stopping":
                        return _SUPERVISED_STOPPING
                raise

    # -- worker runtime ------------------------------------------------------
    def _fail(self, el: Element, e: BaseException) -> bool:
        """Record a fatal element failure and stop the stream; False (the
        worker must exit)."""
        self.log.error("element %s failed", el.name, exc_info=e)
        h = self.health_map.get(el.name)
        if h is not None:
            h.state = "failed"
            h.last_error = repr(e)
        self.errors.append(e)
        self.post(BusMessage("error", el.name, e))
        self._stop_flag.set()
        self._sinks_done.set()  # unblock wait()
        return False

    def _push(self, el: Element, src_pad: int, item) -> bool:
        """Push one item into the mailboxes downstream of a segment, with
        backpressure; False if stopping.  A frame bound for a leaky
        mailbox never blocks (the box drops a frame instead); events always
        take the blocking path."""
        is_frame = isinstance(item, TensorFrame)
        if is_frame and self.tracer is not None:
            # queue-wait origin stamp (host-local, popped at dequeue)
            item.meta[TL_QPUT_META] = time.perf_counter()
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

    def _route_outs(self, seg: _Seg, st: _ElemState, outs, keep: int = 0) -> bool:
        """Route a call's outputs (a list, or a lazy iterable forwarded as
        it produces them).  Drain accounting, as the JAX scheduler keeps
        it: the call's input frames are gone (emitted as these outputs,
        parked behind ``pending_frames`` or delivered), so ``st.in_call``
        becomes `keep` (inputs still to come) plus the unrouted output
        frames, less each one as it is handed off: into a mailbox once the
        put succeeded, inline before the fused downstream element takes
        it over.  A halt mid-route so counts every frame once."""
        st.in_call = keep + self._outs_logical(outs)
        inline = st.next_state is not None
        for sp, out in outs:
            n = getattr(out, "batch_size", 1) if isinstance(out, TensorFrame) else 0
            if inline:
                st.in_call = max(0, st.in_call - n)
            if not self._route_one(seg, st, sp, out):
                return False
            if not inline:
                st.in_call = max(0, st.in_call - n)
        return True

    @staticmethod
    def _outs_logical(outs) -> int:
        """Logical frames in a materialized outputs list (0 for a lazy
        iterable, which makes its frames on demand)."""
        if not isinstance(outs, (list, tuple)):
            return 0
        return sum(getattr(out, "batch_size", 1) for _, out in outs
                   if isinstance(out, TensorFrame))

    def _finish_eos(self, seg: _Seg, st: _ElemState) -> bool:
        """``st.el`` consumed EOS on every connected pad: propagate it, or
        end the stream at a terminal element.  Returns False: the element,
        and through the inline EOS cascade everything downstream of it in
        this segment, is done."""
        el = st.el
        st.finished = True
        h = self.health_map.get(el.name)
        if h is not None and h.state not in ("degraded", "failed"):
            h.state = "finished"
        if any(p.is_linked for p in el.srcpads):
            for i in range(len(el.srcpads)):
                self._route_one(seg, st, i, EOS())
        else:
            with self._sink_lock:
                self._pending_sinks -= 1
                if self._pending_sinks <= 0:
                    self._sinks_done.set()
            self.post(BusMessage("eos", el.name))
        return False

    def _dispatch(self, seg: _Seg, st: _ElemState, pad: int, item) -> bool:
        """Process one in-band item on ``st.el``, inline on the segment's
        thread; an error is the element's own.  False = the worker must
        exit (error recorded, stopping, or the stream finished)."""
        el = st.el
        try:
            if isinstance(item, TensorFrame):
                return self._dispatch_frame(seg, st, pad, item)
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

    def _dispatch_frame(self, seg: _Seg, st: _ElemState, pad: int, frame) -> bool:
        """Run one frame through `st.el` under its supervision and deadline
        QoS, and route the outputs.  A BatchFrame reaching a per-frame
        element is split into logical frames, each supervised alone."""
        el = st.el
        tracer = self.tracer
        if isinstance(frame, BatchFrame) and not el.BATCH_AWARE:
            if tracer is not None:
                # the block is one traced call of batch_size frames
                t_in = time.perf_counter()
                nbytes = frame_nbytes(frame)
                tracer.frame_begin(el.name, frame)
            lfs = self._expire_late(el, frame.split())
            for k, lf in enumerate(lfs):
                st.in_call = len(lfs) - k
                outs = self._call(el, st, lambda lf=lf: el.handle_frame(pad, lf) or (), lf)
                if outs is _SUPERVISED_STOPPING:
                    return False
                if st.terminal:
                    st.delivered += 1
                if not self._route_outs(seg, st, outs, keep=len(lfs) - k - 1):
                    return False
            if tracer is not None:
                tracer.frame_out(el.name, t_in, time.perf_counter(), frame.batch_size, nbytes,
                                 frame.meta.get(META_SRC_TS), frame=frame)
            return True
        if not self._expire_late(el, (frame,)):
            return True  # past its deadline: a counted drop
        n = getattr(frame, "batch_size", 1)
        st.in_call = n
        if tracer is not None:
            t_in = time.perf_counter()
            tracer.frame_begin(el.name, frame)
        outs = self._call(el, st, lambda: el.handle_frame(pad, frame) or (), frame)
        if outs is _SUPERVISED_STOPPING:
            return False
        if st.terminal:
            st.delivered += n
        if tracer is not None:
            tracer.frame_out(el.name, t_in, time.perf_counter(), n, frame_nbytes(frame),
                             frame.meta.get(META_SRC_TS), frame=frame)
        return self._route_outs(seg, st, outs)

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
        for st in seg.states.values():
            st.watch = self._watches.get(st.el.name)
        try:
            self._supervised_source(seg)
        except BaseException as e:  # noqa: BLE001 — worker boundary
            self._fail(el, e)

    def _supervised_source(self, seg: _Seg) -> None:
        """Source supervision: ``error-policy=restart`` (or a watchdog
        interrupt under ``stall-policy=restart``) re-opens the source and
        re-enters ``frames()`` from its current state; fresh caps events
        re-negotiate downstream, and frames emitted before the error are
        not replayed.  ``skip`` cannot resume a broken generator mid-frame,
        so sources treat it as fail-stop.  Errors of fused downstream
        elements never reach here: ``_dispatch`` handles them."""
        el = seg.chain[0]
        while True:
            try:
                return self._source_body(seg)
            except (KeyboardInterrupt, SystemExit):
                raise
            except BaseException as e:  # noqa: BLE001 — policy boundary
                stall_restart = (isinstance(e, StallError)
                                 and el.props.get("stall-policy") == "restart")
                if isinstance(e, StallError):
                    el._interrupted.clear()
                if el.props.get("error-policy") != "restart" and not stall_restart:
                    raise
                if not is_transient(e):
                    raise  # a source has no input frame to dead-letter
                verdict = self._restart_element(el, e)
                if verdict == "retry":
                    continue
                if verdict == "stopping":
                    return
                raise

    def _source_body(self, seg: _Seg) -> None:
        el = seg.chain[0]
        st = seg.states[el.name]
        # deadline stamping (deadline-s), anchored at the clock at emission
        budget = float(el.props.get("deadline-s") or 0.0)
        for i in range(len(el.srcpads)):
            if not self._route_one(seg, st, i, CapsEvent(el.output_spec())):
                return
        # the busy window wraps each pull from frames() (and the fault
        # site); routing downstream stays outside it
        wd, watch = self._watchdog, self._watches.get(el.name)
        frames_it = iter(el.frames())
        src_pending = getattr(el, "pending_frames", None)
        # a source with its own drain state machine (the query serversrc:
        # GOAWAY to new requests, admitted ones still pulled) ends its
        # stream itself
        owns_drain = getattr(el, "OWNS_DRAIN", False)
        while True:
            if self._drain_flag.is_set() and not owns_drain and (
                    src_pending is None or src_pending() <= 0):
                break  # graceful drain: flush what is in flight via EOS
            if el._interrupted.is_set():
                el._interrupted.clear()  # stale: the pull completed anyway
            if watch is not None:
                wd.begin(watch)
            try:
                try:
                    frame = next(frames_it)
                except StopIteration:
                    break
                if self._stop_flag.is_set():
                    return
                if not isinstance(frame, Event) and FAULTS.is_armed():
                    FAULTS.check(f"element.{el.name}.frames", interrupt=lambda: el.interrupted)
            finally:
                if watch is not None:
                    wd.done(watch)
            if isinstance(frame, Event):
                if not self._route_outs(seg, st, el.handle_event(0, frame) or ()):
                    return
                continue
            if budget > 0:
                stamp_deadline(frame, budget)
            if self.tracer is not None:
                self.tracer.stamp_source(frame)
            if not self._route_one(seg, st, 0, frame):
                return
        for i in range(len(el.srcpads)):
            # unchecked: a fused downstream finishing returns False
            self._route_one(seg, st, i, EOS())
        h = self.health_map.get(el.name)
        if h is not None and h.state == "running":
            h.state = "finished"

    def _run_chain_head(self, seg: _Seg) -> None:
        el = seg.chain[0]
        for st in seg.states.values():
            st.watch = self._watches.get(st.el.name)
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
            tracer = self.tracer
            if tracer is not None:
                tracer.queue_level(el.name, box.qsize(), getattr(box, "maxsize", 0))
                if isinstance(item, TensorFrame):
                    # mailbox wait: the producer's stamp to this dequeue
                    t_q = item.meta.pop(TL_QPUT_META, None)
                    if t_q is not None:
                        tracer.queue_wait(el.name, time.perf_counter() - t_q)
            if batching and isinstance(item, TensorFrame):
                frames = self._expire_late(
                    el, self._fill_batch(box, stash, pad, item, want, wait_s, el.name, tracer))
                if not frames:
                    continue  # the whole micro-batch expired
                st.in_call = nlog = sum(getattr(f, "batch_size", 1) for f in frames)
                if tracer is not None:
                    t_in = time.perf_counter()
                    tracer.frame_begin(el.name, frames[0])
                outs = self._call(
                    el, st, lambda frames=frames, pad=pad: el.handle_frame_batch(pad, frames) or (),
                    frames, per_item=lambda f, pad=pad: el.handle_frame_batch(pad, [f]) or ())
                if outs is _SUPERVISED_STOPPING:
                    return
                if st.terminal:
                    st.delivered += nlog
                if tracer is not None:
                    tracer.frame_out(el.name, t_in, time.perf_counter(), nlog,
                                     sum(frame_nbytes(f) for f in frames),
                                     frames[0].meta.get(META_SRC_TS), frame=frames[0])
                if not self._route_outs(seg, st, outs):
                    return
            elif not self._dispatch(seg, st, pad, item):
                return
            if st.finished:
                return

    @staticmethod
    def _fill_batch(box, stash: deque, pad: int, first: TensorFrame,
                    want: int, wait_s: float, name: str = "", tracer=None) -> List[TensorFrame]:
        """Micro-batch draining: gather queued frames of `pad` behind
        `first` until ``want`` logical frames (a BatchFrame counts as its
        batch_size), waiting up to ``wait_s`` for the batch to fill.  An
        event or another pad's frame ends the batch and is stashed.  With a
        tracer, each frame taken off the mailbox records its wait."""
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
                if tracer is not None and isinstance(nxt, TensorFrame):
                    t_q = nxt.meta.pop(TL_QPUT_META, None)
                    if t_q is not None:
                        tracer.queue_wait(name, time.perf_counter() - t_q)
                if not (isinstance(nxt, TensorFrame) and p2 == pad):
                    stash.append((p2, nxt))
                    break
            frames.append(nxt)
            nlog += getattr(nxt, "batch_size", 1)
        return frames

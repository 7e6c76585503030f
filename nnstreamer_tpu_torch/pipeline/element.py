"""Element model: the composable unit of a pipeline.

Port of ``nnstreamer_tpu/pipeline/element.py``: declared, string-parsable
properties (``PROPERTIES``), src pads and links, schema negotiation by
``accept_spec``/``derive_spec``, and the processing hooks the scheduler
calls (``handle_frame``, ``handle_event``; sources ``frames()``, sinks
``render()``), request pads (``NUM_SINK_PADS``/``NUM_SRC_PADS = None``:
N:1 elements allocate a sink pad per link, 1:N elements a src pad per
branch), the fusion hints ``THREAD_BOUNDARY`` / ``FUSE_DOWNSTREAM``, and
the supervision and liveness properties every element answers
(``COMMON_PROPERTIES``: ``error-policy``, ``max-restarts``,
``restart-backoff``, ``restart-window``, ``dead-letter-max``,
``frame-deadline``, ``stall-timeout``, ``stall-policy``, ``late-policy``,
and the sources' ``deadline-s``, anchored at emission) with the
cooperative interrupt flag (:attr:`Element.interrupted`), and
``_apply_config_file`` for elements that declare ``config-file`` (its
key=value lines become properties; properties set explicitly win).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Tuple

from ..core.buffer import Event, TensorFrame
from ..core.liveness import _check_stall_policy
from ..core.log import get_logger
from ..core.types import ANY, StreamSpec


@dataclass
class Property:
    """Declared element property: type-checked, string-parsable."""

    type: type = str
    default: Any = None
    doc: str = ""
    # optional validator/transformer applied after type conversion
    convert: Optional[Callable[[Any], Any]] = None

    def parse(self, value: Any) -> Any:
        if isinstance(value, str) and self.type is bool:
            value = value.strip().lower() in ("1", "true", "yes", "on")
        if value is not None and not isinstance(value, self.type):
            try:
                value = self.type(value)
            except (TypeError, ValueError):
                raise ValueError(f"cannot convert {value!r} to {self.type.__name__}") from None
        return self.convert(value) if self.convert else value


def parse_host_list(raw: str, owner: str, prop: str) -> List[Tuple[str, int]]:
    """A 'h1:p1,h2:p2' property value as [(host, port), ...]: one parser for
    every multi-remote list (the query client's ``hosts``, edgesrc's
    ``dest-hosts``, the ``dest-brokers`` failover lists)."""
    targets: List[Tuple[str, int]] = []
    for part in raw.split(","):
        part = part.strip()
        if not part:
            continue
        h, sep, p = part.rpartition(":")
        if not sep or not h or not p.isdigit():
            raise ElementError(f"{owner}: bad {prop} entry {part!r} (want host:port)")
        targets.append((h, int(p)))
    if not targets:
        raise ElementError(f"{owner}: {prop} parsed to nothing")
    return targets


def enum_prop_check(prop: str, *choices: str):
    """Converter for enum-valued properties: a typo fails at set time."""
    def convert(v: str) -> str:
        if v not in choices:
            raise ValueError(f"{prop} {v!r} (want {' | '.join(choices)})")
        return v
    return convert


#: properties every element answers, under each class's own PROPERTIES
#: (a class declaring the same key wins): supervision (what the scheduler
#: does when the element raises on a frame; events always fail-stop) and
#: liveness (the watchdog and deadline QoS)
COMMON_PROPERTIES: Dict[str, Property] = {
    "error-policy": Property(
        str, "fail-stop",
        "on frame error: fail-stop (stop the pipeline) | skip (drop the frame to the "
        "dead-letter queue) | restart (restart the element with backoff and retry the "
        "frame; fail-stop after max-restarts)",
        convert=enum_prop_check("error-policy", "fail-stop", "skip", "restart")),
    "max-restarts": Property(
        int, 3, "restart policy: restarts allowed within restart-window before fail-stop"),
    "restart-backoff": Property(
        float, 0.05, "restart policy: base backoff seconds (doubles per restart, cap 2 s)"),
    "restart-window": Property(
        float, 60.0, "restart policy: seconds of health after which the restart budget "
        "refills (0 = a lifetime budget)"),
    "dead-letter-max": Property(
        int, 16, "skip policy: dropped frames kept for inspection (0 = count only)"),
    "frame-deadline": Property(
        float, 0.0, "watchdog: max seconds one frame call may run (0 = off)"),
    "stall-timeout": Property(
        float, 0.0, "watchdog: seconds with input queued and no frame done (0 = off)"),
    "stall-policy": Property(
        str, "warn", "on a stall or overrun: warn | restart (interrupt the hung call, "
        "restart and retry) | fail", convert=_check_stall_policy),
    "late-policy": Property(
        str, "drop", "frames past their deadline: drop (counted in health()) | deliver",
        convert=enum_prop_check("late-policy", "drop", "deliver")),
    "deadline-s": Property(
        float, 0.0, "sources: stamp each frame with this latency budget (0 = none)"),
}


class ElementError(RuntimeError):
    pass


ELEMENT_TYPES: Dict[str, type] = {}


def element(name: str, *aliases: str):
    """Class decorator registering an element factory name."""

    def wrap(cls):
        cls.FACTORY_NAME = name
        for n in (name, *aliases):
            ELEMENT_TYPES[n] = cls
        return cls

    return wrap


def make_element(factory: str, name: Optional[str] = None, **props) -> "Element":
    if factory not in ELEMENT_TYPES:
        raise ElementError(f"no such element factory {factory!r}")
    el = ELEMENT_TYPES[factory](name=name)
    for k, v in props.items():
        el.set_property(k, v)
    return el


class SrcPad:
    """An output pad; its links are (downstream element, sink pad)."""

    def __init__(self):
        self.links: List[Tuple["Element", int]] = []
        self.spec: Optional[StreamSpec] = None

    def link(self, sink_element: "Element", sink_pad: int = 0) -> None:
        self.links.append((sink_element, sink_pad))

    @property
    def is_linked(self) -> bool:
        return bool(self.links)


class Element:
    """Base pipeline element.

    Subclass contract: class attrs ``NUM_SINK_PADS`` / ``NUM_SRC_PADS``
    (``None`` = request pads, created on link), ``PROPERTIES``; override
    ``accept_spec``, ``derive_spec``,
    ``handle_frame``, ``handle_event``, ``start``/``stop`` as needed.
    """

    #: a BatchFrame reaches this element whole only when True; otherwise
    #: the scheduler splits it into logical frames first
    BATCH_AWARE = False

    #: True = this element keeps its own mailbox and streaming thread: the
    #: scheduler's fusion pass never runs it inline on its upstream's
    #: thread (``queue``; a slotted ``tensor_generator``)
    THREAD_BOUNDARY = False

    #: False = the element's downstream never runs inline on its thread
    FUSE_DOWNSTREAM = True

    FACTORY_NAME = "element"
    NUM_SINK_PADS: Optional[int] = 1
    NUM_SRC_PADS: Optional[int] = 1
    PROPERTIES: Dict[str, Property] = {}

    def __init__(self, name: Optional[str] = None):
        self.name = name or f"{self.FACTORY_NAME}{id(self) & 0xFFFF}"
        self.log = get_logger(self.name)
        self.props: Dict[str, Any] = {
            **{k: p.default for k, p in COMMON_PROPERTIES.items()},
            **{k: p.default for k, p in self.PROPERTIES.items()},
        }
        # keys set explicitly (pipeline text or API): a config-file defers
        # to them
        self._explicit_props: set = set()
        self.srcpads: List[SrcPad] = [SrcPad() for _ in range(self.NUM_SRC_PADS or 0)]
        self.sink_specs: Dict[int, StreamSpec] = {}
        self._pipeline = None  # set by Pipeline.add
        self._mailbox = None  # set by Pipeline.start for elements with sink pads
        # set by the watchdog to interrupt a hung call cooperatively (see
        # `interrupted`); cleared when the stall is handled
        self._interrupted = threading.Event()

    # -- properties ---------------------------------------------------------
    def set_property(self, key: str, value: Any) -> None:
        key = key.replace("_", "-")
        decl = self.PROPERTIES.get(key) or COMMON_PROPERTIES.get(key)
        if decl is None:
            raise ElementError(f"{self.name}: unknown property {key!r}")
        self.props[key] = decl.parse(value)
        self._explicit_props.add(key)

    def get_property(self, key: str) -> Any:
        key = key.replace("_", "-")
        if key not in self.props:
            raise ElementError(f"{self.name}: unknown property {key!r}")
        return self.props[key]

    def _apply_config_file(self) -> None:
        """The ``config-file`` property: its key=value lines become
        properties, and properties set explicitly win.  Elements that
        declare the property call this at the top of ``start()``."""
        path = self.props.get("config-file", "")
        if not path:
            return
        try:
            with open(path) as f:
                lines = f.read().splitlines()
        except OSError as e:
            raise ElementError(f"{self.name}: config-file: {e}") from None
        for ln, raw in enumerate(lines, 1):
            line = raw.strip()
            # comment lines only: an inline '#' may be part of a value
            if not line or line.startswith("#"):
                continue
            key, sep, value = line.partition("=")
            if not sep:
                raise ElementError(
                    f"{self.name}: config-file {path}:{ln}: expected "
                    f"key=value, got {raw!r}")
            key = key.strip().replace("_", "-")
            if key == "config-file":
                raise ElementError(
                    f"{self.name}: config-file {path}:{ln}: nested config-file not allowed")
            if key in self._explicit_props:
                continue
            try:
                self.set_property(key, value.strip())
            except (ElementError, ValueError) as e:
                raise ElementError(f"{self.name}: config-file {path}:{ln}: {e}") from None
            self._explicit_props.discard(key)  # config values stay soft

    # -- pads ---------------------------------------------------------------
    def request_src_pad(self) -> SrcPad:
        """A new src pad (request-pad elements: tee, demux, split, if)."""
        pad = SrcPad()
        self.srcpads.append(pad)
        return pad

    def srcpad(self, i: int = 0) -> SrcPad:
        """Src pad `i`; a request-pad element allocates up to it."""
        if self.NUM_SRC_PADS is None:
            while len(self.srcpads) <= i:
                self.request_src_pad()
        return self.srcpads[i]

    def link(self, downstream: "Element", src_pad: int = 0,
             sink_pad: Optional[int] = None) -> "Element":
        """Link this element's src pad to downstream's sink pad (None = the
        next free one of a request-pad element, else 0); returns downstream
        for chaining: ``a.link(b).link(c)``."""
        if sink_pad is None:
            sink_pad = downstream.next_sink_pad()
        elif downstream.NUM_SINK_PADS is None:
            # an explicit index keeps the allocation counter consistent
            downstream._next_sink = max(downstream._next_sink, sink_pad + 1)
        self.srcpad(src_pad).link(downstream, sink_pad)
        return downstream

    _next_sink = 0

    def next_sink_pad(self) -> int:
        """Allocate the next sink pad index (N:1 request pads)."""
        if self.NUM_SINK_PADS == 1:
            return 0
        i = self._next_sink
        self._next_sink += 1
        return i

    @property
    def num_sink_pads(self) -> int:
        if self.NUM_SINK_PADS is not None:
            return self.NUM_SINK_PADS
        return max(self._next_sink, 1)

    # -- negotiation --------------------------------------------------------
    def accept_spec(self, pad: int, spec: StreamSpec) -> StreamSpec:
        """Validate/refine the incoming schema; raise ElementError to reject."""
        return spec

    def derive_spec(self, pad: int = 0) -> StreamSpec:
        """Output schema for src pad `pad`, given ``self.sink_specs``."""
        return self.sink_specs.get(0, ANY)

    def set_sink_spec(self, pad: int, spec: StreamSpec) -> None:
        self.sink_specs[pad] = self.accept_spec(pad, spec)

    # -- liveness -----------------------------------------------------------
    @property
    def interrupted(self) -> bool:
        """True when the watchdog (stall-policy escalation) or a pipeline
        stop wants this element's current call to give up now.  Element
        code doing long waits polls it between steps and raises
        :class:`~nnstreamer_tpu_torch.core.liveness.StallError`; injected
        ``hang=`` faults poll it.  A running CUDA kernel cannot be
        interrupted: only the waits around it can."""
        if self._interrupted.is_set():
            return True
        p = self._pipeline
        return p is not None and p._stop_flag.is_set()

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> None:
        """Transition to running (open models, allocate state)."""

    def stop(self) -> None:
        """Release resources."""

    # -- processing ---------------------------------------------------------
    def handle_frame(self, pad: int, frame: TensorFrame) -> Iterable[Tuple[int, TensorFrame]]:
        """Process one frame from sink pad `pad`; return (src_pad, frame)s."""
        return [(0, frame)]

    def handle_event(self, pad: int, event: Event) -> Iterable[Tuple[int, Event]]:
        """Process an in-band event; default: forward to every src pad."""
        return [(i, event) for i in range(len(self.srcpads))]

    def __repr__(self):
        return f"<{type(self).__name__} {self.name!r}>"


class SourceElement(Element):
    """Element with no sink pads; produces frames from ``frames()``."""

    NUM_SINK_PADS = 0

    def frames(self) -> Iterator[TensorFrame]:
        raise NotImplementedError

    def output_spec(self) -> StreamSpec:
        """Schema this source produces (sent as CapsEvent before data)."""
        return ANY


class SinkElement(Element):
    """Element with no src pads; consumes frames via ``render()``."""

    NUM_SRC_PADS = 0

    def render(self, frame: TensorFrame) -> None:
        raise NotImplementedError

    def handle_frame(self, pad, frame):
        self.render(frame)
        return []


class TransformElement(Element):
    """1:1 element transforming each frame (≙ GstBaseTransform)."""

    def transform(self, frame: TensorFrame) -> Optional[TensorFrame]:
        raise NotImplementedError

    def handle_frame(self, pad, frame):
        out = self.transform(frame)
        return [] if out is None else [(0, out)]

"""Element model: the composable unit of a pipeline.

Port of ``nnstreamer_tpu/pipeline/element.py``: declared, string-parsable
properties (``PROPERTIES``), src pads and links, schema negotiation by
``accept_spec``/``derive_spec``, and the processing hooks the scheduler
calls (``handle_frame``, ``handle_event``; sources ``frames()``, sinks
``render()``), request pads (``NUM_SINK_PADS``/``NUM_SRC_PADS = None``:
N:1 elements allocate a sink pad per link, 1:N elements a src pad per
branch), and the fusion hints ``THREAD_BOUNDARY`` / ``FUSE_DOWNSTREAM``.
Supervision, liveness and the common properties of the JAX package are
not part of this port yet.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Any, Dict, Iterable, Iterator, List, Optional, Tuple

from ..core.buffer import Event, TensorFrame
from ..core.types import ANY, StreamSpec


@dataclass
class Property:
    """Declared element property: type-checked, string-parsable."""

    type: type = str
    default: Any = None
    doc: str = ""

    def parse(self, value: Any) -> Any:
        if isinstance(value, str) and self.type is bool:
            value = value.strip().lower() in ("1", "true", "yes", "on")
        if value is not None and not isinstance(value, self.type):
            try:
                value = self.type(value)
            except (TypeError, ValueError):
                raise ValueError(f"cannot convert {value!r} to {self.type.__name__}") from None
        return value


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
        self.log = logging.getLogger(f"nnstreamer_tpu_torch.{self.name}")
        self.props: Dict[str, Any] = {k: p.default for k, p in self.PROPERTIES.items()}
        self.srcpads: List[SrcPad] = [SrcPad() for _ in range(self.NUM_SRC_PADS or 0)]
        self.sink_specs: Dict[int, StreamSpec] = {}
        self._pipeline = None  # set by Pipeline.add
        self._mailbox = None  # set by Pipeline.start for elements with sink pads

    # -- properties ---------------------------------------------------------
    def set_property(self, key: str, value: Any) -> None:
        key = key.replace("_", "-")
        decl = self.PROPERTIES.get(key)
        if decl is None:
            raise ElementError(f"{self.name}: unknown property {key!r}")
        self.props[key] = decl.parse(value)

    def get_property(self, key: str) -> Any:
        key = key.replace("_", "-")
        if key not in self.props:
            raise ElementError(f"{self.name}: unknown property {key!r}")
        return self.props[key]

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

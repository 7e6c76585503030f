"""tensor_repo: out-of-band circular streams (loops without graph cycles).

Port of ``nnstreamer_tpu/elements/repo.py`` (reference ``gsttensor_repo.c``
with ``gsttensor_reposink.c`` / ``gsttensor_reposrc.c``): a reposink
publishes frames into a numbered process-wide slot, a reposrc replays them
as a source.  The port keeps its own slot table.
"""

from __future__ import annotations

import queue as _queue
import threading
from typing import Dict, Iterator, Optional

from ..core.buffer import TensorFrame
from ..core.types import ANY, StreamSpec
from ..pipeline.element import Property, SinkElement, SourceElement, element

_lock = threading.Lock()
_slots: Dict[int, "_Slot"] = {}


class _Slot:
    def __init__(self):
        self.q: "_queue.Queue[Optional[TensorFrame]]" = _queue.Queue()
        self.eos = threading.Event()


def _get_slot(index: int) -> _Slot:
    with _lock:
        if index not in _slots:
            _slots[index] = _Slot()
        return _slots[index]


def reset_repo() -> None:
    """Clear all slots (test isolation)."""
    with _lock:
        _slots.clear()


@element("tensor_reposink")
class TensorRepoSink(SinkElement):
    PROPERTIES = {
        "slot-index": Property(int, 0, "repo slot number"),
        "signal-rate": Property(int, 0, "reference parity (unused)"),
        "max-buffers": Property(int, 0, "mailbox depth override"),
    }

    def render(self, frame):
        _get_slot(self.props["slot-index"]).q.put(frame)

    def handle_eos(self, pad):
        slot = _get_slot(self.props["slot-index"])
        slot.eos.set()
        slot.q.put(None)
        return []


@element("tensor_reposrc")
class TensorRepoSrc(SourceElement):
    PROPERTIES = {
        "slot-index": Property(int, 0, "repo slot number"),
        "caps": Property(str, "", "announced schema (loops can't negotiate)"),
    }

    def output_spec(self) -> StreamSpec:
        text = self.props["caps"]
        return StreamSpec.from_string(text) if text else ANY

    def frames(self) -> Iterator[TensorFrame]:
        slot = _get_slot(self.props["slot-index"])
        while True:
            try:
                item = slot.q.get(timeout=0.1)
            except _queue.Empty:
                p = self._pipeline
                if (p is not None and p._stop_flag.is_set()) or slot.eos.is_set():
                    return
                continue
            if item is None:
                return
            yield item

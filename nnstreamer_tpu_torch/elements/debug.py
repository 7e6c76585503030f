"""tensor_debug: in-pipeline inspection probe.

Port of ``nnstreamer_tpu/elements/debug.py`` (reference
``gsttensor_debug.c``): logs the negotiated schema once and each frame's
timestamps and per-tensor min/max/mean, and passes the payload on.  A
torch tensor's summary is reduced on its device (three scalars to the
host per tensor); ``output-method=off`` costs nothing.
"""

from __future__ import annotations

import numpy as np

from ..core.buffer import TensorFrame, _is_torch
from ..pipeline.element import Property, TransformElement, element


def _summary(i: int, t) -> str:
    if _is_torch(t):
        head = f"t{i} {str(t.dtype).rpartition('.')[2]}{list(t.shape)}"
        if not t.numel():
            return head
        f = t.double()
        return (f"{head} min={f.min().item():.4g} max={f.max().item():.4g} "
                f"mean={f.mean().item():.4g}")
    a = np.asarray(t)
    if a.size and np.issubdtype(a.dtype, np.number):
        return (f"t{i} {a.dtype}{list(a.shape)} "
                f"min={a.min():.4g} max={a.max():.4g} mean={a.mean():.4g}")
    return f"t{i} {a.dtype}{list(a.shape)}"


@element("tensor_debug")
class TensorDebug(TransformElement):
    PROPERTIES = {
        "output-method": Property(str, "console-info", "console-info|console-warn|off"),
        "capability": Property(bool, True, "print the negotiated schema once"),
        "summary": Property(bool, True, "print per-tensor min/max/mean"),
        "max-buffers": Property(int, 0, "mailbox depth override"),
    }

    def __init__(self, name=None):
        super().__init__(name)
        self._caps_printed = False
        self.seen = 0

    def _emit(self, text: str) -> None:
        method = self.props["output-method"]
        if method == "off":
            return
        (self.log.warning if method == "console-warn" else self.log.info)(text)

    def transform(self, frame: TensorFrame) -> TensorFrame:
        self.seen += 1
        if self.props["output-method"] == "off":
            return frame  # no summary cost
        if self.props["capability"] and not self._caps_printed:
            spec = self.sink_specs.get(0)
            self._emit(f"caps: {spec.to_string() if spec else '(unknown)'}")
            self._caps_printed = True
        parts = [f"frame seq={frame.seq} pts={frame.pts}"]
        if self.props["summary"]:
            parts += [_summary(i, t) for i, t in enumerate(frame.tensors)]
        self._emit(" | ".join(parts))
        return frame

"""python3 decoder: a user-scripted decode loaded from a .py file.

Port of ``nnstreamer_tpu/decoders/python3.py`` with the same contract:
option1 is the script's path; the script defines either a class
``CustomDecoder`` (``decode(self, tensors, meta) -> tensors or a
{"tensors": [...], "meta": {...}} dict``, optionally
``get_out_spec(self, in_spec)`` and ``set_options(self, options)``) or a
module-level ``decode(tensors)``.  The script gets host numpy arrays
(tensors on the card come through ``materialize``), so one script decodes
the same in both packages; what it returns becomes the frame's payloads
through ``as_array``.
"""

from __future__ import annotations

from typing import List

from ..converters.python3 import load_script
from ..core.buffer import TensorFrame, as_array, materialize
from ..core.types import ANY, StreamSpec


class Python3Decoder:
    NAME = "python3"

    def __init__(self):
        self._impl = None
        self._fn = None

    def set_options(self, options: List[str]) -> None:
        if not options or not options[0]:
            raise ValueError("python3 decoder requires option1=<script.py>")
        mod = load_script(options[0], "decoder")
        if hasattr(mod, "CustomDecoder"):
            self._impl = mod.CustomDecoder()
            if hasattr(self._impl, "set_options"):
                self._impl.set_options(options[1:])
        elif hasattr(mod, "decode"):
            self._fn = mod.decode
        else:
            raise ValueError(f"{options[0]}: defines neither CustomDecoder nor decode()")

    def get_out_spec(self, in_spec: StreamSpec) -> StreamSpec:
        if self._impl is not None and hasattr(self._impl, "get_out_spec"):
            return self._impl.get_out_spec(in_spec)
        return ANY

    def decode(self, frame: TensorFrame, in_spec) -> TensorFrame:
        tensors = materialize(frame.tensors)
        if self._impl is not None:
            res = self._impl.decode(tensors, dict(frame.meta))
        else:
            res = self._fn(tensors)
        if isinstance(res, TensorFrame):
            return res
        if isinstance(res, dict):  # {"tensors": [...], "meta": {...}}
            out = frame.with_tensors([as_array(t) for t in res["tensors"]])
            out.meta.update(res.get("meta", {}))
            return out
        if not isinstance(res, (list, tuple)):
            res = [res]
        return frame.with_tensors([as_array(t) for t in res])

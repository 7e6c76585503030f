"""python3 converter: user-scripted media -> tensors conversion.

Port of ``nnstreamer_tpu/converters/python3.py`` with the same script
contract: the script (``tensor_converter mode=custom-script:<path.py>``,
or ``mode=custom-script:python3`` with the path in
``$NNS_TPU_CONVERTER_SCRIPT``) defines either a class ``CustomConverter``
(method ``convert(self, payload, meta) -> tensors``, optionally
``get_out_spec(self, in_spec)``) or a module-level ``convert(payload)``.
The payload is the frame's first tensor as it arrives (a numpy array, or a
torch tensor where one was pushed); what the script returns becomes the
frame's payloads through ``as_array`` (numpy arrays stay numpy, torch
tensors stay where they live), so one script gives the same tensors
through both packages.
"""

from __future__ import annotations

import importlib.util
import os

from ..core.buffer import TensorFrame, as_array
from ..core.types import ANY, StreamSpec

_SCRIPT_ENV = "NNS_TPU_CONVERTER_SCRIPT"


def load_script(path: str, prefix: str):
    """Execute the user script at `path` as a fresh module."""
    if not os.path.isfile(path):
        raise FileNotFoundError(f"python3 {prefix} script not found: {path}")
    name = f"nns_tpu_{prefix}_" + os.path.splitext(os.path.basename(path))[0]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Python3Converter:
    NAME = "python3"

    def __init__(self, script: str = ""):
        self._script = script
        self._impl = None
        self._fn = None

    def set_script(self, path: str) -> None:
        self._script = path

    def open(self) -> None:
        path = self._script or os.environ.get(_SCRIPT_ENV, "")
        if not path:
            raise ValueError(f"python3 converter needs a script (set_script or ${_SCRIPT_ENV})")
        mod = load_script(path, "converter")
        if hasattr(mod, "CustomConverter"):
            self._impl = mod.CustomConverter()
        elif hasattr(mod, "convert"):
            self._fn = mod.convert
        else:
            raise ValueError(f"{path}: defines neither CustomConverter nor convert()")

    def close(self) -> None:
        self._impl = self._fn = None

    def get_out_spec(self, in_spec: StreamSpec) -> StreamSpec:
        if self._impl is not None and hasattr(self._impl, "get_out_spec"):
            return self._impl.get_out_spec(in_spec)
        return ANY

    def convert(self, frame: TensorFrame) -> TensorFrame:
        payload = frame.tensors[0]
        if self._impl is not None:
            res = self._impl.convert(payload, dict(frame.meta))
        else:
            res = self._fn(payload)
        if isinstance(res, TensorFrame):
            return res
        if not isinstance(res, (list, tuple)):
            res = [res]
        return frame.with_tensors([as_array(t) for t in res])

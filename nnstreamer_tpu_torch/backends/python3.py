"""python3 filter backend: a user-scripted model in a ``.py`` file.

Port of ``nnstreamer_tpu/backends/python3.py`` (reference:
``tensor_filter_python3.cc``).  ``model=<script.py>`` defines a class
``CustomFilter`` with:

- ``invoke(self, inputs: list[np.ndarray]) -> list[np.ndarray]`` (required)
- ``get_model_info(self) -> (in_spec, out_spec)``: StreamSpecs or
  "type:dim" string lists (optional)
- ``set_input_info(self, in_spec) -> out_spec`` (optional)
- ``set_options(self, custom: dict)`` (optional; receives the custom props)

or a module-level ``invoke(inputs)`` for the simplest case.  Without
``set_input_info`` the output schema comes from one zero frame (≙
``setInputDim``).  Inputs reach the script as host numpy arrays, as in the
JAX package: a card tensor crosses to the host through
``core.buffer.materialize``, the port's one host-copy path.
"""

from __future__ import annotations

import importlib.util
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..core.buffer import materialize
from ..core.types import FORMAT_STATIC, StreamSpec, TensorSpec
from .base import FilterBackend


def _coerce_spec(obj) -> Optional[StreamSpec]:
    if obj is None or isinstance(obj, StreamSpec):
        return obj
    if isinstance(obj, (list, tuple)):  # e.g. ["float32:3:224:224", ...]
        return StreamSpec(
            tuple(TensorSpec.from_string(s) if isinstance(s, str) else s for s in obj),
            FORMAT_STATIC)
    if isinstance(obj, str):
        return StreamSpec.from_string(obj)
    raise TypeError(f"cannot interpret {obj!r} as a StreamSpec")


class Python3Backend(FilterBackend):
    NAME = "python3"

    def __init__(self):
        super().__init__()
        self._impl = None
        self._fn = None

    def open(self, model_path: Optional[str], props: Dict[str, Any]) -> None:
        super().open(model_path, props)
        if not model_path or not os.path.isfile(model_path):
            raise FileNotFoundError(f"python3 backend needs model=<script.py>, got {model_path!r}")
        name = "nns_torch_filter_" + os.path.splitext(os.path.basename(model_path))[0]
        spec = importlib.util.spec_from_file_location(name, model_path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        if hasattr(mod, "CustomFilter"):
            self._impl = mod.CustomFilter()
            if hasattr(self._impl, "set_options"):
                self._impl.set_options(dict(self.custom_props))
        elif hasattr(mod, "invoke"):
            self._fn = mod.invoke
        else:
            raise ValueError(f"{model_path}: defines neither CustomFilter nor invoke()")

    def close(self) -> None:
        self._impl = self._fn = None

    def get_model_info(self) -> Tuple[Optional[StreamSpec], Optional[StreamSpec]]:
        if self._impl is not None and hasattr(self._impl, "get_model_info"):
            i, o = self._impl.get_model_info()
            return _coerce_spec(i), _coerce_spec(o)
        return None, None

    def set_input_info(self, in_spec: StreamSpec) -> StreamSpec:
        if self._impl is not None and hasattr(self._impl, "set_input_info"):
            return _coerce_spec(self._impl.set_input_info(in_spec))
        # shape-polymorphic default: probe with zeros (≙ setInputDim)
        if in_spec.is_static:
            outs = self.invoke([np.zeros(t.shape, t.dtype) for t in in_spec.tensors])
            return StreamSpec(tuple(TensorSpec(o.shape, o.dtype) for o in outs),
                              FORMAT_STATIC, in_spec.framerate)
        raise NotImplementedError(f"{self.NAME}: cannot derive output schema")

    def invoke(self, inputs: List[Any]) -> List[Any]:
        arrays = materialize(inputs)
        out = self._impl.invoke(arrays) if self._impl is not None else self._fn(arrays)
        if not isinstance(out, (list, tuple)):
            out = [out]
        return [np.asarray(o) for o in out]

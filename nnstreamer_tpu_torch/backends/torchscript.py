"""torch filter backend: TorchScript archives, on the card.

Port of ``nnstreamer_tpu/backends/torch_cpu.py`` (reference:
``tensor_filter_pytorch.cc``): ``model=<file.pt>`` is a ``torch.jit.save``
archive, loaded with ``map_location`` set to the element's device, which
is the card (``cuda:0``, ``gpu.N`` another) unless the accelerator wish
list says ``cpu``.  The output schema comes from one zero frame through
the module (≙ the reference running shape inference on its input caps).
TorchScript modules are batch-polymorphic on the leading dimension, so
``invoke_batch`` is one call of the module on the micro-batch, as in the
JAX package.  Outputs stay where the module leaves them: the filter's
dispatch window brings them to the host.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..core.buffer import materialize
from ..core.types import FORMAT_STATIC, StreamSpec, TensorSpec
from . import torch_cuda
from .base import FilterBackend, register_backend


class TorchScriptBackend(FilterBackend):
    NAME = "torch"

    def __init__(self):
        super().__init__()
        self._module = None
        self._device: Optional[torch.device] = None

    @property
    def device(self) -> Optional[torch.device]:
        return self._device

    def open(self, model_path: Optional[str], props: Dict[str, Any]) -> None:
        super().open(model_path, props)
        if not model_path:
            raise ValueError("torch backend requires model=<file.pt>")
        wishes = props.get("accelerators") or ["auto"]
        exclude = props.get("exclude_ordinals") or ()
        self._device = (torch_cuda.pick_device(wishes, exclude=exclude) if exclude
                        else torch_cuda.pick_device(wishes))
        self._module = torch.jit.load(model_path, map_location=self._device)
        self._module.eval()

    def close(self) -> None:
        self._module = None

    def set_input_info(self, in_spec: StreamSpec) -> StreamSpec:
        outs = materialize(self.invoke([np.zeros(t.shape, t.dtype) for t in in_spec.tensors]))
        return StreamSpec(tuple(TensorSpec(o.shape, o.dtype) for o in outs),
                          FORMAT_STATIC, in_spec.framerate)

    def invoke(self, inputs: List[Any]) -> List[Any]:
        with torch.inference_mode():
            out = self._module(*[torch.as_tensor(a).to(self._device) for a in inputs])
        return list(out) if isinstance(out, (list, tuple)) else [out]

    def invoke_batch(self, inputs: List[Any]) -> List[Any]:
        # TorchScript modules are batch-polymorphic on the leading dim
        return self.invoke(inputs)


register_backend(TorchScriptBackend)

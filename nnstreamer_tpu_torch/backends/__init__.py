"""Filter backends.  Importing registers them lazily, so importing the
package stays light: ``torch-cuda``, the importers ``tflite`` and ``onnx``
(model files lowered to torch), ``async-sim`` (the simulated
asynchronous device of the feed's tests) and the host fakes
``passthrough``, ``scaler``, ``average`` and ``framecounter``."""

from ..core import registry
from .base import FilterBackend, find_backend, parse_accelerator, register_backend  # noqa: F401

registry.register_lazy(
    registry.KIND_FILTER, "torch-cuda", "nnstreamer_tpu_torch.backends.torch_cuda:TorchCuda")
for _name, _cls in (("async-sim", "AsyncSim"), ("passthrough", "Passthrough"),
                    ("scaler", "Scaler"), ("average", "Average"),
                    ("framecounter", "FrameCounter")):
    registry.register_lazy(
        registry.KIND_FILTER, _name, f"nnstreamer_tpu_torch.backends.fakes:{_cls}")
registry.register_lazy(
    registry.KIND_FILTER, "tflite", "nnstreamer_tpu_torch.backends.tflite_import:TFLiteBackend")
registry.register_lazy(
    registry.KIND_FILTER, "onnx", "nnstreamer_tpu_torch.backends.onnx_import:OnnxBackend")

"""Filter backends.  Importing registers them lazily, so importing the
package stays light: ``torch-cuda``, the importers ``tflite`` and ``onnx``
(model files lowered to torch), ``torch`` (TorchScript archives),
``python3`` (a ``.py`` script), ``custom`` (a native ``.so`` over the C
ABI), ``custom-easy`` (an in-process callable, registered with
:func:`register_custom_easy`), ``async-sim`` (the simulated asynchronous
device of the feed's tests) and the host fakes ``passthrough``,
``scaler``, ``average`` and ``framecounter``."""

from ..core import registry
from .base import FilterBackend, find_backend, parse_accelerator, register_backend  # noqa: F401
from .custom_easy import CustomEasy, register_custom_easy, unregister_custom_easy  # noqa: F401

registry.register_lazy(
    registry.KIND_FILTER, "torch-cuda", "nnstreamer_tpu_torch.backends.torch_cuda:TorchCuda")
for _name, _cls in (("async-sim", "AsyncSim"), ("passthrough", "Passthrough"),
                    ("scaler", "Scaler"), ("average", "Average"),
                    ("framecounter", "FrameCounter")):
    registry.register_lazy(
        registry.KIND_FILTER, _name, f"nnstreamer_tpu_torch.backends.fakes:{_cls}")
for _name, _target in (("tflite", "tflite_import:TFLiteBackend"),
                       ("onnx", "onnx_import:OnnxBackend"),
                       ("torch", "torchscript:TorchScriptBackend"),
                       ("python3", "python3:Python3Backend"),
                       ("custom", "custom_native:CustomNative")):
    registry.register_lazy(registry.KIND_FILTER, _name, f"nnstreamer_tpu_torch.backends.{_target}")

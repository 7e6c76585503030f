"""Filter backends.  Importing registers them lazily, so importing the
package stays light: ``torch-cuda`` and ``async-sim`` (the simulated
asynchronous device of the feed's tests)."""

from ..core import registry
from .base import FilterBackend, find_backend, parse_accelerator, register_backend  # noqa: F401

registry.register_lazy(
    registry.KIND_FILTER, "torch-cuda", "nnstreamer_tpu_torch.backends.torch_cuda:TorchCuda")
registry.register_lazy(
    registry.KIND_FILTER, "async-sim", "nnstreamer_tpu_torch.backends.fakes:AsyncSim")

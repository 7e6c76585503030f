"""Filter backends.  Importing registers them; the torch-cuda backend
registers lazily so importing the package stays light."""

from ..core import registry
from .base import FilterBackend, find_backend, parse_accelerator, register_backend  # noqa: F401

registry.register_lazy(
    registry.KIND_FILTER, "torch-cuda", "nnstreamer_tpu_torch.backends.torch_cuda:TorchCuda")

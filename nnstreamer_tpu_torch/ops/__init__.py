"""Device ops: hand-written CUDA kernels (``csrc/``) with their plain PyTorch
versions, and batched NMS (plain PyTorch, as the reference is plain XLA).
Kernels build at first launch, never at import.  Importing the package
registers every kernel's ``nns_torch::`` operator (``_oplib.py``), which a
saved program needs before ``torch.export.load``."""

from . import flash_attention, quantize  # noqa: F401 -- the modules: their operators

from .labeling import top1, top1_packed, top1_packed_plain, top1_plain  # noqa: F401
from .nms import batched_nms  # noqa: F401
from .preprocess import normalize_u8, normalize_u8_plain  # noqa: F401

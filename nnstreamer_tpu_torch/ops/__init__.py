"""Device ops with hand-written CUDA kernels (``csrc/``) and their plain
PyTorch versions.  Kernels build at first launch, never at import."""

from .labeling import top1, top1_packed, top1_packed_plain, top1_plain  # noqa: F401
from .preprocess import normalize_u8, normalize_u8_plain  # noqa: F401
